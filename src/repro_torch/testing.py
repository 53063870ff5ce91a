"""Property-testing compatibility layer: real ``hypothesis`` when installed,
otherwise a deterministic miniature fallback.

The port's own copy of the reference's ``testing.py`` (the port imports
nothing of the reference package).  Property tests only need
``@given``/``@settings`` plus the ``integers``, ``sampled_from``,
``floats`` and ``booleans`` strategies.  Environments built from ``pip
install -e .[dev]`` get the real library (declared in pyproject.toml);
hermetic ones without it still collect and run every test: each ``@given``
test executes ``max_examples`` deterministic pseudo-random draws from a
seed derived from the test's module and qualname, so failures reproduce
exactly, and the same test draws the same values as under the reference's
fallback.
"""
from __future__ import annotations

try:  # pragma: no cover - exercised only where hypothesis is installed
    from hypothesis import given, settings  # noqa: F401
    from hypothesis import strategies  # noqa: F401
    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    import functools
    import inspect
    import random
    import zlib

    HAVE_HYPOTHESIS = False

    class _Strategy:
        """A sampleable value source (subset of hypothesis' SearchStrategy)."""

        def __init__(self, draw):
            self._draw = draw

        def example_from(self, rng: random.Random):
            return self._draw(rng)

    class _Strategies:
        @staticmethod
        def integers(min_value=0, max_value=2**31 - 1):
            return _Strategy(lambda rng: rng.randint(min_value, max_value))

        @staticmethod
        def sampled_from(elements):
            elems = list(elements)
            return _Strategy(lambda rng: elems[rng.randrange(len(elems))])

        @staticmethod
        def floats(min_value=0.0, max_value=1.0, **_kw):
            return _Strategy(lambda rng: rng.uniform(min_value, max_value))

        @staticmethod
        def booleans():
            return _Strategy(lambda rng: bool(rng.getrandbits(1)))

    strategies = _Strategies()

    def settings(max_examples: int = 10, **_ignored):
        """Record ``max_examples`` on the (already @given-wrapped) test."""

        def deco(fn):
            fn._max_examples = max_examples
            return fn

        return deco

    def given(**strats):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_max_examples", 10)
                seed = zlib.crc32(f"{fn.__module__}.{fn.__qualname__}".encode())
                rng = random.Random(seed)
                for _ in range(n):
                    draw = {k: s.example_from(rng) for k, s in strats.items()}
                    fn(*args, **kwargs, **draw)

            # hide the strategy parameters from pytest's fixture resolution
            # (real hypothesis does the same): present a zero-arg signature.
            del wrapper.__wrapped__
            wrapper.__signature__ = inspect.Signature()
            return wrapper

        return deco
