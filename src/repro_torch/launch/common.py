"""Shared CLI surface of the launchers, as the reference's.

* :func:`add_common_args` — the flags every launcher takes, with identical
  names and help everywhere: ``--hardware``, ``--mesh``, ``--stats``,
  ``--tuned-dir``, ``--trace-dir`` and the port's ``--device``;
* :func:`add_serving_args` — the serving-engine group (scheduler,
  paged-KV sizing, prefix cache);
* :func:`deprecated_flag` / :func:`forward_deprecated` — a retired flag
  that still parses: using it warns once and forwards its value onto the
  replacement, so old command lines keep working one release while
  printing their migration.

Launchers call these, then add their own flags on top.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import warnings


def add_common_args(ap: argparse.ArgumentParser) -> None:
    """The flags every launcher shares, declared once."""
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--hardware", default=None,
                    help="hardware profile the tuned schedules are looked "
                         "up for (default: $REPRO_TORCH_HARDWARE, else "
                         "detected from the device)")
    ap.add_argument("--mesh", default=None,
                    help="device mesh spec: 'data=N,model=M' or 'auto' over "
                         "the job's ranks (torchrun --standalone "
                         "--nproc_per_node N; default: single-device)")
    ap.add_argument("--stats", action="store_true",
                    help="print engine / trainer counters and kernel launch "
                         "counts")
    ap.add_argument("--tuned-dir", default=None,
                    help="directory of tuning DBs to load (default: "
                         "$REPRO_TORCH_TUNED_DIR, else the package's tuned/)")
    ap.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace of the run into "
                         "this dir (post-process: scripts/torch_profile.py)")


def add_serving_args(ap: argparse.ArgumentParser) -> None:
    """The serving-engine knob group (ServeConfig surface)."""
    grp = ap.add_argument_group(
        "serving", "continuous-batching engine configuration")
    grp.add_argument("--scheduler", choices=["continuous", "wave"],
                     default="continuous",
                     help="continuous = paged KV + admit/evict at chunk "
                          "boundaries (default); wave = slot-per-request")
    grp.add_argument("--page-size", type=int, default=None,
                     help="paged-KV page size in tokens (default 16)")
    grp.add_argument("--capacity-tokens", type=int, default=None,
                     help="paged-pool capacity in tokens (default: "
                          "max_batch * max_len)")
    grp.add_argument("--decode-chunk", type=int, default=8,
                     help="tokens per decode chunk between scheduling "
                          "boundaries (power of two)")
    grp.add_argument("--no-prefix-cache", action="store_true",
                     help="disable shared-prefix KV reuse (continuous "
                          "scheduler only; on by default)")


@contextlib.contextmanager
def rank_zero_stdout():
    """Silence this process's stdout unless it is rank 0 of the job
    (torchrun's ``RANK``): one rank prints a launcher's lines."""
    from repro_torch.launch.mesh import rank
    if rank() == 0:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def end_process_group() -> None:
    """Tear down the process group a ``--mesh`` run started, if any."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


class _DeprecatedAction(argparse.Action):
    """Store the value, remember it was used, and warn at parse time."""

    def __call__(self, parser, namespace, values, option_string=None):
        warnings.warn(
            f"{option_string} is deprecated; use {self.const} instead "
            f"(value forwarded)", DeprecationWarning, stacklevel=2)
        print(f"[deprecated] {option_string} -> {self.const}")
        setattr(namespace, self.dest, values)
        used = getattr(namespace, "_deprecated_used", set())
        used.add(self.dest)
        setattr(namespace, "_deprecated_used", used)


def deprecated_flag(ap: argparse.ArgumentParser, old: str, new: str,
                    **kwargs) -> None:
    """Register retired flag ``old`` as a warn-and-forward alias.

    The parsed value lands on ``old``'s own dest; :func:`forward_deprecated`
    moves it onto ``new``'s dest afterwards (only when the modern flag was
    not given: the modern flag wins).
    """
    kwargs.setdefault("default", None)
    kwargs.setdefault("help", argparse.SUPPRESS)
    ap.add_argument(old, action=_DeprecatedAction, const=new, **kwargs)


def forward_deprecated(args: argparse.Namespace, mapping) -> None:
    """Resolve warn-and-forward aliases after parsing.

    ``mapping`` is ``{old_dest: (new_dest, convert)}``; each used alias
    whose modern dest is still at its default (None/falsy) gets the
    converted legacy value.
    """
    used = getattr(args, "_deprecated_used", set())
    for old_dest, (new_dest, convert) in mapping.items():
        if old_dest not in used:
            continue
        if getattr(args, new_dest, None):
            continue                      # the modern flag wins
        setattr(args, new_dest, convert(getattr(args, old_dest)))
