"""Seeded traffic from a cell's traffic file.

Every seed gets the same multiset of sizes: prompt and output lengths are
the length distributions' quantiles at ``deck`` evenly spaced levels,
clipped to the file's bounds.  A pass over the deck takes them in
bit-reversed order of size, so any run of consecutive requests spreads
over the whole distribution (a window's mix is the deck's, not a lucky
draw); the seed picks where in that cycle each of prompts, outputs and
first budgets starts, and draws the token ids.  So two seeds ask the same
work of the system in another order, and a run's spread is the system's.

The loop is closed: each client sends its next request when its last one
finishes.  A client's first request takes an output budget drawn from the
residual of the output distribution (the part of a request still to come
at a random moment), so completions, and the admissions they free slots
for, spread over the window from its start.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import statistics
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Spec:
    """One request as the traffic asks for it."""
    index: int              # submission order
    client: int
    prompt: tuple           # token ids
    max_new: int


def quantiles(dist: dict, n: int) -> List[int]:
    """``n`` lengths at the levels (i + 1/2) / n of ``dist``, clipped."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    nd = statistics.NormalDist()
    out = []
    for i in range(n):
        x = dist["median"] * math.exp(dist["sigma"] * nd.inv_cdf((i + .5) / n))
        out.append(int(min(max(round(x), dist["min"]), dist["max"])))
    return out


def residual_quantiles(outputs: List[int], n: int) -> List[int]:
    """``n`` levels of the residual of the output lengths ``outputs``: a
    request picked with probability proportional to its length, cut at a
    uniform point (P(R <= r) = sum(min(r, o)) / sum(o))."""
    o = np.asarray(sorted(outputs), np.int64)
    r = np.arange(1, int(o.max()) + 1)
    cdf = np.minimum(r[:, None], o[None, :]).sum(1) / o.sum()
    return [int(r[np.searchsorted(cdf, (i + .5) / n)]) for i in range(n)]


def _rng(seed: int, *salt) -> np.random.Generator:
    digest = hashlib.sha256(repr((int(seed),) + salt).encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:16], "big"))


def spread_order(values: List[int]) -> List[int]:
    """``values`` sorted, then taken in bit-reversed index order: each run
    of consecutive entries samples the whole range."""
    v = sorted(values)
    bits = max(1, (len(v) - 1).bit_length())
    idx = sorted(range(len(v)),
                 key=lambda i: int(format(i, f"0{bits}b")[::-1], 2))
    return [v[i] for i in idx]


def _rotated(values: List[int], seed: int, salt: str) -> List[int]:
    k = int(_rng(seed, salt).integers(0, len(values)))
    return values[k:] + values[:k]


class Traffic:
    """The requests of one run: ``request(client)`` in submission order."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        if traffic.get("loop") != "closed":
            raise ValueError(f"unknown loop {traffic.get('loop')!r}: the "
                             "generator drives closed loops")
        self.t = traffic
        self.vocab = int(vocab)
        self.seed = int(seed)
        d = int(traffic["deck"])
        self.prompts = quantiles(traffic["prompt"], d)
        self.outputs = quantiles(traffic["output"], d)
        self._order = {
            "prompt": _rotated(spread_order(self.prompts), seed, "prompt"),
            "output": _rotated(spread_order(self.outputs), seed, "output")}
        self.first_budgets = _rotated(spread_order(residual_quantiles(
            self.outputs, int(traffic["clients"]))), seed, "first")
        self.sent = 0
        self._prepared: List[tuple] = []

    def prepare(self, n: int) -> None:
        """Draw the token ids of the first ``n`` requests now, in set-up,
        so that sending one of them draws nothing."""
        self._prepared = [self._tokens(i, self._length("prompt", i))
                          for i in range(n)]

    @property
    def drawn_late(self) -> int:
        """Requests sent beyond the prepared ones (drawn as sent)."""
        return max(0, self.sent - len(self._prepared))

    def _length(self, which: str, i: int) -> int:
        order = self._order[which]
        return order[i % len(order)]

    def _tokens(self, i: int, n: int) -> tuple:
        return tuple(int(x) for x in
                     _rng(self.seed, "tokens", i).integers(0, self.vocab, n))

    def request(self, client: int) -> Spec:
        """The next request, sent by ``client``; a client's first request
        takes its residual budget."""
        i = self.sent
        self.sent += 1
        first = i < len(self.first_budgets)
        max_new = (self.first_budgets[i] if first
                   else self._length("output", i))
        prompt = (self._prepared[i] if i < len(self._prepared)
                  else self._tokens(i, self._length("prompt", i)))
        return Spec(index=i, client=client, prompt=prompt,
                    max_new=int(max_new))

    def warm_prompts(self, length: int, n: int) -> List[List[int]]:
        """``n`` prompts of ``length`` tokens for warm-up, apart from the
        traffic's own."""
        return [list(_rng(self.seed, "warm", length, i).integers(
            0, self.vocab, length)) for i in range(n)]

    def buckets(self) -> List[int]:
        """The power-of-two prompt buckets this traffic can fill."""
        return sorted({bucket(n) for n in self.prompts})


def bucket(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= ``n``, at least ``minimum``: the padded
    length of an admission prefill whose longest prompt is ``n``."""
    b = minimum
    while b < n:
        b *= 2
    return b
