"""IR004: static enumeration of the step shapes a serve config implies.

The port runs eagerly and its decode loop in Python: nothing compiles per
shape, and there is no ``unroll``.  A *key* here is the shapes one engine
step is called with: ``(plen,)`` for a prefill or an admission,
``(width,)`` for a wave's decode loop, ``(width, chunk)`` for a decode
chunk.  Each is one step shape, i.e. one CUDA graph to capture once the
decode step is captured, and the count of keys bounds how many graphs a
serve config can need.

This module replays the engine's bucketing policy
(``serve.engine._bucket_len`` and the width/plen choice in
``Engine._run_wave``, ``Engine._admit_batch`` and ``Engine._run_chunk``)
over the **entire feasible input domain** of a ``ServeConfig``.  The
counts equal the reference's jit-key counts case for case (the
reference's unroll is fixed per case, so it never changes a count); they
are pinned in ``src/repro_torch/analysis/ir_fingerprints.json``, and a
bucketing change shifts a count and fails IR004 with a diff naming the
entry point.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.analysis.ir.matrix import SERVE_KW, IRCase
from repro_torch.serve.engine import ServeConfig, _bucket_len


def wave_keys(max_len: int) -> Dict[str, List[Tuple]]:
    """Distinct step shapes of the wave engine's entry points.

    Feasible domain: ``1 <= longest``, ``1 <= need``,
    ``longest + need <= max_len`` (the ``_run_wave`` guard).  Batch rows
    are always padded to ``max_batch``, so only (plen, width) vary.
    """
    prefill: set = set()
    loop: set = set()
    for need in range(1, max_len):
        width = _bucket_len(need)
        loop.add((width,))
        for longest in range(1, max_len - need + 1):
            plen = _bucket_len(longest, max_len - width)
            if plen < longest:
                plen = _bucket_len(longest, max_len - need)
            if plen < longest:
                plen = longest
            prefill.add((plen,))
    return {"prefill": sorted(prefill), "decode_loop": sorted(loop)}


def continuous_keys(max_len: int, max_batch: int, chunk: int
                    ) -> Dict[str, List[Tuple]]:
    """Distinct step shapes of the continuous engine's entry points.

    Admission buckets the longest admitted prompt uncapped; a row's length
    (prompt + generated so far) is bounded by the pool capacity
    (``max_batch * max_len`` tokens, the engine's default), and the chunk
    width buckets ``length + chunk``.
    """
    capacity = max_batch * max_len
    admit = {(_bucket_len(p),) for p in range(1, capacity)}
    widths = {(_bucket_len(length + chunk), chunk)
              for length in range(1, capacity + 1)}
    return {"admit": sorted(admit), "decode_chunk": sorted(widths)}


def enumerate_jit_keys(case: IRCase) -> Dict[str, int]:
    """-> ``{entry: distinct-key count, "total": sum}`` for one case (the
    reference's name and schema: ``jit_keys`` in the fingerprint file), at
    the matrix's ``SERVE_KW`` serve shape and the engine's default decode
    chunk."""
    if case.scheduler == "wave":
        keys = wave_keys(SERVE_KW["max_len"])
        # train_step runs for exactly one (state, batch) spec per case
        keys["train_step"] = [("ir_train",)]
    else:
        keys = continuous_keys(SERVE_KW["max_len"], SERVE_KW["max_batch"],
                               ServeConfig.decode_chunk)
    counts = {entry: len(ks) for entry, ks in keys.items()}
    counts["total"] = sum(counts.values())
    return counts
