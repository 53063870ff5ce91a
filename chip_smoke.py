#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line:

1. ``device``  — the card, its power limit, torch and CUDA versions.
2. ``build``   — build the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and time it.
3. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card, under the schedule the tuning registry resolves for the case (the
   committed ``h100`` table's entry, else the hand table; each row names
   the tier, ``source``), at the shapes the serving path of llama3.2-1b
   gives it and at the edges of each GEMM path (decode M = 1..16, split-K with C and bias, the
   K-major unembed, ragged prefill M, operands only WMMA takes), launch each
   GEMM twice and require the same bits, require decode rows computed at
   M = 8 to equal the same rows at M = 1 bit for bit, and time the kernel,
   the plain version, one PyTorch library call computing the same function
   (a yardstick only; the port never calls it) and the bound (max of bytes
   / the h100 profile's 3.35 TB/s and FLOPs / its peak for the input
   type, ``core.hardware``); the kernel and
   the library call are timed again by a device-only timer (``Timer``).
   Flash attention runs at the serving prefill shape, its ragged, short
   and f32 edges, and two long prompts (4096 tokens causal, 4 x 1024
   ragged) that are not on the serve path; each flash launch runs twice
   and must give the same bits.  Each row names the path (kernel) it took
   and its share of bound.  The olmoe-1b-7b serve path's shapes run too
   (MHA q/k/v/o 2048 x 2048, the router at N = 64, the untied unembed at
   N = 50304, at M = 8 and 8 x 256; flash at (8, 256, 16, 16, 128)), and
   llama-3.2-vision-11b's (d = 4096: q/o, k/v, MLP 14336 at M = 8 and
   8 x 256, the unembed at N = 128256, the cross K/V projection at M =
   8 x 1601; flash at (8, 256, 32, 8, 128)).
4. ``tuning``  — load ``src/repro_torch/tuned/h100.json`` strictly; hold
   every entry's schedule, at the entry's own shape, against the plain
   version (and require the wrapper to launch that kernel); hold each
   ``dispatch_*`` schedule the hand tables do not use at a ragged shape;
   run one measured sweep (llama's decode gate/up, exhaustive, 3 repeats)
   whose winner must land as an ``exact`` entry that the next
   ``core.matmul`` launches (equal bits to a direct launch of it), and
   print its device time beside the hand table's; then reload the
   committed table.
5. ``serve``   — full-width llama3.2-1b in bf16 with seeded random weights,
   flash prefill: 12 requests through ``Engine`` over 8 slots; the kernels'
   launch counts by path are set to 0 just before and read just after:
   every product must go through the decode or the wgmma GEMM kernel, and
   every prefill attention through the wgmma flash kernel; the engine's
   ``stats()`` must name the ``h100`` profile (platform ``gpu``), resolve
   every decode GEMM shape ``exact`` from the committed table and every
   prefill flash bucket ``exact`` or ``nearest``.  Then the
   batched ragged prefill against per-prompt prefill, and a float32 pass
   (full width, 2 layers, flash through the fma kernel) whose engine
   tokens must equal the per-prompt oracle's exactly.  The prefix cache is
   on (the default); these prompts share no prefix and hit nothing.  One
   more warm serve of the 12 requests (the prefix cache cleared) runs
   under ``repro_torch.profiling.trace``: its PROFILE blob must pass
   ``validate_profile`` on the device timeline, with one
   ``serve.decode_chunk`` marker and one device-to-host copy a chunk, one
   ``serve.prefill_admit`` an admission prefill, K1's kernels in the
   ``gemm`` family and K2's in ``attention``.
6. ``serve_features`` — the same model and weights through the paths the
   serving slice after the first added, each pass with the launch counts
   set to 0 just before and read just after, each requiring every GEMM on
   the decode or wgmma kernel and every prefill attention on the wgmma
   flash kernel: (a) the wave scheduler on the serve phase's 12 requests
   (one host transfer per wave); (b) the prefix cache, cold then warm, on
   8 prompts sharing a 256-token prefix plus 4 exact repeats (>= 4 full and
   >= 7 partial warm hits, each full hit's first token equal to its cold
   one, no page left after ``clear_prefix_cache``); (c) sampling at
   temperature 0.8 (two fresh engines, equal tokens); (d) the int8 KV cache
   (forced onto the wave scheduler); (e) the threaded ``Server`` with
   stream callbacks, 4 requests more submitted while it drains; (f) float32
   exactness of the wave, prefix-cache (cold and warm) and int8 engines
   against the per-prompt oracle (2 layers).
7. ``ir`` — the IR checker (``repro_torch.analysis.ir``) on the card's
   machine, at most 60 s: (a) ``python -m repro_torch.analysis ir
   --smoke --no-cache`` in a fresh process (its torch, no JAX): exit 0,
   0 errors, a warning only IR005's (the committed fingerprints gate
   hashes on the torch version they were blessed under); (b) the serve
   phase's model at full width and depth on an engine like its (8 slots,
   max_len 1024, chunk 8): one admission of 8 of its prompts and one
   decode chunk, each run once under the tracer on the card with the
   launch counts set to 0 just before and read just after: IR000-IR003
   find nothing against the ``h100`` profile, K1's units in the chunk
   equal its launches there (all decode), K2's in the admission its
   launches (all wgmma); each entry's traced peak beside
   ``torch.cuda.max_memory_allocated``, and the chunk's op histogram as a
   structural diff against the committed CPU case's (a record, not a
   gate).
8. ``serve_moe`` — the llama weights freed first; full-width olmoe-1b-7b
   (16 layers, 64 experts, top-8, MHA at head dim 128) in bf16 with seeded
   random weights, flash prefill: the serve phase's 12 requests
   continuous, then wave, then the prefix-cache traffic of b cold and warm,
   each run twice on fresh engines with the launch counts set to 0 before
   each run (every GEMM on decode or wgmma, every prefill attention on the
   wgmma flash kernel, one host transfer per chunk or wave, equal tokens
   on repeat); finite logits of one batched prefill; the real-token slots
   the first MoE layer drops in it at capacity factor 1.25 (from the
   port's routing); the expert einsums' device time at the decode and
   prefill slots; and a float32 pass (full width, 2 layers, capacity factor
   8.0, where no slot can drop) whose continuous and wave tokens must equal
   the per-prompt oracle's.
9. ``serve_vlm`` — the olmoe weights freed first; full-width
   llama-3.2-vision-11b (8 units of 4 self layers and one cross-attention
   layer over 1601 image tokens) in bf16 with seeded random weights and
   seeded random image embeddings (one per request, ``extra_inputs``):
   the same three traffics and checks as serve_moe (the prefix cache is
   not consulted with extra inputs: no hit), finite logits of one batched
   prefill, and a float32 pass at full width and one unit (5 layers)
   whose tokens must equal the per-prompt oracle's.
10. ``serve_stablelm`` — stablelm-12b at full width (d 5120, 32 / 8 heads
   at head dim 160, vocab 100352) and 2 layers in bf16 with flash prefill:
   the serve phase's 12 requests, 8 new tokens each, with the launch counts
   set to 0 before (every GEMM on decode or wgmma, every prefill attention
   on the wgmma flash kernel at d 160); then a float32 pass (2 layers)
   whose continuous and wave tokens must equal the per-prompt oracle's.
11. ``serve_audio`` — full-width whisper-large-v3 (32 encoder + 32 decoder
   layers, d 1280, 20 heads at head dim 64, untied K-major head over 51866
   tokens) in bf16 with seeded random frame embeddings (1500 a request,
   ``extra_inputs``): the same three traffics and checks as serve_moe (the
   prefix cache is not consulted with extra inputs), finite logits of one
   batched prefill, the encoder's share of a prefill's device time, and a
   float32 pass at full width and 2 + 2 layers whose tokens must equal the
   per-prompt oracle's.
12. ``serve_ssm`` — full-width mamba2-130m (24 attention-free Mamba2
   layers, d 768, state 128, tied head over 50280 tokens) in bf16: the 12
   requests and the prefix traffic, each twice on fresh engines, on the
   wave scheduler the engine is forced onto (asserted; the prefix cache is
   off there: no hit), every GEMM on decode or wgmma, one host transfer a
   wave, equal tokens on repeat; finite logits of one batched prefill; a
   float32 pass at full width and 2 layers whose tokens must equal the
   per-prompt oracle's.
13. ``serve_hybrid`` — full-width zamba2-2.7b (9 units of 6 Mamba2 layers
   and one shared attention block at head dim 80, d 2560, untied head over
   32000 tokens) in bf16 with flash prefill: the same three traffics and
   checks as serve_moe (>= 4 full and >= 7 partial warm hits, whose
   restores include the SSM and conv states), finite logits of one batched
   prefill, and a float32 pass at full width and one unit (6 Mamba2 layers
   and the shared block) whose continuous and wave tokens must equal the
   per-prompt oracle's.

14. ``examples`` — every serving weight freed first; the port's three
   examples and its prefix smoke, each imported and driven through its
   step functions, each part's seconds and peak memory in the line and
   its launch counts its own (apart from the main paths' totals):
   ``examples/torch_quickstart.py`` at full width and depth (a measured
   4096^3 bf16 sweep whose winner the registry then resolves ``exact``,
   its TFLOP/s beside the card's name and power limit; 30 finite train
   losses with K1 on wgmma 28 a layer + 1 a step, simt 2 a step, no
   decode, wmma, fma or flash launch; a serve on the decode kernel only),
   ``examples/torch_autotune_and_serve.py`` at full width (two targets
   persisted and reloaded, every captured GEMM shape and the prefill
   flash problem measured into the registry, a serve whose every decode
   GEMM and prefill flash lookup is ``exact``, the committed ``h100.json``
   unchanged byte for byte), ``examples/torch_train_with_failure_
   recovery.py`` at full width and 2 layers (a ~5 GB checkpoint under
   ``build/``, removed after; parameters bit-equal after the replay) and
   ``scripts/torch_prefix_cache_smoke.py --full`` (every assertion); then
   ``python -m repro_torch.analysis report`` in a fresh process: exit 0,
   JAX never imported.  The registry is reset to the committed table
   after.
15. ``train`` — every serving weight freed first; full-width llama3.2-1b
   in bf16 (seeded weights, chunked attention as the reference trains,
   remat) on the synthetic pipeline, batch 8 x 512, warmup_cosine(1e-3,
   10, 6): 6 steps through ``Trainer`` with a checkpoint at step 3
   (``build/train_checkpoint/``, removed after), then steps 4-6 again
   from the checkpoint in a fresh state, whose losses and parameters must
   equal the first run's bit for bit (``torch.use_deterministic_
   algorithms`` on: index_select's backward adds with atomics).  Launch
   counts from 0 over the 6 steps: every bf16 product, forward, remat
   recompute, dX and dW, on wgmma (28 a layer + 1 a step), simt exactly
   at the unembed's two f32-cotangent products a step, no decode, wmma,
   fma or flash launch.  Finite losses and every gradient leaf finite in
   every step; step walls, tokens/s, peak memory;
   one bf16 step against the plain versions (``gemm_ref`` under
   PyTorch's autograd: loss and grad norm within ``TRAIN_BF16_TOL``) and
   with the unembed's f32 backward on the ``fma`` kernel (``on_fma``: loss
   and grad norm bit-equal to the simt step's); one
   f32 step at full width and 2 layers against them (loss, metrics, every
   gradient leaf, every parameter after the step within
   ``TRAIN_F32_TOL``); one timed step (CUDA events): K1's device time by
   role (forward, remat recompute, dX, dW, the unembed's two f32 backward
   products; the f32 casts and x.T copies beside them), the step's GEMM
   shapes and each one's registry provenance.  The 6 steps run again
   from the same seed and data under ``remat_policy="dots"`` (K1's
   forward outputs saved, everything else recomputed): losses equal to
   the first run's bit for bit, wgmma at 21 a layer + 1 a step (no remat
   recompute), simt at 2 a step, none of K1's launches in a ``k1_split``
   step a ``forward_recompute``; its walls and peak memory beside the
   first run's.  Then one more warm step under
   ``repro_torch.profiling.trace``, emitted as a ``train_profile`` line
   (device time by family, by launching op and by kernel, K1's share):
   the blob must pass ``validate_profile``, with one ``train.step``
   marker and K1's kernels in the ``gemm`` family.
16-19. ``train_audio``, ``train_ssm``, ``train_hybrid``, ``train_vlm`` —
   the same for the other families (``TRAIN_PHASES``), with seeded extra
   inputs beside the tokens: whisper-large-v3 at full width and depth
   (8 x 512 decoder tokens, 8 x 1500 frames; 4 steps, a checkpoint at
   step 2 whose restore must keep the K-major head K-major, steps 3-4
   again bit for bit), mamba2-130m at full width and depth (8 x 512, 4
   steps), zamba2-2.7b at full width and 2 of 9 units (8 x 512, 3 steps)
   and llama-3.2-vision-11b at full width and 1 of 8 units (4 x 512
   tokens, 4 x 1601 image embeddings, 3 steps); their f32 steps at 2 + 2
   layers, 2 layers, 1 unit, and 1 self + the cross layer; each with its
   traced step and ``train_profile`` line (no ``"dots"`` run).
20. ``mesh`` — the distribution layer on a one-rank mesh
   (``build_mesh("data=1,model=1")``: NCCL, a world of one): the serve
   phase's model, weights and 12 requests through an engine with no mesh
   and one on the mesh (inference TP rules), cold then warm (plain, mesh,
   mesh, plain): equal tokens, equal K1 and K2 launches by path, one
   device-to-host copy a chunk (a traced warm pass), the ``mesh`` and
   ``sharding`` stats; then the train phase's llama3.2-1b steps 1-3 under
   the FSDP rules on the mesh, the state made on the mesh leaf by leaf:
   losses against the train phase's, K1's launches by path, and the
   params saved from the mesh and restored with no mesh, bit for bit.
   The walls of both runs are in its line; the process group is
   destroyed at its end.
21. ``roofline`` — the dry run (``launch.dryrun``: the step traced once
   on fake tensors, one device) and its roofline on the ``h100`` profile
   (``launch.roofline``) for every step an earlier phase traced: the
   serve phase's prefills and decode steps, at the batch and length each
   call of its traced serve had (the calls' terms summed), and each train
   phase's step at its depth and batch.  One line each: the compute,
   memory and collective terms and the dominant one, the flops by dtype,
   the measured spans of the trace (``serve.prefill_admit``,
   ``serve.decode_chunk``, ``train.step``: wall, and device busy from the
   kernels launched inside them), the share ``est_step_s / measured`` of
   each, the MFU proxy, and the dry run's peak-memory estimate beside the
   phase's measured ``peak_mem_gb``.

The kernels phase also holds whisper's shapes (d 1280 projections with
biases and the GELU MLP at M = 8, 8 x 256 and the encoder's 8 x 1500, the
unembed at N = 51866), mamba2-130m's (in_proj 768 x 3352, out_proj, the
tied unembed at N = 50280) and zamba2-2.7b's (in_proj 2560 x 10448,
out_proj, the shared block's projections and MLP, the unembed at N =
32000), and K2 at (8, 256, 20, 20, 64), stablelm-12b's (8, 256, 32, 8,
160) and zamba2-2.7b's head dim 80, (8, 256, 32, 32, 80); and the train
phase's products at M = 4096: each projection's forward (the gate's
without SiLU, f32 out), dX (B K-major) and dW (K = 4096), the tied
unembed's forward and its two f32 backward products (simt, f32 out, each
held bit for bit against an ``fma`` launch and timed beside it; a
``train_unembed_f32`` line sums each train phase's two); and the same for
the other train phases (whisper at 8 x 1500 encoder and 8 x 512
decoder rows, mamba2, zamba2, the vlm at 4 x 512 and its cross K/V at 4
x 1601 image tokens), with each unembed at N 51866 / 50280 / 32000 /
128256.

Then it prints the card's name and power limit, one ``{"kernels": [...]}``
line, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
check raises and exits non-zero without that line; so does a machine with
no CUDA device, or a directory without the repository's ``src/``.

``--out DIR`` also writes the compiler's register/spill report and the
per-case kernel table there.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: (name, CUDA source, TPU kernel as file:line, TPU kernel as file::function)
KERNELS = (
    ("gemm", "src/repro_torch/kernels/csrc/gemm.cu",
     "src/repro/kernels/gemm.py:37", "src/repro/kernels/gemm.py::_gemm_kernel"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:52",
     "src/repro/kernels/flash_attention.py::_flash_kernel"),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

#: the port's kernels by their device names: K1's four paths, K2's two
K1_NAMES = ("gemm_wgmma_kernel", "gemm_decode_kernel", "gemm_bf16_kernel",
            "gemm_simt_kernel", "gemm_f32_kernel")
K2_NAMES = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")


def traced(label: str, run):
    """``run()`` under ``repro_torch.profiling.trace`` into
    ``build/traces/<label>``: (its result, the capture's Chrome-trace
    events, the seconds the traced run took and those its capture took to
    stop, write and read back).  The capture is removed once read."""
    import shutil

    from repro_torch.profiling import trace
    out_dir = os.path.join(HERE, "build", "traces", label)
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        with trace(out_dir) as session:
            result = run()
            t1 = time.perf_counter()
        events = session.events()
        return result, events, {"traced_run_s": t1 - t0,
                                "capture_read_s": time.perf_counter() - t1}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def profile_summary(kind: str, events, top: int = 12):
    """(PROFILE blob, summary) of a capture on the card: the blob must pass
    ``validate_profile`` on the device timeline; the summary has its
    families, annotations and host syncs, device time by launching op
    (top ``top``), the top kernels, and K1's and K2's device time, share
    and the families their kernels fall in."""
    from repro_torch.profiling import (build_profile, classify_event_name,
                                       validate_profile)
    from repro_torch.profiling.breakdown import DEVICE_CATEGORIES, base_op
    blob = validate_profile(build_profile(kind, events=events,
                                          hardware="h100"))
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATEGORIES]
    total_us = sum(float(e["dur"]) for e in device)
    out = {"timeline": blob["timeline"], "device_events": len(device),
           "device_ms": total_us / 1e3,
           "wall_ms": blob["totals"]["wall_us"] / 1e3,
           "families": {f: {"ms": v["us"] / 1e3, "count": v["count"],
                            "fraction": v["fraction"]}
                        for f, v in blob["families"].items()},
           "annotations": blob["annotations"],
           "host_syncs": blob["host_syncs"],
           "device_ms_by_launching_op": {
               k: v / 1e3 for k, v in list(
                   blob["device_us_by_launching_op"].items())[:top]},
           "top_kernels": [{"name": o["name"], "ms": o["us"] / 1e3,
                            "count": o["count"]}
                           for o in blob["top_ops"][:top]]}
    for key, names in (("k1", K1_NAMES), ("k2", K2_NAMES)):
        mine = [e for e in device if base_op(e["name"]) in names]
        us = sum(float(e["dur"]) for e in mine)
        out[key] = {"device_ms": us / 1e3, "launches": len(mine),
                    "share": us / total_us if total_us else 0.0,
                    "families": sorted({classify_event_name(e["name"])
                                        for e in mine})}
    return blob, out


def span_times(events, name: str):
    """(spans, wall ms, device-busy ms) of the ``annotate(name)`` spans of
    a capture on the card.  Busy is the device time of the kernels, copies
    and sets launched inside the spans (each joined to its CUDA runtime or
    driver call through the correlation id); a span's wall runs from its
    start to the end of its host window or of the last device event it
    launched, whichever is later (the host may finish issuing a step
    before the device finishes running it)."""
    import bisect

    from repro_torch.profiling.breakdown import DEVICE_CATEGORIES
    spans = sorted([float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))]
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name") == name)
    launched = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
    starts = [a for a, _ in spans]
    ends = [b for _, b in spans]
    busy = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts = launched.get((e.get("args") or {}).get("correlation"))
        i = -1 if ts is None else bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= spans[i][1]:
            dur = float(e.get("dur", 0.0))
            busy += dur
            ends[i] = max(ends[i], float(e["ts"]) + dur)
    wall = sum(b - a for a, b in zip(starts, ends))
    return len(spans), wall / 1e3, busy / 1e3


#: the traced steps the ``roofline`` phase bounds: each a dict of its
#: ``label``, config, step ``kind``, ``calls`` ({(batch, length): count}
#: of the step the traced run made), its measured ``span_times`` and the
#: phase's measured peak memory (GB)
MEASURED_STEPS: list = []


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Mean time of ``fn`` in ms over ``reps`` launches, each timed alone
    with CUDA events after a flush of the 50 MB L2, as a serving step finds
    the weights cold.

    The default (``kernel_ms``, ``plain_ms``, ``library_ms``) flushes with a
    write of 128 MiB and enqueues ``fn`` right after: L2 is left full of
    dirty lines, whose write-back competes with the launch's reads, and the
    events include whatever host time the device waits for.
    ``device_only=True`` (``kernel_device_ms``, ``library_device_ms``)
    flushes with a read of 128 MiB (clean lines, as the previous layers'
    weight reads leave L2) and spins the device ~1 ms
    (``torch.cuda._sleep``) before the start event, long enough for the
    host to enqueue ``fn``: the events then bracket the device's work only.
    """

    SLEEP_CYCLES = 2_000_000

    def __init__(self, torch, device_only: bool = False):
        self.torch = torch
        self.device_only = device_only
        self.flush = torch.zeros(32 * 1024 * 1024, dtype=torch.float32,
                                 device="cuda")
        self.sink = torch.zeros((), dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            if self.device_only:
                torch.sum(self.flush, dim=0, out=self.sink)
                torch.cuda._sleep(self.SLEEP_CYCLES)
            else:
                self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def bound(flops: float, nbytes: float, dtype: str):
    """(ms, what bounds it): the larger of the operations over the h100
    profile's peak for ``dtype`` and the bytes over its memory rate."""
    from repro_torch.core.hardware import H100
    t_ops = flops / H100.peak_for(dtype)
    t_bytes = nbytes / H100.hbm_bandwidth
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def gemm_cases(torch):
    """(label, M, K, N, dtype, b_transposed, activation, out_dtype, extras,
    main_path).  ``extras``: True adds C, a bias, alpha and beta; "bias" a
    bias alone.  The main path's shapes first, each once; then the edges of
    the decode and wgmma paths and the WMMA / FMA kernels."""
    d, kvd, ff, vocab = 2048, 512, 8192, 128256
    bf, f32 = torch.bfloat16, torch.float32
    proj = [("q", d, d, None), ("k", d, kvd, None), ("v", d, kvd, None),
            ("o", d, d, None), ("gate+silu", d, ff, "silu"),
            ("up", d, ff, None), ("down", ff, d, None)]
    cases = []
    for m, phase in ((8, "decode"), (8 * 256, "prefill")):
        for name, k, n, act in proj:
            cases.append((f"{phase} {name}", m, k, n, bf, False, act, bf,
                          False, True))
    cases.append(("unembed (tied, B=emb.T, f32 out)", 8, d, vocab, bf, True,
                  None, f32, False, True))
    # olmoe-1b-7b (serve_moe): MHA projections, the router (N = E = 64, bf16
    # out) and the untied unembed (N = 50304; serving unembeds M = 8 rows,
    # M = 8 x 256 is a scoring forward's)
    for m, phase in ((8, "decode"), (8 * 256, "prefill")):
        for name, n in (("q/k/v/o", d), ("router", 64)):
            cases.append((f"olmoe {phase} {name}", m, d, n, bf, False, None,
                          bf, False, True))
        cases.append((f"olmoe {phase} unembed (f32 out)", m, d, 50304, bf,
                      False, None, f32, False, m == 8))
    # llama-3.2-vision-11b (serve_vlm): d = 4096, GQA 32 / 8 at d = 128, MLP
    # 14336, the untied unembed (N = 128256) and the cross K / V projection
    # of 8 rows of 1601 image tokens
    dv, kvv, ffv = 4096, 1024, 14336
    vproj = [("q/o", dv, dv, None), ("k/v", dv, kvv, None),
             ("gate+silu", dv, ffv, "silu"), ("up", dv, ffv, None),
             ("down", ffv, dv, None)]
    for m, phase in ((8, "decode"), (8 * 256, "prefill")):
        for name, k, n, act in vproj:
            cases.append((f"vlm {phase} {name}", m, k, n, bf, False, act, bf,
                          False, True))
    cases.append(("vlm unembed (f32 out)", 8, dv, 128256, bf, False, None,
                  f32, False, True))
    cases.append(("vlm prefill cross k/v (8 x 1601 image tokens)", 8 * 1601,
                  dv, kvv, bf, False, None, bf, False, True))
    # whisper-large-v3 (serve_audio): d = 1280 MHA projections with biases,
    # the GELU MLP (5120) with biases at decode, decoder prefill and the
    # encoder's 8 x 1500 frames (its q / k / v / o shape is also the cross
    # K / V projection's); the untied unembed, K-major, at N = 51866
    dw, ffw = 1280, 5120
    wproj = [("q/k/v/o +bias", dw, dw, None), ("up +bias+gelu", dw, ffw, "gelu"),
             ("down +bias", ffw, dw, None)]
    for m, phase in ((8, "decode"), (8 * 256, "prefill"),
                     (8 * 1500, "encoder")):
        for name, k, n, act in wproj:
            cases.append((f"whisper {phase} {name}", m, k, n, bf, False, act,
                          bf, "bias", True))
    cases.append(("whisper unembed (K-major, N = 51866, f32 out)", 8, dw,
                  51866, bf, True, None, f32, False, True))
    cases.append(("whisper edge unembed at prefill M (K-major, N = 51866)",
                  8 * 256, dw, 51866, bf, True, None, f32, False, False))
    # mamba2-130m (serve_ssm): in_proj 768 x 3352 (N a multiple of 8, not of
    # 64: every tile row ends in an N tail), out_proj 1536 x 768 at M = 8
    # and 8 x 256; the tied unembed (B = embedding.T, N = 50280)
    dm, im = 768, 1536
    for m, phase in ((8, "decode"), (8 * 256, "prefill")):
        for name, k, n in (("in_proj", dm, 2 * im + 2 * 128 + 24),
                           ("out_proj", im, dm)):
            cases.append((f"mamba {phase} {name}", m, k, n, bf, False, None,
                          bf, False, True))
    cases.append(("mamba unembed (tied, B=emb.T, N = 50280, f32 out)", 8, dm,
                  50280, bf, True, None, f32, False, True))
    # zamba2-2.7b (serve_hybrid): the Mamba2 in_proj 2560 x 10448 (an N
    # tail again) and out_proj 5120 x 2560, the shared block's q/k/v/o
    # (MHA, 2560 x 2560) and SwiGLU (10240), at M = 8 and 8 x 256; the
    # untied unembed (N = 32000)
    dz, iz, ffz = 2560, 5120, 10240
    zproj = [("in_proj", dz, 2 * iz + 2 * 64 + 80, None),
             ("out_proj", iz, dz, None), ("q/k/v/o", dz, dz, None),
             ("gate+silu", dz, ffz, "silu"), ("up", dz, ffz, None),
             ("down", ffz, dz, None)]
    for m, phase in ((8, "decode"), (8 * 256, "prefill")):
        for name, k, n, act in zproj:
            cases.append((f"zamba {phase} {name}", m, k, n, bf, False, act,
                          bf, False, True))
    cases.append(("zamba unembed (f32 out)", 8, dz, 32000, bf, False, None,
                  f32, False, True))
    # llama3.2-1b training (train phase): batch 8 x 512 = 4096 rows.  The
    # forward (the gate runs without its SiLU, f32 out: the autograd
    # Function keeps the pre-activation), then dX = dZ @ W.T (B K-major)
    # and dW = X.T @ dZ (K = 4096) of each projection; the unembed's
    # backward products take its f32 cotangent on f32 operands and return
    # f32, cast after (simt).
    mt = 8 * 512
    for name, k, n, out in (("q/o", d, d, bf), ("k/v", d, kvd, bf),
                            ("gate (f32 pre-activation)", d, ff, f32),
                            ("up", d, ff, bf), ("down", ff, d, bf)):
        cases.append((f"train fwd {name}", mt, k, n, bf, False, None, out,
                      False, True))
        cases.append((f"train dX {name}", mt, n, k, bf, True, None, bf,
                      False, True))
        cases.append((f"train dW {name}", k, mt, n, bf, False, None, bf,
                      False, True))
    cases.append(("train fwd unembed (tied, B=emb.T, f32 out)", mt, d, vocab,
                  bf, True, None, f32, False, True))
    cases.append(("train unembed dX (f32 cotangent)", mt, vocab, d, f32,
                  False, None, f32, False, True))
    cases.append(("train unembed dW (f32 cotangent)", d, mt, vocab, f32,
                  False, None, f32, False, True))
    # the other train phases' products, each as above: whisper at 8 x 1500
    # encoder rows (its cross K/V projections have the q/k/v/o shape) and 8
    # x 512 decoder rows, biased; mamba2 and zamba2 at 8 x 512; the vlm at
    # 4 x 512 and its cross K/V over 4 x 1601 image tokens (no dX; dW's M
    # padded to 6408).  Each unembed's forward and f32 backward: whisper's
    # head K-major (its dX reads W.T row-major), mamba2's tied.
    for prefix, m, bias, proj in (
            ("train whisper encoder", 8 * 1500, "bias",
             (("q/k/v/o", dw, dw, bf), ("up (f32 pre-activation)", dw, ffw,
                                        f32), ("down", ffw, dw, bf))),
            ("train whisper decoder", mt, "bias",
             (("q/k/v/o", dw, dw, bf), ("up (f32 pre-activation)", dw, ffw,
                                        f32), ("down", ffw, dw, bf))),
            ("train mamba", mt, False,
             (("in_proj", dm, 2 * im + 2 * 128 + 24, bf),
              ("out_proj", im, dm, bf))),
            ("train zamba", mt, False, tuple(
                (name, k, n, f32 if act else bf)
                for name, k, n, act in zproj)),
            ("train vlm", 4 * 512, False, tuple(
                (name, k, n, f32 if act else bf)
                for name, k, n, act in vproj))):
        for name, k, n, out in proj:
            cases.append((f"{prefix} fwd {name}", m, k, n, bf, False, None,
                          out, bias, True))
            cases.append((f"{prefix} dX {name}", m, n, k, bf, True, None, bf,
                          False, True))
            cases.append((f"{prefix} dW {name}", k, m, n, bf, False, None, bf,
                          False, True))
    cases.append(("train vlm fwd cross k/v (4 x 1601 image tokens)", 4 * 1601,
                  dv, kvv, bf, False, None, bf, False, True))
    cases.append(("train vlm dW cross k/v (M padded to 6408)", dv, 6408, kvv,
                  bf, False, None, bf, False, True))
    for prefix, m, dd, v, head_kmajor in (
            ("train whisper", mt, dw, 51866, True),
            ("train mamba", mt, dm, 50280, True),
            ("train zamba", mt, dz, 32000, False),
            ("train vlm", 4 * 512, dv, 128256, False)):
        cases.append((f"{prefix} fwd unembed (f32 out)", m, dd, v, bf,
                      head_kmajor, None, f32, False, True))
        cases.append((f"{prefix} unembed dX (f32 cotangent)", m, v, dd, f32,
                      not head_kmajor, None, f32, False, True))
        cases.append((f"{prefix} unembed dW (f32 cotangent)", dd, m, v, f32,
                      False, None, f32, False, True))
    for (name, k, n) in (("k/v", d, kvd), ("down", ff, d)):
        for m in (1, 3, 8, 16):
            cases.append((f"decode edge {name} M={m} silu", m, k, n, bf,
                          False, "silu", bf, False, False))
            cases.append((f"decode edge {name} M={m} f32 out", m, k, n, bf,
                          False, None, f32, False, False))
    cases.append(("decode edge split-K down +C +bias alpha beta", 8, ff, d,
                  bf, False, "silu", bf, True, False))
    cases.append(("prefill edge M=1800 N=512", 1800, d, kvd, bf, False, None,
                  bf, False, False))
    cases.append(("prefill edge M=1800 +C +bias, f32 out", 1800, d, d, bf,
                  False, "gelu", f32, True, False))
    cases.append(("prefill edge K-major B (scoring unembed layout)", 2048, d,
                  4096, bf, True, None, f32, False, False))
    for act in (None, "relu", "gelu", "silu", "tanh"):
        cases.append((f"f32 decode q act={act} +C +bias alpha beta", 8, d, d,
                      f32, False, act, f32, True, False))
    cases.append(("ragged edges 37x100x77 bf16 +C +bias", 37, 100, 77,
                  bf, False, "gelu", bf, True, False))
    cases.append(("ragged edges 37x100x77 bf16 B=transposed", 37, 100, 77,
                  bf, True, None, f32, False, False))
    cases.append(("ragged edges 37x100x77 f32 B=transposed +C +bias", 37, 100,
                  77, f32, True, "tanh", f32, True, False))
    return cases


def gemm_operands(torch, gen, m, k, n, dtype, b_t):
    a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    if b_t:   # (N, K) storage read as its transpose, like embedding.t()
        b = (torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
             ).to(dtype).t()
    else:
        b = (torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
             ).to(dtype)
    return a, b


def resolve(op, dtype, shape):
    """The tuning registry's resolution for ``shape`` on the detected
    profile: what ``core.matmul`` / ``core.flash_attention`` launch."""
    from repro_torch.core import GLOBAL_REGISTRY, current_hardware
    return GLOBAL_REGISTRY.lookup_op(op, current_hardware(), dtype, shape)


def run_gemm_case(torch, timers, case, gen):
    from repro_torch.core.tile_config import TileConfig
    from repro_torch.kernels.gemm import gemm_cuda
    from repro_torch.kernels.ref import gemm_ref
    label, m, k, n, dtype, b_t, act, out_dtype, extras, main = case
    a, b = gemm_operands(torch, gen, m, k, n, dtype, b_t)
    kw = dict(activation=act, out_dtype=out_dtype)
    c = None
    if extras:
        kw.update(bias=torch.randn(n, generator=gen, device="cuda"))
    if extras is True:
        c = torch.randn(m, n, generator=gen, device="cuda")
        kw.update(alpha=0.5, beta=0.25)
    res = resolve("gemm", dtype, (m, k, n))
    tile = res.config
    before = dict(gemm_cuda.launches_by_path)
    out = gemm_cuda(a, b, c, config=tile, **kw)
    path = [p for p, v in gemm_cuda.launches_by_path.items()
            if v != before[p]][0]
    again = gemm_cuda(a, b, c, config=tile, **kw)
    ref = gemm_ref(a, b, c, **kw)
    # the simt kernel sums as the fma kernel does: the same bits
    fma = TileConfig(64, 16, 64, kernel="fma")
    yard = gemm_cuda(a, b, c, config=fma, **kw) if path == "simt" else None
    torch.cuda.synchronize()
    same_bits = bool(torch.equal(out, again))
    fma_bits = None if yard is None else bool(torch.equal(out, yard))
    del yard
    err = (out.float() - ref.float()).abs().max().item()
    # bf16 output: one bf16 ulp (2**-8 relative) of values up to ~4;
    # f32 output: summation order over K only.
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-4
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    in_bytes = a.element_size()
    nbytes = (m * k + k * n) * in_bytes + m * n * out.element_size()
    if extras:
        nbytes += n * 4 + (m * n * 4 if c is not None else 0)
    b_ms, b_by = bound(2.0 * m * n * k, nbytes, str(dtype).split(".")[1])
    timer, device_timer = timers
    reps = dict(reps=3, warmup=1) if 2.0 * m * n * k > 1e12 else {}
    kernel = lambda: gemm_cuda(a, b, c, config=tile, **kw)
    library = lambda: torch.matmul(a, b)
    kernel_ms = timer(kernel, **reps)
    kernel_device_ms = device_timer(kernel, **reps)
    extra = {}
    if fma_bits is not None:
        extra = {"bit_equal_fma": fma_bits, "fma_device_ms": device_timer(
            lambda: gemm_cuda(a, b, c, config=fma, **kw), **reps)}
    return {
        "name": "gemm", "replaces": KERNELS[0][3], "case": label,
        "shape": [m, k, n], "dtype": str(dtype).split(".")[1],
        "tile": tile.label, "schedule": tile.schedule, "path": path,
        "source": res.source, "max_abs_err": err, "tol": f"atol=rtol={tol}",
        "same_bits_twice": same_bits,
        "ok": bool(ok) and same_bits and fma_bits is not False,
        "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
        "plain_ms": timer(lambda: gemm_ref(a, b, c, **kw), **reps),
        "library_ms": timer(library, **reps),
        "library_device_ms": device_timer(library, **reps),
        "library": "torch.matmul",
        "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / kernel_ms,
        "share_of_bound_device": b_ms / kernel_device_ms,
        "main_path": main, "model": model_of(label), **extra,
    }


def model_of(label: str) -> str:
    """The model whose serve path gives a kernels-phase case its shape."""
    for prefix, model in (("train whisper", "whisper-large-v3 (train)"),
                          ("train mamba", "mamba2-130m (train)"),
                          ("train zamba", "zamba2-2.7b (train, 2 units)"),
                          ("train vlm", "llama-3.2-vision-11b (train, 1 unit)"),
                          ("train", "llama3.2-1b (train)"),
                          ("olmoe", "olmoe-1b-7b"),
                          ("vlm", "llama-3.2-vision-11b"),
                          ("whisper", "whisper-large-v3"),
                          ("stablelm", "stablelm-12b"),
                          ("mamba", "mamba2-130m"),
                          ("zamba", "zamba2-2.7b")):
        if label.startswith(prefix):
            return model
    return "llama3.2-1b"


def decode_batch_invariance(torch, gen):
    """Decode rows computed at M = 8 equal the same rows computed alone
    (M = 1), bit for bit (bf16), at every decode shape of the main path;
    f32 rows computed at M = 8 (``fma``, the f32 oracles' decode) equal the
    same rows inside an M = 300 product (``simt``, their prefill)."""
    from repro_torch.kernels.gemm import gemm_cuda
    rows = []
    for name, k, n, b_t, act, out_dtype in (
            ("q/o", 2048, 2048, False, None, torch.bfloat16),
            ("k/v", 2048, 512, False, None, torch.bfloat16),
            ("gate+silu", 2048, 8192, False, "silu", torch.bfloat16),
            ("down", 8192, 2048, False, None, torch.bfloat16),
            ("unembed", 2048, 128256, True, None, torch.float32)):
        a, b = gemm_operands(torch, gen, 8, k, n, torch.bfloat16, b_t)
        run = lambda x: gemm_cuda(x, b, config=resolve(
            "gemm", torch.bfloat16, (x.shape[0], k, n)).config,
            activation=act, out_dtype=out_dtype)
        batch = run(a)
        solo = torch.cat([run(a[i:i + 1]) for i in range(8)])
        torch.cuda.synchronize()
        rows.append({"case": f"decode {name} M=8 vs M=1", "shape": [8, k, n],
                     "bit_equal": bool(torch.equal(batch, solo))})
    for name, k, n, b_t in (("q/o", 2048, 2048, False),
                            ("unembed (tied)", 2048, 128256, True)):
        a, b = gemm_operands(torch, gen, 300, k, n, torch.float32, b_t)
        paths = {}

        def run(x):
            before = dict(gemm_cuda.launches_by_path)
            y = gemm_cuda(x, b, config=resolve(
                "gemm", torch.float32, (x.shape[0], k, n)).config,
                activation="silu")
            paths[x.shape[0]] = [p for p, v in gemm_cuda.launches_by_path
                                 .items() if v != before[p]][0]
            return y
        full = run(a)
        rows8 = run(a[96:104])
        torch.cuda.synchronize()
        rows.append({"case": f"f32 {name} M=8 ({paths[8]}) vs M=300 "
                     f"({paths[300]})", "shape": [300, k, n],
                     "bit_equal": bool(torch.equal(rows8, full[96:104]))
                     and paths == {300: "simt", 8: "fma"}})
        del a, b, full
    return rows


def flash_cases():
    """(label, B, S, Skv, H, KV, d, dtype, kv_start, main_path).  The main
    paths' prefill shapes first (llama3.2-1b; olmoe-1b-7b: MHA, group 1,
    d = 128; llama-3.2-vision-11b: group 4, d = 128; whisper-large-v3's
    decoder: group 1, d = 64; stablelm-12b: group 4, d = 160; zamba2-2.7b's
    shared block: group 1, d = 80); the f32 kernel at d = 160 and the two
    long prompts are not on a serve path (its prompts are at most 300
    tokens)."""
    ragged = [0, 17, 100, 255, 256, 3, 64, 200]     # 256: fully masked row
    return [
        ("prefill (8,256,32,64) ragged + fully masked row", 8, 256, 256, 32, 8,
         64, "bfloat16", ragged, True),
        ("olmoe prefill (8,256,16,16,128) ragged + fully masked row", 8, 256,
         256, 16, 16, 128, "bfloat16", ragged, True),
        ("vlm prefill (8,256,32,8,128) ragged + fully masked row", 8, 256,
         256, 32, 8, 128, "bfloat16", ragged, True),
        ("whisper prefill (8,256,20,20,64) ragged + fully masked row", 8,
         256, 256, 20, 20, 64, "bfloat16", ragged, True),
        ("stablelm prefill (8,256,32,8,160) ragged + fully masked row", 8,
         256, 256, 32, 8, 160, "bfloat16", ragged, True),
        ("zamba prefill d 80 (8,256,32,32,80) ragged + fully masked row", 8,
         256, 256, 32, 32, 80, "bfloat16", ragged, True),
        ("f32 d 160 (4,300,32,8,160) ragged", 4, 300, 300, 32, 8, 160,
         "float32", [0, 7, 150, 300], False),
        ("non-divisible S=200 + fully masked row", 8, 200, 200, 32, 8, 64,
         "bfloat16", [0, 5, 199, 200, 1, 63, 64, 150], False),
        ("causal S=100 < Skv=256", 2, 100, 256, 32, 8, 64, "bfloat16", [0, 40],
         False),
        ("f32 (4,300,32,64) ragged", 4, 300, 300, 32, 8, 64, "float32",
         [0, 7, 150, 300], False),
        ("long causal (1,4096,32,64)", 1, 4096, 4096, 32, 8, 64, "bfloat16",
         [0], False),
        ("long ragged (4,1024,32,64)", 4, 1024, 1024, 32, 8, 64, "bfloat16",
         [0, 100, 511, 1000], False),
    ]


def flash_operands(torch, case, gen):
    """q, k, v and kv_start of a ``flash_cases`` row, on the card."""
    _, b, s, skv, h, kvh, d, dtype, ks, _ = case
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dt)
    k = torch.randn(b, skv, kvh, d, generator=gen, device="cuda").to(dt)
    v = torch.randn(b, skv, kvh, d, generator=gen, device="cuda").to(dt)
    return q, k, v, torch.tensor(ks, dtype=torch.int32, device="cuda")


def flash_bound(torch, case):
    """(bound ms, bound_by) for the work this case's data needs: 4 d FLOP
    per unmasked (query, key) pair and head; q, k, v, o and kv_start moved
    once."""
    _, b, s, skv, h, kvh, d, dtype, ks, _ = case
    pairs = 0
    for start in ks:
        for r in range(s):
            hi = min(skv, r + (skv - s) + 1)
            pairs += max(0, hi - start)
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * s * h * d + 2 * b * skv * kvh * d) * size + b * 4
    return bound(4.0 * d * pairs * h, nbytes, dtype)


def flash_library(torch, q, k, v, kv_start):
    """One ``F.scaled_dot_product_attention`` call computing the same
    function (GQA heads expanded beforehand): the yardstick."""
    import torch.nn.functional as F
    b, s, h, _ = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1)
    if s == skv and not kv_start.any():   # plain causal: SDPA's causal kernels
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    cols = torch.arange(skv, device="cuda")
    rows = torch.arange(s, device="cuda")
    mask = ((cols[None, :] <= rows[:, None] + (skv - s))[None]
            & (cols[None, None, :] >= kv_start[:, None, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def run_flash_case(torch, timers, case, gen):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref
    label, b, s, skv, h, kvh, d, dtype, ks, main = case
    q, k, v, kv_start = flash_operands(torch, case, gen)
    res = resolve("flash_attention", q.dtype, (s, skv, d))
    tile = res.config
    run = lambda: flash_attention_cuda(q, k, v, config=tile, causal=True,
                                       kv_start=kv_start)
    before = dict(flash_attention_cuda.launches_by_path)
    out = run()
    path = [p for p, n in flash_attention_cuda.launches_by_path.items()
            if n != before[p]][0]
    again = run()
    ref = flash_attention_ref(q, k, v, causal=True, kv_start=kv_start)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out.float()).all())
    same_bits = bool(torch.equal(out, again))
    err = (out.float() - ref.float()).abs().max().item()
    # bf16 output: one bf16 ulp; f32: exp and summation order only.
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    ok = finite and same_bits and torch.allclose(out.float(), ref.float(),
                                                 atol=tol, rtol=tol)
    b_ms, b_by = flash_bound(torch, case)
    lib = flash_library(torch, q, k, v, kv_start)
    timer, device_timer = timers
    kernel_ms, kernel_device_ms = timer(run), device_timer(run)
    return {
        "name": "flash_attention", "replaces": KERNELS[1][3], "case": label,
        "shape": [[b, s, h, d], [b, skv, kvh, d]], "dtype": dtype,
        "tile": tile.label, "schedule": tile.schedule, "max_abs_err": err,
        "tol": f"atol=rtol={tol}", "path": path, "source": res.source,
        "finite": finite,
        "same_bits_twice": same_bits, "ok": bool(ok),
        "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
        "plain_ms": timer(lambda: flash_attention_ref(
            q, k, v, causal=True, kv_start=kv_start)),
        "library_ms": timer(lib), "library_device_ms": device_timer(lib),
        "library": "F.scaled_dot_product_attention",
        "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / kernel_ms,
        "share_of_bound_device": b_ms / kernel_device_ms,
        "main_path": main, "model": model_of(label),
    }


def phase_kernels(torch, out_dir):
    timers = (Timer(torch), Timer(torch, device_only=True))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = [run_gemm_case(torch, timers, c, gen) for c in gemm_cases(torch)]
    rows += [run_flash_case(torch, timers, c, gen) for c in flash_cases()]
    invariance = decode_batch_invariance(torch, gen)
    emit({"phase": "kernels", "cases": rows, "batch_invariance": invariance})
    if out_dir:
        with open(os.path.join(out_dir, "kernel_cases.json"), "w") as f:
            json.dump({"cases": rows, "batch_invariance": invariance}, f,
                      indent=1)
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    bad = [r["case"] for r in invariance if not r["bit_equal"]]
    if bad:
        raise AssertionError(f"rows differ between batch sizes: {bad}")
    slow = [r["case"] for r in rows if r["main_path"] and r["path"] not in (
        ("simt",) if r["dtype"] == "float32" and r["name"] == "gemm" else
        ("decode", "wgmma") if r["name"] == "gemm" else ("wgmma",))]
    if slow:
        raise AssertionError(f"main-path shapes off the new kernels: {slow}")
    emit(train_unembed_f32(torch, rows))
    return rows


def train_unembed_f32(torch, rows):
    """The unembed's f32 backward (dX + dW on ``simt``) of each train
    phase, summed from its two kernels-phase rows: kernel and device ms,
    the bound, the ``fma`` kernel's device ms on the same operands (the
    earlier kernel), ``torch.matmul`` f32, the plain version, the share of
    bound, and whether both products equal ``fma``'s bits."""
    out = {"phase": "train_unembed_f32", "card": torch.cuda.get_device_name(0),
           "nvidia_smi": smi(), "phases": {}}
    for prefix, model in (("train unembed", "llama3.2-1b"),
                          ("train vlm unembed", "llama-3.2-vision-11b"),
                          ("train zamba unembed", "zamba2-2.7b"),
                          ("train whisper unembed", "whisper-large-v3"),
                          ("train mamba unembed", "mamba2-130m")):
        two = [r for r in rows if r["case"].startswith(prefix)
               and "f32 cotangent" in r["case"]]
        assert len(two) == 2, (prefix, [r["case"] for r in two])
        tot = {key: sum(r[key] for r in two) for key in (
            "kernel_ms", "kernel_device_ms", "fma_device_ms", "bound_ms",
            "library_ms", "library_device_ms", "plain_ms")}
        tot.update(shapes=[r["shape"] for r in two],
                   schedules=[r["schedule"] for r in two],
                   paths=[r["path"] for r in two],
                   bit_equal_fma=all(r.get("bit_equal_fma") for r in two),
                   share_of_bound_device=tot["bound_ms"]
                   / tot["kernel_device_ms"],
                   vs_library_device=tot["kernel_device_ms"]
                   / tot["library_device_ms"],
                   vs_fma_device=tot["kernel_device_ms"]
                   / tot["fma_device_ms"])
        out["phases"][model] = tot
    bad = [m for m, t in out["phases"].items()
           if t["paths"] != ["simt", "simt"] or not t["bit_equal_fma"]]
    if bad:
        raise AssertionError(f"unembed f32 backward off simt or not equal "
                             f"to fma's bits: {bad}")
    return out


# ---------------------------------------------------------------------------
# phase: tuning
# ---------------------------------------------------------------------------

def hold_schedule(torch, gen, op, cfg, shape, heads=(32, 8)):
    """Launch ``cfg`` at ``shape`` (gemm (m, k, n): B K-major where N is not
    a multiple of 8, as the models keep such heads, f32 operands for the
    f32 kernels; flash (sq, skv, d): 8 rows of ``heads``) and hold it
    against the plain version.  Returns (max abs error, the wrapper took
    ``cfg``'s kernel)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gemm import F32_KERNELS, gemm_cuda
    tol = 2e-2
    if op == "gemm":
        m, k, n = shape
        dtype = torch.bfloat16
        if cfg.kernel in F32_KERNELS:
            dtype, tol = torch.float32, 1e-4
        a, b = gemm_operands(torch, gen, m, k, n, dtype, n % 8 != 0)
        fn, counts = gemm_cuda, gemm_cuda.launches_by_path
        before = counts[cfg.kernel]
        got = gemm_cuda(a, b, config=cfg, activation="silu")
        want = ref.gemm_ref(a, b, activation="silu")
    else:
        sq, skv, d = shape
        case = ("", 8, sq, skv, heads[0], heads[1], d, "bfloat16",
                [0] * 8, False)
        q, k, v, kv_start = flash_operands(torch, case, gen)
        counts = flash_attention_cuda.launches_by_path
        before = counts[cfg.kernel]
        got = flash_attention_cuda(q, k, v, config=cfg, kv_start=kv_start)
        want = ref.flash_attention_ref(q, k, v, kv_start=kv_start)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # bf16 output: one bf16 ulp of values up to ~4 (as the kernels phase);
    # f32: summation order over K
    ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
    return err, ok and counts[cfg.kernel] == before + 1


def phase_tuning(torch):
    """The committed h100 table loads strictly and each of its schedules,
    and each new ``dispatch_*`` schedule, holds against the plain version;
    a measured sweep records an exact entry the next matmul launches."""
    from repro_torch.core import GLOBAL_REGISTRY, current_hardware, matmul
    from repro_torch.core import tuner, tuning_db
    from repro_torch.core.tile_config import (H100_FLASH_TILES,
                                              H100_GEMM_TILES,
                                              H100_UNALIGNED_TILES,
                                              FlashAttentionConfig,
                                              TileConfig, _same_launch,
                                              gemm_tiles)
    from repro_torch.kernels.flash_attention import instantiated_head_dims
    from repro_torch.kernels.gemm import gemm_cuda, instantiated_schedules

    hw = current_hardware()
    assert hw == "h100", f"the card resolved to profile {hw!r}, not h100"
    path = tuning_db.db_path("h100")
    db = tuning_db.TuningDB.from_file(path)
    loaded = tuning_db.load_into_registry(GLOBAL_REGISTRY, path, strict=True)
    assert db.hardware == "h100" and loaded == len(db) > 0, (db.hardware,
                                                            loaded)
    assert not db.stale(), [r.shape for r in db.stale()]
    gen = torch.Generator(device="cuda").manual_seed(18)
    entries = []
    for rec in db.records():
        err, ok = hold_schedule(torch, gen, rec.op, rec.config, rec.shape)
        entries.append({"op": rec.op, "shape": list(rec.shape),
                        "schedule": rec.config.schedule,
                        "measured_us": rec.seconds * 1e6,
                        "max_abs_err": err, "ok": ok})
    # every schedule the dispatch lines instantiate and the hand tables do
    # not name, at ragged shapes (the lines this slice added among them)
    hand = {(t.kernel, t.bm, t.bk, t.bn, t.stages)
            for rows in H100_GEMM_TILES.values() for *_, t in rows}
    hand |= {(t.kernel, t.bm, t.bk, t.bn, t.stages)
             for rows in H100_UNALIGNED_TILES.values() for _, t in rows}
    hand_flash = {(t.kernel, t.bq, t.bk, t.stages)
                  for rows in H100_FLASH_TILES.values() for *_, t in rows}
    lines = []
    for kernel in ("decode", "wgmma", "simt"):
        for bm, bk, bn, st in sorted(instantiated_schedules()[kernel]):
            if (kernel, bm, bk, bn, st) in hand:
                continue
            cfg = TileConfig(bm, bk, bn, kernel=kernel, stages=st,
                             split_k=3 if kernel == "decode" else 1,
                             group_m=1 if kernel == "decode" else 3)
            shape = (13 if kernel == "decode" else 700, 1000, 1096)
            err, ok = hold_schedule(torch, gen, "gemm", cfg, shape)
            lines.append({"schedule": cfg.schedule, "shape": list(shape),
                          "max_abs_err": err, "ok": ok})
    for (bq, bk, st), dims in sorted(instantiated_head_dims()["wgmma"].items()):
        if ("wgmma", bq, bk, st) in hand_flash:
            continue
        cfg = FlashAttentionConfig(bq, bk, kernel="wgmma", stages=st)
        for d in dims:
            err, ok = hold_schedule(torch, gen, "flash_attention", cfg,
                                    (333, 333, d), heads=(16, 4))
            lines.append({"schedule": cfg.schedule, "shape": [333, 333, d],
                          "max_abs_err": err, "ok": ok})
    # one measured sweep: its winner is the exact entry the next matmul takes
    shape = (8, 2048, 8192)
    res = tuner.sweep_gemm(*shape, mode="measure", search="exhaustive",
                           repeats=3)
    won = res.best.config
    look = GLOBAL_REGISTRY.lookup_op("gemm", hw, torch.bfloat16, shape)
    x = torch.randn(shape[0], shape[1], generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn(shape[1], shape[2], generator=gen, device="cuda")
         * shape[1] ** -0.5).to(torch.bfloat16)
    before = gemm_cuda.launches_by_path[won.kernel]
    via_matmul = matmul(x, w)
    took = gemm_cuda.launches_by_path[won.kernel] == before + 1
    direct = gemm_cuda(x, w, config=won)
    torch.cuda.synchronize()
    table = gemm_tiles(torch.bfloat16, *shape)
    hand_us = next((p.seconds for p in res.points
                    if _same_launch(p.config, table, shape[1])), None)
    sweep = {"shape": list(shape), "candidates": res.candidates_total,
             "winner": won.schedule, "winner_device_us": res.best.seconds * 1e6,
             "hand_table": table.schedule,
             "hand_table_device_us": hand_us * 1e6 if hand_us else None,
             "lookup": look.source,
             "matmul_took_winner": took and bool(torch.equal(via_matmul,
                                                             direct))}
    # back to the committed table for the serve phases
    tuning_db.load_into_registry(GLOBAL_REGISTRY, path, strict=True)
    out = {"phase": "tuning", "table": os.path.relpath(path, HERE),
           "measured_on": db.measured_on, "entries": len(db),
           "ops": db.ops(), "entries_held": entries, "new_lines": lines,
           "sweep": sweep}
    emit(out)
    bad = [e for e in entries + lines if not e["ok"]]
    assert not bad, f"tuned or new schedules disagree or did not run: {bad}"
    assert look.source == "exact" and look.config == won, look
    assert sweep["matmul_took_winner"], sweep
    return out


# ---------------------------------------------------------------------------
# phase: serve
# ---------------------------------------------------------------------------

def phase_serve(torch):
    import dataclasses
    from unittest import mock

    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import Model
    from repro_torch.serve import Engine, ServeConfig, generate_per_prompt
    from repro_torch.serve.engine import _bucket_len

    name = torch.cuda.get_device_name(0)
    cfg = dataclasses.replace(get_config("llama3.2-1b"), dtype="bfloat16",
                              attention_impl="flash")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    lens = rng.integers(5, 301, size=12)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    max_new = 32
    eng = Engine(model, params, ServeConfig(max_batch=8, max_len=1024,
                                            decode_chunk=8, profile=True))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    gemm_paths = kernels.gemm_launches_by_path()
    flash_paths = kernels.flash_launches_by_path()
    st = eng.stats()
    assert all(len(o) == max_new for o in outs), [len(o) for o in outs]
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert launches["gemm"] > 0 and launches["flash_attention"] > 0, launches
    # every bf16 product of the serve path went through the new kernels
    assert gemm_paths["decode"] > 0 and gemm_paths["wgmma"] > 0, gemm_paths
    assert gemm_paths["wmma"] == gemm_paths["fma"] == gemm_paths["simt"] \
        == 0, gemm_paths
    # and every bf16 prefill attention through the wgmma flash kernel
    assert flash_paths["wgmma"] > 0 and flash_paths["fma"] == 0, flash_paths
    assert st["device_transfers"] == st["chunks"], st
    assert st["admissions"] >= 12 and st["admission_prefills"] >= 2, st
    # the schedules came from the committed h100 table
    assert st["hardware"] == "h100", st["hardware"]
    assert st["hardware_platform"] == "gpu", st["hardware_platform"]
    lookups = st["decode_tile_lookups"]
    assert lookups and all(v["source"] == "exact" for v in lookups.values()), \
        lookups
    assert st["prefill_flash_lookups"] and all(
        v["source"] in ("exact", "nearest")
        for v in st["prefill_flash_lookups"].values()), \
        st["prefill_flash_lookups"]
    assert "page_size_source" in st, sorted(st)
    serve = {
        "phase": "serve", "card": name, "model": cfg.name, "dtype": cfg.dtype,
        "params": model.param_count(), "init_seconds": init_s,
        "requests": len(prompts), "prompt_tokens": int(lens.sum()),
        "max_new": max_new, "tokens_generated": st["tokens_generated"],
        "chunks": st["chunks"], "device_transfers": st["device_transfers"],
        "admission_prefills": st["admission_prefills"],
        "preemptions": st["preemptions"],
        "prefill_seconds": st["prefill_seconds"],
        "decode_seconds": st["decode_seconds"], "wall_seconds": wall,
        "prefill_tok_per_s": float(lens.sum()) / st["prefill_seconds"],
        "decode_tok_per_s": st["tokens_generated"] / st["decode_seconds"],
        "launches": launches, "gemm_launches_by_path": gemm_paths,
        "flash_launches_by_path": flash_paths,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "hardware": st["hardware"], "hardware_platform":
        st["hardware_platform"], "decode_tile_lookups": lookups,
        "prefill_flash_lookups": st["prefill_flash_lookups"],
        "registry_hit_stats": st["registry_hit_stats"],
        "page_size_source": st["page_size_source"],
    }

    # one warm serve of the same requests under profiling.trace (the
    # prefix cache cleared: the same prompts would hit it): one
    # serve.decode_chunk marker and one device-to-host copy a chunk
    eng.clear_prefix_cache()
    before = eng.stats()
    calls = {"prefill": {}, "decode": {}}
    real_prefill, real_decode = Model.prefill, Model.decode_step

    def note(kind, key):
        calls[kind][key] = calls[kind].get(key, 0) + 1

    def prefill_noted(self, params_, batch, cache):
        note("prefill", tuple(batch["tokens"].shape))
        return real_prefill(self, params_, batch, cache)

    def decode_noted(self, params_, tokens, cache, offset, kv_start=None):
        note("decode", (tokens.shape[0], cache["self"][0].shape[-3]))
        return real_decode(self, params_, tokens, cache, offset, kv_start)
    with mock.patch.object(Model, "prefill", prefill_noted), \
            mock.patch.object(Model, "decode_step", decode_noted):
        outs_traced, events, secs = traced(
            "serve", lambda: eng.generate(prompts, max_new))
    st2 = eng.stats()
    _, prof = profile_summary("serving", events)
    for kind, span in (("prefill", "serve.prefill_admit"),
                       ("decode", "serve.decode_chunk")):
        MEASURED_STEPS.append({
            "label": f"serve_{kind}", "cfg": cfg, "kind": kind,
            "calls": calls[kind], "measured": span_times(events, span),
            "peak_mem_gb": serve["peak_mem_gb"]})
    del events
    prof.update(secs)
    prof.update({k: st2[k] - before[k] for k in (
        "chunks", "device_transfers", "admission_prefills")},
        tokens_equal_first_serve=outs_traced == outs)
    serve["serve_profile"] = prof
    ann = prof["annotations"]
    assert ann.get("serve.decode_chunk", {}).get("count") == prof[
        "chunks"] == prof["device_transfers"], prof
    assert prof["host_syncs"] == prof["chunks"], prof
    assert ann.get("serve.prefill_admit", {}).get("count") == prof[
        "admission_prefills"], prof
    assert prof["k1"]["families"] == ["gemm"] and prof["k1"]["launches"], prof
    assert prof["k2"]["families"] == ["attention"] and prof["k2"][
        "launches"], prof

    # batched ragged prefill (the engine's layout) vs per-prompt prefill
    first = prompts[:8]
    plen = _bucket_len(max(len(p) for p in first))
    toks = np.zeros((8, plen), np.int32)
    ks = np.zeros(8, np.int32)
    for i, p in enumerate(first):
        toks[i, plen - len(p):] = p
        ks[i] = plen - len(p)
    batch = {"tokens": torch.from_numpy(toks).cuda(),
             "kv_start": torch.from_numpy(ks).cuda()}
    with torch.no_grad():
        batched, _ = model.prefill(params, batch,
                                   model.init_cache(8, plen, device="cuda"))
        solo = torch.cat([model.prefill(
            params, {"tokens": torch.tensor([p], dtype=torch.int32,
                                            device="cuda")},
            model.init_cache(1, len(p), device="cuda"))[0] for p in first])
    diff = (batched - solo).abs().max().item()
    agree = (batched.argmax(-1) == solo.argmax(-1)).float().mean().item()
    # bf16 keeps 8 mantissa bits: a one-ulp difference in one row's attention
    # output (the flash tiles fall differently for padded and solo rows)
    # propagates through 16 layers; the logits' std here is ~0.9.
    tol = 0.15
    serve.update(prefill_batched_vs_solo_max_abs=diff, prefill_tol=tol,
                 prefill_argmax_agree=agree)
    assert torch.isfinite(batched).all() and diff <= tol, (diff, tol)
    # the prefix cache is on by default: these prompts share no prefix
    assert st["prefix_cache"]["enabled"], st["prefix_cache"]
    assert st["prefix_cache"]["hits_full"] == 0, st["prefix_cache"]
    serve["prefix_cache"] = st["prefix_cache"]
    del eng
    torch.cuda.empty_cache()

    # float32 pass: full width, 2 layers, tokens exact against the oracle
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=2)
    m32 = build_model(cfg32)
    p32 = m32.init(seed=1, device="cuda")
    prompts32 = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
                 for n in (5, 37, 11, 200, 64, 130)]
    eng32 = Engine(m32, p32, ServeConfig(max_batch=4, max_len=512,
                                         decode_chunk=8))
    got = eng32.generate(prompts32, 8)
    want = generate_per_prompt(m32, p32, prompts32, 8, max_len=512)
    assert got == want, (got, want)
    serve["f32_pass"] = {"layers": 2, "requests": len(prompts32),
                         "max_new": 8, "tokens_equal_oracle": got == want}
    emit(serve)
    ctx = {"cfg": cfg, "model": model, "params": params, "prompts": prompts,
           "outs": outs, "m32": m32, "p32": p32, "prompts32": prompts32}
    return launches, {"gemm": gemm_paths, "flash_attention": flash_paths}, ctx


# ---------------------------------------------------------------------------
# phase: ir
# ---------------------------------------------------------------------------

#: the ir phase's limit (the checker's smoke in a fresh process and the
#: full-width traced admission and chunk)
IR_PHASE_LIMIT_S = 60.0
#: the committed CPU case whose decode chunk the card's is diffed against
IR_CPU_CASE = "llama3.2-1b/continuous/single/bfloat16"


def ir_smoke_cli():
    """``python -m repro_torch.analysis ir --smoke`` in a fresh process on
    this machine (its own torch, no JAX): exit 0 and 0 errors; a warning
    may only be IR005's (hashes gate on the torch version the committed
    fingerprints were blessed under).  Traced anew (``--no-cache``)."""
    out_json = os.path.join(HERE, "build", "ir_smoke.json")
    cache = os.path.join(HERE, "build", "ir_cache")
    code = ("import sys\nfrom repro_torch.analysis.cli import main\n"
            f"rc = main(['ir', '--smoke', '--no-cache', '--json', "
            f"{out_json!r}, '--cache-dir', {cache!r}])\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out_json) as f:
        blob = json.load(f)
    warned = sorted({f["check_id"] for f in blob["findings"]
                     if f["severity"] != "error"})
    assert blob["errors"] == 0 and warned in ([], ["IR005"]), blob
    return {"rc": proc.returncode, "seconds": secs,
            "errors": blob["errors"], "warnings": blob["warnings"],
            "warning_ids": warned, "torch_version": blob["torch_version"],
            "fingerprint_torch_version": blob["fingerprint_torch_version"],
            "hash_gate_active": blob["hash_gate_active"],
            "cases": [r["case"] for r in blob["ir_cases"]],
            "summary": proc.stdout.strip().splitlines()[-1]}


def ir_full_width(torch, ctx):
    """The serve phase's model (llama3.2-1b, 16 layers, d 2048, bf16) on an
    engine like the serve phase's (8 slots, max_len 1024, chunk 8): one
    admission of 8 of its prompts and one decode chunk over those rows,
    each under the IR tracer on the card, with the launch counts set to 0
    just before and read just after each.  IR000-IR003 against the
    ``h100`` profile must find nothing; K1's units in the chunk must equal
    its launches there (all on the decode kernel), K2's units in the
    admission its launches (all wgmma)."""
    import contextlib

    from repro_torch import kernels
    from repro_torch.analysis.ir import checks, fingerprints, trace
    from repro_torch.serve import Engine, ServeConfig
    eng = Engine(ctx["model"], ctx["params"], ServeConfig(
        max_batch=8, max_len=1024, decode_chunk=8))
    prompts = ctx["prompts"][:8]
    seen = {}

    @contextlib.contextmanager
    def around(entry):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        yield
        torch.cuda.synchronize()
        seen[entry] = {"gemm": kernels.gemm_launches_by_path(),
                       "flash_attention": kernels.flash_launches_by_path(),
                       "max_memory_allocated":
                       torch.cuda.max_memory_allocated()}
    t0 = time.perf_counter()
    entries, errors = trace.trace_continuous(eng, prompts, around=around)
    secs = time.perf_counter() - t0
    result = trace.case_result(eng, f"{IR_CPU_CASE} (full width, card)",
                               entries, errors, secs)
    findings = checks.check_case(result)
    assert result.hardware == "h100", result.hardware
    assert not findings, [f.render() for f in findings]
    admit, chunk = entries["admit"], entries["decode_chunk"]
    k1 = chunk.prim_histogram.get("repro_torch.gemm", 0)
    gp = seen["decode_chunk"]["gemm"]
    assert k1 > 0 and k1 == gp["decode"] == sum(gp.values()), (k1, gp)
    k2 = admit.prim_histogram.get("repro_torch.flash_attention", 0)
    fp = seen["admit"]["flash_attention"]
    assert k2 > 0 and k2 == fp["wgmma"] == sum(fp.values()), (k2, fp)
    cpu = fingerprints.load_fingerprints()["cases"][IR_CPU_CASE]
    del eng
    return {
        "case": result.case_id, "seconds": secs, "hardware":
        result.hardware, "findings": len(findings),
        "prompt_tokens": [len(p) for p in prompts],
        "entries": {e: {"seconds": s.seconds, "ops": sum(
            s.prim_histogram.values()), "program_hash": s.program_hash,
            "traced_peak_bytes": s.memory["peak_bytes"],
            "argument_bytes": s.memory["argument_bytes"],
            "max_memory_allocated": seen[e]["max_memory_allocated"],
            "gemm_launches_by_path": seen[e]["gemm"],
            "flash_launches_by_path": seen[e]["flash_attention"],
            "converts": len(s.converts), "dots": len(s.dots)}
            for e, s in entries.items()},
        "k1_units_chunk": k1, "k2_units_admit": k2,
        "decode_chunk_vs_cpu": fingerprints.structural_diff(
            cpu["entries"]["decode_chunk"]["prims"], chunk.prim_histogram),
    }


def phase_ir(torch, ctx):
    """The IR checker on the card's machine: the ``ir --smoke`` CLI in a
    fresh process, then the serve phase's model at full width traced on
    the card (:func:`ir_full_width`)."""
    t0 = time.perf_counter()
    out = {"phase": "ir", "card": torch.cuda.get_device_name(0),
           "nvidia_smi": smi(), "cli": ir_smoke_cli(),
           "full_width": ir_full_width(torch, ctx)}
    free_card(torch)
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    assert out["seconds"] <= IR_PHASE_LIMIT_S, out["seconds"]
    return out


# ---------------------------------------------------------------------------
# phase: serve_features
# ---------------------------------------------------------------------------

def prefix_traffic(rng, vocab: int, prefix, repeat_of):
    """8 prompts sharing ``prefix`` (256 tokens: 16 pages of 16), each with
    its own suffix of 5-60 tokens, then 4 exact repeats of ``repeat_of``'s
    first four (of the 8 themselves when ``repeat_of`` is None)."""
    fresh = [prefix + rng.integers(0, vocab, size=int(n)).tolist()
             for n in rng.integers(5, 61, size=8)]
    return fresh + [list(p) for p in (repeat_of or fresh)[:4]]


def drain(eng, Request, prompts, max_new, extra=None):
    """Submit ``prompts`` and run the engine; with ``extra`` inputs,
    request ``i`` takes their row ``i``."""
    handles = [eng.submit(Request(prompt=p, max_new_tokens=max_new,
                                  row=i if extra else None))
               for i, p in enumerate(prompts)]
    eng.run(extra)
    return [h.result(timeout=0) for h in handles]


def phase_serve_features(torch, ctx):
    """The serve paths this slice added, at full width: a. wave, b. prefix
    cache cold then warm, c. sampling, d. int8 KV, e. the threaded Server
    with streaming, f. float32 exactness of the wave, prefix-cache and int8
    engines against the per-prompt oracle.  Each of a-e resets the launch
    counts before it starts and reads them after; each requires every GEMM
    on the decode or wgmma kernel and every prefill attention on the wgmma
    flash kernel."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.serve import (Engine, Request, ServeConfig, Server,
                                   generate_per_prompt)

    cfg, model, params = ctx["cfg"], ctx["model"], ctx["params"]
    prompts, cont_outs = ctx["prompts"], ctx["outs"]
    vocab = cfg.vocab_size
    out = {"phase": "serve_features", "card": torch.cuda.get_device_name(0)}

    def serve_cfg(**kw):
        base = dict(max_batch=8, max_len=1024, decode_chunk=8, profile=True)
        base.update(kw)
        return ServeConfig(**base)

    def measured(name, fn):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, engines = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gemm = kernels.gemm_launches_by_path()
        flash = kernels.flash_launches_by_path()
        assert gemm["decode"] > 0 and gemm["wgmma"] > 0, (name, gemm)
        assert gemm["wmma"] == gemm["fma"] == gemm["simt"] == 0, (name, gemm)
        assert flash["wgmma"] > 0 and flash["fma"] == 0, (name, flash)
        stats = [e.stats() for e in engines]
        pre = sum(s["prefill_seconds"] for s in stats)
        dec = sum(s["decode_seconds"] for s in stats)
        toks = sum(s["tokens_generated"] for s in stats)
        res.update(wall_seconds=wall, prefill_seconds=pre,
                   decode_seconds=dec, tokens_generated=toks,
                   decode_tok_per_s=toks / dec if dec else None,
                   gemm_launches_by_path=gemm,
                   flash_launches_by_path=flash,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[name] = res
        return res

    prompt_toks = sum(len(p) for p in prompts)

    def wave():
        eng = Engine(model, params, serve_cfg(scheduler="wave"))
        got = eng.generate(prompts, 32)
        st = eng.stats()
        assert st["scheduler"] == "wave", st["scheduler"]
        assert st["device_transfers"] == st["waves"] >= 2, st
        assert all(len(o) == 32 and all(0 <= t < vocab for t in o)
                   for o in got)
        ctx["wave_outs"] = got
        return {"waves": st["waves"], "device_transfers":
                st["device_transfers"],
                "prefill_tok_per_s": prompt_toks / st["prefill_seconds"],
                "share_equal_to_continuous": float(np.mean(
                    [a == b for a, b in zip(got, cont_outs)]))}, [eng]
    measured("a_wave", wave)

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab, size=256).tolist()
    cold_traffic = prefix_traffic(rng, vocab, prefix, None)
    warm_traffic = prefix_traffic(rng, vocab, prefix, cold_traffic)

    def prefix_cache():
        eng = Engine(model, params, serve_cfg(page_size=16))
        cold = drain(eng, Request, cold_traffic, 32)
        pc0 = dict(eng.stats()["prefix_cache"])
        warm = drain(eng, Request, warm_traffic, 32)
        st = eng.stats()
        pc = {k: st["prefix_cache"][k] - pc0[k] for k in
              ("hits_full", "hits_partial", "misses",
               "prefill_tokens_saved", "pages_write_skipped")}
        assert st["device_transfers"] == st["chunks"], st
        assert pc["hits_full"] >= 4 and pc["hits_partial"] >= 7, pc
        first_cold = {tuple(p): r.tokens[0] for p, r in
                      zip(cold_traffic, cold)}
        full = [(p, r) for p, r in zip(warm_traffic, warm)
                if r.prefix_hit == "full"]
        assert len(full) >= 4
        assert all(r.tokens[0] == first_cold[tuple(p)] for p, r in full)
        eng.clear_prefix_cache()
        used = eng.stats()["pages"]["used_pages"]
        assert used == 0, used
        return {"cold": {k: pc0[k] for k in pc}, "warm": pc,
                "full_hit_first_tokens_equal_cold": True,
                "used_pages_after_clear": used,
                "prefill_tok_per_s": sum(len(p) for p in cold_traffic
                                         + warm_traffic)
                / st["prefill_seconds"]}, [eng]
    measured("b_prefix_cache", prefix_cache)

    def sampling():
        engs = [Engine(model, params, serve_cfg(temperature=0.8, seed=0))
                for _ in range(2)]
        a, b = (e.generate(prompts, 32) for e in engs)
        assert a == b
        assert all(0 <= t < vocab for o in a for t in o)
        for e in engs:
            st = e.stats()
            assert st["device_transfers"] == st["chunks"], st
        return {"tokens_equal_across_engines": True,
                "share_equal_to_greedy": float(np.mean(
                    [x == y for x, y in zip(a, cont_outs)])),
                "prefill_tok_per_s": 2 * prompt_toks / sum(
                    e.stats()["prefill_seconds"] for e in engs)}, engs
    measured("c_sampling", sampling)

    model_q = build_model(dataclasses.replace(cfg, kv_quant=True))

    def int8():
        eng = Engine(model_q, params, serve_cfg())
        got = eng.generate(prompts, 32)
        st = eng.stats()
        assert st["scheduler"] == "wave", st["scheduler"]
        assert st["scheduler_forced"] == "int8-quantized KV cache", st
        assert st["device_transfers"] == st["waves"], st
        assert all(len(o) == 32 and all(0 <= t < vocab for t in o)
                   for o in got)
        return {"scheduler": st["scheduler"],
                "scheduler_forced": st["scheduler_forced"],
                "share_equal_to_wave": float(np.mean(
                    [x == y for x, y in zip(got, ctx["wave_outs"])])),
                "prefill_tok_per_s": prompt_toks / st["prefill_seconds"]
                }, [eng]
    measured("d_int8_kv", int8)

    def server():
        eng = Engine(model, params, serve_cfg())
        events = [[] for _ in range(8)]
        with Server(eng) as srv:
            handles = [srv.submit(Request(prompt=p, max_new_tokens=32,
                                          stream=events[i].append))
                       for i, p in enumerate(prompts[:4])]
            # the rest arrive while the first drain runs
            deadline = time.perf_counter() + 60
            while not events[0] and not handles[0].done:
                assert time.perf_counter() < deadline, "no stream event"
                time.sleep(0.001)
            handles += [srv.submit(Request(prompt=p, max_new_tokens=32,
                                           stream=events[4 + i].append))
                        for i, p in enumerate(prompts[4:8])]
            results = [h.result(timeout=60) for h in handles]
        sst = srv.stats()["server"]     # after stop(): the drains counted
        for ev, res in zip(events, results):
            *toks, last = ev
            assert [e.token for e in toks] == res.tokens
            assert [e.index for e in toks] == list(range(len(toks)))
            assert last.finished and last.token is None
            assert last.finish_reason == res.finish_reason
        assert sst["served"] == 8 and sst["failed_drains"] == 0, sst
        return {"requests": 8, "streams_equal_results": True,
                "server": sst}, [eng]
    measured("e_server", server)

    # f. float32 exactness (full width, 2 layers, fma flash)
    m32, p32, prompts32 = ctx["m32"], ctx["p32"], ctx["prompts32"]
    want = generate_per_prompt(m32, p32, prompts32, 8, max_len=512)
    cfg32 = dict(max_batch=4, max_len=512, decode_chunk=8,
                 capacity_tokens=8192)
    f = {}
    got = Engine(m32, p32, ServeConfig(scheduler="wave", **cfg32)).generate(
        prompts32, 8)
    assert got == want, ("wave f32", got, want)
    f["wave_equal_oracle"] = True
    rng32 = np.random.default_rng(2)
    pre32 = rng32.integers(0, vocab, size=256).tolist()
    cold32 = prefix_traffic(rng32, vocab, pre32, None)
    warm32 = prefix_traffic(rng32, vocab, pre32, cold32)
    eng = Engine(m32, p32, ServeConfig(page_size=16, **cfg32))
    for name, traffic in (("cold", cold32), ("warm", warm32)):
        got = [r.tokens for r in drain(eng, Request, traffic, 8)]
        want_t = generate_per_prompt(m32, p32, traffic, 8, max_len=512)
        assert got == want_t, (f"prefix cache f32 {name}", got, want_t)
        f[f"prefix_cache_{name}_equal_oracle"] = True
    pc = eng.stats()["prefix_cache"]
    assert pc["hits_full"] >= 4 and pc["hits_partial"] >= 7, pc
    f["prefix_cache_hits"] = {k: pc[k] for k in ("hits_full",
                                                 "hits_partial", "misses")}
    m32q = build_model(dataclasses.replace(m32.cfg, kv_quant=True))
    got = Engine(m32q, p32, ServeConfig(**cfg32)).generate(prompts32, 8)
    want_q = generate_per_prompt(m32q, p32, prompts32, 8, max_len=512)
    assert got == want_q, ("int8 f32", got, want_q)
    f["int8_wave_equal_int8_oracle"] = True
    f["int8_tokens_equal_plain_oracle_share"] = float(np.mean(
        [x == y for x, y in zip(want_q, want)]))
    out["f_float32"] = f
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase: serve_moe
# ---------------------------------------------------------------------------

def ragged_batch(torch, prompts):
    """The engine's prefill layout of ``prompts``: right-aligned tokens and
    per-row ``kv_start``, on the card."""
    import numpy as np

    from repro_torch.serve.engine import _bucket_len
    plen = _bucket_len(max(len(p) for p in prompts))
    toks = np.zeros((len(prompts), plen), np.int32)
    ks = np.zeros(len(prompts), np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
        ks[i] = plen - len(p)
    return {"tokens": torch.from_numpy(toks).cuda(),
            "kv_start": torch.from_numpy(ks).cuda()}


def first_layer_drops(torch, model, params, batch):
    """Slots the first MoE layer drops in one batched ragged prefill,
    computed with the port's own routing (``moe._route_group``) on the
    layer's real input: (real-token slots dropped, real-token slots, pad
    slots dropped, capacity)."""
    from repro_torch.core import matmul
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg = model.cfg
    tokens, kv_start = batch["tokens"], batch["kv_start"]
    plen = tokens.shape[1]
    with torch.no_grad():
        x = T._embed(cfg, params, tokens)
        bp = T._layer(params["blocks"], 0)
        h, _ = L.attention(
            bp["attn"], L.apply_norm(bp["ln1"], x, eps=cfg.norm_eps),
            T.attn_dims(cfg), positions=T._ragged_positions(plen, kv_start),
            rope_theta=cfg.rope_theta, attn_impl=cfg.attention_impl,
            kv_start=kv_start)
        y_in = L.apply_norm(bp["ln2"], x + h, eps=cfg.norm_eps)
        cap = M.capacity(plen, cfg.num_experts, cfg.experts_per_token,
                         cfg.moe_capacity_factor)
        _, (_, _, keep, _) = M._route_group(
            y_in, matmul(y_in, bp["moe"]["router"]),
            top_k=cfg.experts_per_token, num_experts=cfg.num_experts, cap=cap)
    real = (torch.arange(plen, device="cuda")[None, :] >= kv_start[:, None]
            ).repeat_interleave(cfg.experts_per_token, dim=1)
    return (int((~keep & real).sum()), int(real.sum()),
            int((~keep & ~real).sum()), cap)


def expert_einsum_case(torch, timers, model, params, b, cap, label):
    """Device time of one layer's three expert einsums at (E, B, C) slots,
    as ``moe_layer`` calls them (bf16 operands, f32 results through
    ``torch.bmm(..., out_dtype=float32)``), against the bytes bound (each
    weight stack read once) and the upcast form the port used before (f32
    copies of every operand, ``torch.einsum``)."""
    from repro_torch.core import einsum
    from repro_torch.models import transformer as T
    cfg = model.cfg
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    w = T._layer(params["blocks"], 0)["moe"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    buf = torch.randn(e, b, cap, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    hid = torch.randn(e, b, cap, f, generator=gen, device="cuda").to(
        torch.bfloat16)

    def run(fn):
        return lambda: (fn("ebcd,edf->ebcf", buf, w["w_gate"]),
                        fn("ebcd,edf->ebcf", buf, w["w_up"]),
                        fn("ebcf,efd->ebcd", hid, w["w_down"]))
    got = run(einsum)()
    upcast = run(lambda sub, *ops: torch.einsum(
        sub, *(o.float() for o in ops)))
    want = upcast()
    torch.cuda.synchronize()
    assert all(g.dtype == torch.float32 for g in got)
    err = max((g - r).abs().max().item() for g, r in zip(got, want))
    slots = e * b * cap
    nbytes = 3 * e * d * f * 2 + slots * (d + f) * 2 + slots * (2 * f + d) * 4
    b_ms, b_by = bound(3 * 2.0 * slots * d * f, nbytes, "bfloat16")
    timer, device_timer = timers
    ms = device_timer(run(einsum))
    return {"case": label, "slots": [e, b, cap], "max_abs_err_vs_upcast": err,
            "device_ms": ms, "ms": timer(run(einsum)),
            "upcast_device_ms": device_timer(upcast), "bound_ms": b_ms,
            "bound_by": b_by, "share_of_bound_device": b_ms / ms}


def free_card(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def family_phase_setup(torch, ctx, arch):
    """Free what the earlier phases left on the card, then build ``arch`` at
    full width in bf16 (flash prefill) with seeded random weights; the
    serve phase's 12 prompts and serve_features b's prefix traffic at its
    vocabulary.  Returns (out line, cfg, model, params, prompts, cold, warm,
    numpy generator)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model

    ctx.clear()
    free_card(torch)
    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16",
                              attention_impl="flash")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    out = {"card": torch.cuda.get_device_name(0), "model": cfg.name,
           "dtype": cfg.dtype, "params": model.param_count(),
           "init_seconds": time.perf_counter() - t0,
           "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    vocab = cfg.vocab_size
    rng = np.random.default_rng(0)
    lens = rng.integers(5, 301, size=12)
    prompts = [rng.integers(0, vocab, size=int(n)).tolist() for n in lens]
    prng = np.random.default_rng(1)
    prefix = prng.integers(0, vocab, size=256).tolist()
    cold = prefix_traffic(prng, vocab, prefix, None)
    warm = prefix_traffic(prng, vocab, prefix, cold)
    return out, cfg, model, params, prompts, cold, warm, rng


def serve_runs(torch, out, model, params, prompts, cold, warm, extra=None):
    """Continuous, wave, then continuous with the prefix-cache traffic (cold
    then warm on one engine), each run twice on fresh engines with the
    launch counts set to 0 before each run: every GEMM on decode or wgmma,
    every prefill attention on the wgmma flash kernel, one host transfer
    per chunk or wave, 32 in-vocabulary tokens a request, equal tokens on
    repeat.  ``extra``: each drain's ``extra_inputs`` (row i for request
    i), with which the prefix cache is not consulted (no hit); without
    them the warm drain must make >= 4 full and >= 7 partial hits, each full
    hit's first token equal to its cold one.  The ssm family (no
    attention) runs the 12 requests and the prefix traffic on the wave
    scheduler it is forced onto, without flash launches and with the
    prefix cache off."""
    from repro_torch import kernels
    from repro_torch.serve import Engine, Request, ServeConfig
    vocab = model.cfg.vocab_size
    ssm = model.cfg.family == "ssm"

    def generate(eng):
        return (eng.generate(prompts, 32, extra_inputs=extra),
                sum(len(p) for p in prompts))

    warm_seen = {}

    def prefix_cache(eng):
        cold_res = drain(eng, Request, cold, 32, extra)
        before = dict(eng.stats()["prefix_cache"])
        warm_res = drain(eng, Request, warm, 32, extra)
        after = eng.stats()["prefix_cache"]
        warm_seen["hits"] = {k: after[k] - before[k] for k in
                             ("hits_full", "hits_partial", "misses")}
        first_cold = {tuple(p): r.tokens[0] for p, r in zip(cold, cold_res)}
        full = [(p, r) for p, r in zip(warm, warm_res)
                if r.prefix_hit == "full"]
        warm_seen["full_hit_first_tokens_equal_cold"] = all(
            r.tokens[0] == first_cold[tuple(p)] for p, r in full)
        return ([r.tokens for r in cold_res + warm_res],
                sum(len(p) for p in cold + warm))

    # the ssm family's engine asked for the default continuous scheduler
    # runs the wave one (forced)
    runs = ((("wave", generate, {}),) if ssm else
            (("continuous", generate, {}),
             ("wave", generate, {"scheduler": "wave"})))
    runs += (("prefix_cache", prefix_cache, {"page_size": 16}),)
    for name, traffic, kw in runs:
        res, toks = {}, []
        for rep in range(2):
            eng = Engine(model, params, ServeConfig(
                max_batch=8, max_len=1024, decode_chunk=8, profile=True, **kw))
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got, prompt_toks = traffic(eng)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            gemm = kernels.gemm_launches_by_path()
            flash = kernels.flash_launches_by_path()
            st = eng.stats()
            assert gemm["decode"] > 0 and gemm["wgmma"] > 0, (name, gemm)
            assert gemm["wmma"] == gemm["fma"] == gemm["simt"] == 0, \
                (name, gemm)
            if ssm:
                assert sum(flash.values()) == 0, (name, flash)
                assert st["scheduler"] == "wave", (name, st["scheduler"])
                assert st["scheduler_forced"] == "no self-attention KV cache"
            else:
                assert flash["wgmma"] > 0 and flash["fma"] == 0, (name, flash)
            assert st["device_transfers"] == st["chunks"] + st["waves"] > 0, st
            assert all(len(o) == 32 and all(0 <= t < vocab for t in o)
                       for o in got)
            toks.append(got)
            res.setdefault("walls", []).append(wall)
            res.setdefault("decode_tok_per_s_by_run", []).append(
                st["tokens_generated"] / st["decode_seconds"])
            res.setdefault("prefill_tok_per_s_by_run", []).append(
                prompt_toks / st["prefill_seconds"])
            if rep == 0:
                res.update(
                    wall_seconds=wall, prefill_seconds=st["prefill_seconds"],
                    decode_seconds=st["decode_seconds"],
                    tokens_generated=st["tokens_generated"],
                    prefill_tok_per_s=prompt_toks / st["prefill_seconds"],
                    decode_tok_per_s=st["tokens_generated"]
                    / st["decode_seconds"],
                    chunks=st["chunks"], waves=st["waves"],
                    device_transfers=st["device_transfers"],
                    scheduler=st["scheduler"],
                    scheduler_forced=st["scheduler_forced"],
                    gemm_launches_by_path=gemm, flash_launches_by_path=flash,
                    launches=kernels.launch_counts(),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
                if name == "prefix_cache":
                    pc = st["prefix_cache"]
                    if ssm:
                        assert not pc["enabled"], pc
                    if extra or ssm:
                        assert pc["hits_full"] + pc["hits_partial"] == 0, pc
                    else:
                        hits = warm_seen["hits"]
                        assert hits["hits_full"] >= 4, hits
                        assert hits["hits_partial"] >= 7, hits
                        assert warm_seen["full_hit_first_tokens_equal_cold"]
                        res["warm"] = dict(warm_seen)
                    res["prefix_cache"] = {k: pc[k] for k in (
                        "hits_full", "hits_partial", "misses")}
            del eng
        assert toks[0] == toks[1], f"{name}: tokens differ on repeat"
        res["tokens_equal_on_repeat"] = True
        out[name] = res


def finite_prefill(torch, model, params, prompts, extra=None):
    """One batched ragged prefill of ``prompts``: (V,) logits a row, all
    finite.  Returns the batch."""
    batch = ragged_batch(torch, prompts)
    batch.update(extra or {})
    with torch.no_grad():
        logits, _ = model.prefill(params, batch, model.init_cache(
            len(prompts), batch["tokens"].shape[1], device="cuda"))
    torch.cuda.synchronize()
    assert tuple(logits.shape) == (len(prompts), model.cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), "non-finite prefill logits"
    return batch


def f32_exactness(torch, cfg32, rng, extra_fn=None,
                  schedulers=("continuous", "wave")):
    """Full width at ``cfg32``'s depth in float32 (flash through the fma
    kernel): the engines' tokens on each of ``schedulers`` equal the
    per-prompt oracle's for 6 prompts of 5-200 tokens."""
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig, generate_per_prompt
    m32 = build_model(cfg32)
    p32 = m32.init(seed=1, device="cuda")
    prompts32 = [rng.integers(0, cfg32.vocab_size, size=int(n)).tolist()
                 for n in (5, 37, 11, 200, 64, 130)]
    extra = extra_fn(len(prompts32)) if extra_fn else None
    want = generate_per_prompt(m32, p32, prompts32, 8, max_len=512,
                               extra_inputs=extra)
    f = {"layers": cfg32.num_layers, "requests": len(prompts32)}
    for sched in schedulers:
        eng = Engine(m32, p32, ServeConfig(
            max_batch=4, max_len=512, decode_chunk=8, scheduler=sched))
        got = eng.generate(prompts32, 8, extra_inputs=extra)
        assert got == want, (f"{cfg32.name} f32 {sched}", got, want)
        f[f"{eng.stats()['scheduler']}_equal_oracle"] = True
    del p32, extra
    free_card(torch)
    return f


def phase_serve_moe(torch, ctx):
    """Full-width olmoe-1b-7b (64 experts, top-8, MHA at d = 128) in bf16
    with flash prefill through ``serve_runs``; then the first layer's drops
    at cf 1.25, the expert einsums' time, and a float32 pass (full width, 2
    layers, cf 8.0, where no slot can drop)."""
    import dataclasses

    out, cfg, model, params, prompts, cold, warm, rng = family_phase_setup(
        torch, ctx, "olmoe-1b-7b")
    out = {"phase": "serve_moe", **out}
    serve_runs(torch, out, model, params, prompts, cold, warm)
    batch = finite_prefill(torch, model, params, prompts[:8])
    real_dropped, real_slots, pad_dropped, cap = first_layer_drops(
        torch, model, params, batch)
    out["first_layer_drops_cf1.25"] = {
        "plen": int(batch["tokens"].shape[1]), "capacity": cap,
        "real_slots_dropped": real_dropped, "real_slots": real_slots,
        "pad_slots_dropped": pad_dropped}
    timers = (Timer(torch), Timer(torch, device_only=True))
    out["expert_einsums"] = [
        expert_einsum_case(torch, timers, model, params, 8, 8,
                           "decode (B=8, C=8)"),
        expert_einsum_case(torch, timers, model, params, 8, cap,
                           f"prefill (B=8, C={cap})")]
    del params, batch
    free_card(torch)
    out["f32_pass"] = f32_exactness(torch, dataclasses.replace(
        cfg, dtype="float32", num_layers=2, moe_capacity_factor=8.0), rng)
    out["f32_pass"]["capacity_factor"] = 8.0
    emit(out)
    return out


def image_embeds(torch, cfg, n: int, seed: int, dtype):
    """Seeded random image embeddings (n, N_img, D), drawn on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return {"image_embeds": torch.randn(
        n, cfg.num_image_tokens, cfg.d_model, generator=gen,
        device="cuda").to(dtype)}


def phase_serve_vlm(torch, ctx):
    """Full-width llama-3.2-vision-11b (8 units of 4 self layers and a cross
    layer over 1601 image tokens) in bf16 with flash prefill and seeded
    random image embeddings through ``serve_runs`` (the prefix cache is not
    consulted with extra inputs); then a float32 pass at full width and one
    unit (5 layers)."""
    import dataclasses

    out, cfg, model, params, prompts, cold, warm, rng = family_phase_setup(
        torch, ctx, "llama-3.2-vision-11b")
    out = {"phase": "serve_vlm", **out}
    extra = image_embeds(torch, cfg, 12, 0, torch.bfloat16)
    serve_runs(torch, out, model, params, prompts, cold, warm, extra)
    finite_prefill(torch, model, params, prompts[:8],
                   {k: v[:8] for k, v in extra.items()})
    del params, extra
    free_card(torch)
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=cfg.cross_attn_period)
    out["f32_pass"] = f32_exactness(
        torch, cfg32, rng,
        lambda n: image_embeds(torch, cfg32, n, 1, torch.float32))
    emit(out)
    return out


def phase_serve_stablelm(torch, ctx):
    """stablelm-12b at full width (head dim 160) and 2 layers in bf16 with
    flash prefill: the 12 requests, 8 new tokens each, through the decode /
    wgmma GEMMs and the wgmma flash kernel at d 160; then a float32 pass (2
    layers) equal to the per-prompt oracle."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    ctx.clear()
    free_card(torch)
    cfg = dataclasses.replace(get_config("stablelm-12b"), dtype="bfloat16",
                              attention_impl="flash", num_layers=2)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(5, 301, size=12)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    eng = Engine(model, params, ServeConfig(max_batch=8, max_len=1024,
                                            decode_chunk=8, profile=True))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, 8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gemm = kernels.gemm_launches_by_path()
    flash = kernels.flash_launches_by_path()
    st = eng.stats()
    assert all(len(o) == 8 and all(0 <= t < cfg.vocab_size for t in o)
               for o in outs)
    assert gemm["decode"] > 0 and gemm["wgmma"] > 0, gemm
    assert gemm["wmma"] == gemm["fma"] == gemm["simt"] == 0, gemm
    assert flash["wgmma"] > 0 and flash["fma"] == 0, flash
    assert st["device_transfers"] == st["chunks"], st
    out = {"phase": "serve_stablelm", "card": torch.cuda.get_device_name(0),
           "model": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
           "head_dim": cfg.resolved_head_dim, "params": model.param_count(),
           "continuous": {
               "wall_seconds": wall, "prefill_seconds": st["prefill_seconds"],
               "decode_seconds": st["decode_seconds"],
               "prefill_tok_per_s": float(lens.sum()) / st["prefill_seconds"],
               "gemm_launches_by_path": gemm, "flash_launches_by_path": flash,
               "launches": kernels.launch_counts()}}
    finite_prefill(torch, model, params, prompts[:8])
    del eng, params
    free_card(torch)
    out["f32_pass"] = f32_exactness(torch, dataclasses.replace(
        cfg, dtype="float32"), rng)
    emit(out)
    return out


def encoder_embeds(torch, cfg, n: int, seed: int, dtype):
    """Seeded random frame embeddings (n, enc_len, D), drawn on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return {"encoder_embeds": torch.randn(
        n, cfg.encoder_len, cfg.d_model, generator=gen,
        device="cuda").to(dtype)}


def encoder_share(torch, model, params, batch):
    """Device time of the encoder over ``batch``'s frames against that of
    the whole batched prefill (encoder, cross K/V, decoder, unembed): each
    the mean of 3 runs after one warm-up, timed with CUDA events."""
    from repro_torch.models import transformer as T
    cfg = model.cfg

    def timed(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 3

    cache = model.init_cache(batch["tokens"].shape[0],
                             batch["tokens"].shape[1], device="cuda")
    with torch.no_grad():
        enc_ms = timed(lambda: T._run_encoder(cfg, params,
                                              batch["encoder_embeds"]))
        prefill_ms = timed(lambda: model.prefill(params, batch, cache))
    return {"encoder_ms": enc_ms, "prefill_ms": prefill_ms,
            "encoder_share": enc_ms / prefill_ms,
            "plen": int(batch["tokens"].shape[1])}


def phase_serve_audio(torch, ctx):
    """Full-width whisper-large-v3 (32 + 32 layers, 20 heads at d = 64, the
    K-major head at N = 51866) in bf16 with flash prefill and seeded random
    frame embeddings through ``serve_runs`` (the prefix cache is not
    consulted with extra inputs); the encoder's share of a batched
    prefill; then a float32 pass at full width and 2 + 2 layers."""
    import dataclasses

    out, cfg, model, params, prompts, cold, warm, rng = family_phase_setup(
        torch, ctx, "whisper-large-v3")
    out = {"phase": "serve_audio", **out}
    extra = encoder_embeds(torch, cfg, 12, 0, torch.bfloat16)
    serve_runs(torch, out, model, params, prompts, cold, warm, extra)
    batch = finite_prefill(torch, model, params, prompts[:8],
                           {k: v[:8] for k, v in extra.items()})
    out["encoder_share_of_prefill"] = encoder_share(torch, model, params,
                                                    batch)
    del params, extra, batch
    free_card(torch)
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=2,
                                encoder_layers=2)
    out["f32_pass"] = f32_exactness(
        torch, cfg32, rng,
        lambda n: encoder_embeds(torch, cfg32, n, 1, torch.float32))
    emit(out)
    return out


def phase_serve_ssm(torch, ctx):
    """Full-width mamba2-130m (24 Mamba2 layers, d 768, state 128, the tied
    head over 50280 tokens) in bf16 through ``serve_runs``: the 12 requests
    and the prefix traffic on the wave scheduler it is forced onto; finite
    logits of one batched ragged prefill; then a float32 pass at full width
    and 2 layers whose wave tokens equal the per-prompt oracle's."""
    import dataclasses

    out, cfg, model, params, prompts, cold, warm, rng = family_phase_setup(
        torch, ctx, "mamba2-130m")
    out = {"phase": "serve_ssm", "main_run": "wave", **out}
    serve_runs(torch, out, model, params, prompts, cold, warm)
    finite_prefill(torch, model, params, prompts[:8])
    del params
    free_card(torch)
    out["f32_pass"] = f32_exactness(torch, dataclasses.replace(
        cfg, dtype="float32", num_layers=2), rng, schedulers=("wave",))
    emit(out)
    return out


def phase_serve_hybrid(torch, ctx):
    """Full-width zamba2-2.7b (9 units of 6 Mamba2 layers, d 2560, state
    64, and the one shared attention block at head dim 80) in bf16 with
    flash prefill through ``serve_runs`` (the SSM and conv states are
    resident fixed leaves of the continuous engine and the prefix cache's
    full hits restore them); finite logits of one batched ragged prefill;
    then a float32 pass at full width and one unit (6 Mamba2 layers and
    the shared block) whose continuous and wave tokens equal the
    per-prompt oracle's."""
    import dataclasses

    out, cfg, model, params, prompts, cold, warm, rng = family_phase_setup(
        torch, ctx, "zamba2-2.7b")
    out = {"phase": "serve_hybrid", "head_dim": cfg.resolved_head_dim, **out}
    serve_runs(torch, out, model, params, prompts, cold, warm)
    finite_prefill(torch, model, params, prompts[:8])
    del params
    free_card(torch)
    out["f32_pass"] = f32_exactness(torch, dataclasses.replace(
        cfg, dtype="float32", num_layers=cfg.attn_period), rng)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase: examples
# ---------------------------------------------------------------------------

#: the port's examples and prefix smoke, by file; the phase imports each
#: and calls its step functions (so launch counts split by step)
EXAMPLE_FILES = {
    "quickstart": "examples/torch_quickstart.py",
    "autotune": "examples/torch_autotune_and_serve.py",
    "recovery": "examples/torch_train_with_failure_recovery.py",
    "prefix_smoke": "scripts/torch_prefix_cache_smoke.py",
}
#: the recovery example's depth on the card: a ~4.6 GB checkpoint
RECOVERY_LAYERS = 2


def load_file(name: str):
    """Import one of ``EXAMPLE_FILES`` by path (they are scripts)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_chip_{name}", os.path.join(HERE, EXAMPLE_FILES[name]))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counted(torch, fn):
    """``fn()`` with the launch counts from 0 just before: (its result,
    K1's launches by path, K2's)."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    res = fn()
    torch.cuda.synchronize()
    return res, kernels.gemm_launches_by_path(), \
        kernels.flash_launches_by_path()


def example_quickstart(torch, mod, dev):
    """The quickstart at full width and depth: the measured 4096^3 sweep
    (its winner resolves ``exact``), 30 train steps (K1 by the train
    formula), the serve (decode and wgmma only)."""
    from repro_torch.models import build_model
    res, lookup = mod.tune(dev)
    cfg = mod.model_config()
    model = build_model(cfg)
    (state, losses), g_train, f_train = counted(
        torch, lambda: mod.train(model, dev))
    outs, g_serve, f_serve = counted(
        torch, lambda: mod.serve(model, state.params, dev))
    steps = len(losses)
    want = TRAIN_PHASES["train"]["wgmma"](cfg) * steps
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "sweep": {"shape": list(res.shape), "winner": res.best.config
                     .schedule, "source": res.best.source,
                     "tflops": res.best.gflops / 1e3,
                     "evaluated": res.evaluated,
                     "candidates": res.candidates_total,
                     "lookup": lookup.source},
           "losses": losses, "train_gemm_launches_by_path": g_train,
           "train_flash_launches_by_path": f_train,
           "train_wgmma_expected": want, "tokens": outs,
           "serve_gemm_launches_by_path": g_serve,
           "serve_flash_launches_by_path": f_serve}
    assert res.best.source.startswith("measure") and \
        lookup.source == "exact" and lookup.config == res.best.config, out
    assert steps == 30 and all(math.isfinite(x) for x in losses), losses
    assert g_train["wgmma"] == want and g_train["simt"] == 2 * steps, out
    assert g_train["fma"] == 0, g_train
    assert g_train["decode"] == g_train["wmma"] == 0, g_train
    assert sum(f_train.values()) == 0, f_train
    assert [len(o) for o in outs] == [8, 8] and all(
        0 <= t < cfg.vocab_size for o in outs for t in o), outs
    assert g_serve["decode"] > 0 and g_serve["wmma"] == g_serve["fma"] \
        == g_serve["simt"] == 0, g_serve
    return out


def example_autotune(torch, mod, dev):
    """The autotune example at full width: two targets persisted and
    reloaded, every captured GEMM shape and the prefill flash problem
    measured into the registry, then a serve whose every decode GEMM and
    prefill flash lookup is ``exact``; the committed table untouched."""
    from repro_torch.models import build_model
    before = mod.committed_table_hash()
    results, reloaded = mod.tune_two_targets(dev)
    cfg = mod.model_config()
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    shapes = mod.capture_shapes(model, params, dev)
    tuned, flash = mod.tune_captured(shapes, cfg, dev)
    (outs, st), g_serve, f_serve = counted(
        torch, lambda: mod.serve(model, params, dev))
    after = mod.committed_table_hash()
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "targets": {hw: {"winner": r.best.config.schedule,
                            "source": r.best.source,
                            "tflops": r.best.gflops / 1e3}
                       for hw, r in results},
           "reloaded": reloaded, "shapes": len(shapes),
           "tuned": {"x".join(map(str, s)): v for s, v in tuned.items()},
           "flash": {"winner": flash.best.config.schedule,
                     "source": flash.best.source},
           "decode_tile_lookups": st["decode_tile_lookups"],
           "prefill_flash_lookups": st["prefill_flash_lookups"],
           "not_exact": mod.not_exact(st), "tokens": outs,
           "serve_gemm_launches_by_path": g_serve,
           "serve_flash_launches_by_path": f_serve,
           "table_sha256": after, "table_unchanged": after == before}
    assert reloaded == 2 and results[0][1].best.source.startswith(
        "measure"), out
    assert st["decode_tile_lookups"] and st["prefill_flash_lookups"], out
    assert not out["not_exact"] and out["table_unchanged"], out
    assert g_serve["wmma"] == g_serve["fma"] == g_serve["simt"] == 0 and \
        f_serve["fma"] == 0 and f_serve["wgmma"] > 0, out
    return out


def example_recovery(torch, mod, dev):
    """The recovery example at full width and ``RECOVERY_LAYERS`` layers:
    20 steps, a checkpoint at 10 under ``build/``, the restore and replay
    bit for bit; the checkpoint removed after."""
    import shutil
    from repro_torch.models import build_model
    cfg = mod.model_config(layers=RECOVERY_LAYERS)
    model = build_model(cfg)
    ckdir = os.path.join(HERE, "build", "examples_checkpoint")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    try:
        (latest, diff, losses), g, f = counted(
            torch, lambda: mod.run(model, dev, ckdir))
        ckpt_gb = sum(os.path.getsize(os.path.join(d, n))
                      for d, _s, names in os.walk(ckdir)
                      for n in names) / 1e9
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    steps = mod.STEPS + mod.STEPS - mod.SAVE_AT
    want = TRAIN_PHASES["train"]["wgmma"](cfg) * steps
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "latest_checkpoint": latest, "checkpoint_gb": ckpt_gb,
           "max_param_diff": diff, "replayed_losses": losses,
           "gemm_launches_by_path": g, "flash_launches_by_path": f,
           "wgmma_expected": want}
    assert latest == mod.SAVE_AT and diff == 0.0, out
    assert g["wgmma"] == want and g["simt"] == 2 * steps, out
    assert g["fma"] == 0, g
    return out


def example_prefix_smoke(torch, mod, dev):
    """``torch_prefix_cache_smoke --full``: every assertion holds."""
    path = os.path.join(HERE, "build", "prefix_smoke_stats.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rc, g, f = counted(torch, lambda: mod.main(["--full", "--json", path]))
    with open(path) as fh:
        pc = json.load(fh)["prefix_cache"]
    out = {"rc": rc, "prefix_cache": pc, "gemm_launches_by_path": g,
           "flash_launches_by_path": f}
    assert rc == 0, out
    assert g["wmma"] == g["fma"] == g["simt"] == 0 and sum(g.values()) > 0, out
    return out


def example_analyzer(torch, mod, dev):
    """``python -m repro_torch.analysis report`` in a fresh process on
    this machine: exit 0, JAX never imported."""
    code = ("import sys\nfrom repro_torch.analysis.cli import main\n"
            "rc = main(['report'])\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=300)
    tail = proc.stdout.strip().splitlines()[-2:]
    out = {"rc": proc.returncode, "summary": tail}
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return out


def phase_examples(torch, ctx):
    """The port's three examples and its prefix smoke on the card, each
    imported and driven through its step functions, then the static
    checker in a fresh process.  Each part's seconds and peak memory are
    in the line; its launches by path are its own, apart from the main
    paths' totals.  The registry is put back to the committed table after
    (the examples' sweeps land in it)."""
    from repro_torch.core import GLOBAL_REGISTRY, tuning_db
    ctx.clear()
    free_card(torch)
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    out = {"phase": "examples", "card": torch.cuda.get_device_name(0),
           "nvidia_smi": smi()}
    parts = (("quickstart", example_quickstart),
             ("autotune", example_autotune),
             ("recovery", example_recovery),
             ("prefix_smoke", example_prefix_smoke),
             ("analyzer", example_analyzer))
    try:
        for name, run in parts:
            mod = load_file(name) if name in EXAMPLE_FILES else None
            free_card(torch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = run(torch, mod, dev)
            torch.cuda.synchronize()
            out[name] = dict(res, seconds=time.perf_counter() - t0,
                             peak_mem_gb=torch.cuda.max_memory_allocated()
                             / 1e9)
    finally:
        GLOBAL_REGISTRY.clear()
        tuning_db.load_all(GLOBAL_REGISTRY, strict=True)
        free_card(torch)
        out["seconds"] = time.perf_counter() - t_phase
        emit(out)
    return out


# ---------------------------------------------------------------------------
# phase: train
# ---------------------------------------------------------------------------

#: the train phases, each a model at full width in bf16: its depth cut
#: (``cut``, config overrides; {} for full depth), batch rows x tokens a
#: row, steps, the step whose checkpoint the run resumes from (None: no
#: resume), the f32 step's depth (``f32_cut``) and K1's wgmma launches a
#: step for the cut config: every product's forward, remat recompute, dX
#: and dW, and the unembed's forward (its dX and dW are the step's two simt
#: launches).  A dense layer has 7 products (28 launches); whisper's
#: encoder layer 6 (24) and decoder layer 10 with its cross K/V (40); a
#: Mamba2 layer 2 (8); zamba2's shared block 7 an application (28); a vlm
#: cross layer 7, whose K/V projections of the image embeddings need no dX
#: (26).
TRAIN_PHASES = {
    # also under remat_policy="dots": K1's 7 forward outputs a layer kept,
    # so the backward launches 21 a layer (dX, dW, the 7 forward before it)
    "train": dict(
        arch="llama3.2-1b", cut={}, batch=(8, 512), steps=6, save_at=3,
        f32_cut=dict(num_layers=2),
        wgmma=lambda c: 28 * c.num_layers + 1,
        dots_wgmma=lambda c: 21 * c.num_layers + 1),
    "train_audio": dict(
        arch="whisper-large-v3", cut={}, batch=(8, 512), steps=4, save_at=2,
        f32_cut=dict(num_layers=2, encoder_layers=2),
        wgmma=lambda c: 24 * c.encoder_layers + 40 * c.num_layers + 1),
    "train_ssm": dict(
        arch="mamba2-130m", cut={}, batch=(8, 512), steps=4, save_at=None,
        f32_cut=dict(num_layers=2),
        wgmma=lambda c: 8 * c.num_layers + 1),
    # 2 of 9 units: the full depth's 2.42 B parameters are ~34 GB of
    # state, which the update doubles
    "train_hybrid": dict(
        arch="zamba2-2.7b", cut=dict(num_layers=12), batch=(8, 512),
        steps=3, save_at=None, f32_cut=dict(num_layers=6), f32_spread=True,
        wgmma=lambda c: 28 * (c.num_layers // c.attn_period)
        + 8 * c.num_layers + 1),
    # 1 of 8 units (4 self layers and the cross layer, 2.14 B parameters):
    # the full depth's 9.78 B are ~137 GB of state.  Its f32 step keeps 1
    # self and the cross layer: one unit's 34 GB of f32 state, doubled by
    # the update, does not fit the card
    "train_vlm": dict(
        arch="llama-3.2-vision-11b", cut=dict(num_layers=5), batch=(4, 512),
        steps=3, save_at=None, f32_cut=dict(num_layers=2, cross_attn_period=2),
        wgmma=lambda c: (c.num_layers // c.cross_attn_period)
        * (28 * (c.cross_attn_period - 1) + 26) + 1),
}
#: the bf16 step against the plain versions: relative tolerance of the
#: loss (a mean over 4096 tokens of bf16 activations, ~2**-9 a rounding)
#: and of the gradient norm (the kernel path also rounds each product's
#: cotangent dZ to bf16, as its bf16 operand)
TRAIN_BF16_TOL = {"loss": 5e-3, "grad_norm": 3e-2}
#: the f32 step (2 layers): loss and metrics rtol; every gradient leaf's max
#: abs error over its max abs value (summation order over K up to 128256);
#: the parameters after the step, atol = rtol, where the plain gradient is
#: at least ``grad_floor`` of its leaf's max.  AdamW's first update is
#: lr * g / (|g| + eps) an element, so where |g| is as small as the
#: gradients' own difference it can land anywhere within lr of the plain
#: one: there (and everywhere) the parameters are held within 2 lr.
TRAIN_F32_TOL = {"metrics": 1e-5, "grad": 1e-4, "param": 1e-5,
                 "grad_floor": 1e-3}
#: gradient leaves that are 0 in exact arithmetic: a key bias adds q . bk
#: to every score of a query's row, which its softmax cancels.  Both paths
#: give roundoff there, so its error over its own max is noise: each path's
#: max |g| is held within ``ZERO_GRAD_TOL`` of the tree's largest gradient.
ZERO_GRAD_LEAVES = ("/bk",)
ZERO_GRAD_TOL = 1e-6
#: a phase whose f32 step sets ``f32_spread`` (zamba2: a loss whose
#: gradients one f32 ulp of weight noise moves past 1e-4 of the leaf's max)
#: also runs the plain versions from weights times (1 + 1e-7 N(0, 1)); each
#: gradient leaf is then held within the larger of ``TRAIN_F32_TOL``'s and
#: ``SPREAD_FACTOR`` times that run's largest distance from the plain one
#: (relative to the leaf's max, over the tree)
SPREAD_FACTOR = 4


def plain_matmul(torch):
    """A context in which ``core.matmul`` is the plain version: its product
    is ``gemm_ref`` (cuBLAS in f32 on the card) under PyTorch's own
    autograd, not the autograd Function over the kernel."""
    import contextlib
    from unittest import mock

    from repro_torch.core import gemm_api
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gemm_ref

    def gemm(a, b, c=None, *, config=None, **kw):
        return gemm_ref(a, b, c, **kw)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(ops, "gemm", gemm))
    stack.enter_context(mock.patch.object(gemm_api, "_grad_needed",
                                          lambda *t: False))
    return stack


def on_fma():
    """A context in which the wrapper sends every f32 product to the
    ``fma`` kernel (the earlier f32 path and its tile), as it does for
    operands ``simt``'s vector loads cannot take."""
    from unittest import mock

    from repro_torch.kernels import gemm
    return mock.patch.object(gemm, "simt_vector_bytes", lambda *a: 0)


def grads_of(torch, model, params, batch):
    """(loss, metrics, {path: gradient}) of ``lm_loss``."""
    from repro_torch.models.params import map_tree, tree_paths
    from repro_torch.train import lm_loss
    live = map_tree(lambda _p, t: t.detach().requires_grad_(), params)
    loss, metrics = lm_loss(model, live, batch)
    paths = tree_paths(live)
    grads = torch.autograd.grad(loss, list(paths.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(paths, grads)))


def k1_split(torch, run):
    """K1's device time (ms) and launches in ``run()`` by role, timed with
    CUDA events around each launch and each of the autograd Function's
    ranges (``gemm_api.record_function``, patched here): ``forward``,
    ``forward_recompute`` (run inside the backward: remat), ``dX``,
    ``dW``, and the unembed's f32 backward products apart
    (``unembed_dX``, ``unembed_dW``); ``dX_casts`` and ``dW_copies`` are
    the rest of the dX and dW ranges' device time (the f32 casts of the
    unembed's operands, the x.T copies)."""
    import contextlib
    import threading
    from unittest import mock

    from repro_torch.core import gemm_api
    from repro_torch.kernels import ops

    tls = threading.local()
    marks = []
    real_gemm = ops.gemm

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @contextlib.contextmanager
    def role(name):
        tls.role = name.split(".", 1)[1]
        start = event()
        try:
            yield
        finally:
            marks.append((f"range {tls.role}", start, event()))
            tls.role = None

    def gemm(a, b, *args, **kw):
        start = event()
        out = real_gemm(a, b, *args, **kw)
        r = getattr(tls, "role", None)
        if r in ("dX", "dW") and a.dtype == torch.float32:
            key = f"unembed_{r}"
        elif r == "forward" and torch._C._current_graph_task_id() != -1:
            key = "forward_recompute"      # run by the backward (remat)
        else:
            key = r
        marks.append((key, start, event()))
        return out

    with mock.patch.object(gemm_api, "record_function", role), \
            mock.patch.object(ops, "gemm", gemm):
        run()
    torch.cuda.synchronize()
    ms, counts = {}, {}
    for key, start, end in marks:
        ms[key] = ms.get(key, 0.0) + start.elapsed_time(end)
        counts[key] = counts.get(key, 0) + 1
    split = {k: ms.get(k, 0.0) for k in (
        "forward", "forward_recompute", "dX", "dW", "unembed_dX",
        "unembed_dW")}
    split["dX_casts"] = ms.get("range dX", 0.0) - split["dX"] - \
        split["unembed_dX"]
    split["dW_copies"] = ms.get("range dW", 0.0) - split["dW"] - \
        split["unembed_dW"]
    return split, {k: v for k, v in counts.items() if not k.startswith("range")}


def dots_run(torch, cfg, opt, pipe, tcfg, tokens: int, full_history):
    """``cfg``'s steps again from the same seed and data under
    ``remat_policy="dots"`` (K1's forward outputs saved, the rest
    recomputed): its losses and whether they equal ``full_history``'s
    bit for bit, step walls, peak memory and K1's launches by path from 0;
    then K1 by role in one more step (``k1_split``, whose
    ``forward_recompute`` must stay 0)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.train import Trainer, init_train_state, make_train_step

    model = build_model(dataclasses.replace(cfg, remat_policy="dots"))
    held = [init_train_state(model, opt, 0, device="cuda")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    trainer = Trainer(model, opt, pipe, tcfg)
    state, history = run_from(trainer, held)
    torch.cuda.synchronize()
    walls = trainer.step_walls
    out = {"remat_policy": "dots", "losses": [l for _, l in history],
           "losses_bit_equal_full": history == full_history,
           "step_walls": walls,
           "tok_per_s_warm": tokens * (len(walls) - 1) / sum(walls[1:]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "gemm_launches_by_path": kernels.gemm_launches_by_path(),
           "flash_launches_by_path": kernels.flash_launches_by_path()}
    step = make_train_step(model, opt)
    batch = pipe(1)
    split, counts = k1_split(torch, lambda: step(state, batch))
    out.update(k1_device_ms_by_role=split, k1_launches_by_role=counts)
    del state, held, trainer
    free_card(torch)
    return out


def train_extras(torch, cfg, n: int, step: int, dtype):
    """A train batch's extra inputs at ``step``: seeded image embeddings
    (vlm) or frame embeddings (audio), n rows; none for the other
    families."""
    if cfg.family == "vlm":
        return image_embeds(torch, cfg, n, 1000 + step, dtype)
    if cfg.family == "audio":
        return encoder_embeds(torch, cfg, n, 1000 + step, dtype)
    return {}


def run_from(trainer, held: list, start_step: int = 0):
    """``trainer.run`` from the state in the one-element list ``held``,
    which it empties: no frame here keeps that state, so the run frees each
    step's input once it has the next and two states are live at most.  A
    caller that kept its own reference would hold a third from the second
    step on."""
    return trainer.run(held.pop(), start_step=start_step)


def phase_train(torch, ctx, phase: str = "train"):
    """One train phase of ``TRAIN_PHASES``: its model at full width in bf16
    (seeded weights, the chunked attention path as the reference trains,
    remat) on the synthetic pipeline, seeded extra inputs beside the tokens
    (vlm, audio).  Its steps through ``Trainer``; with ``save_at``, a
    checkpoint there, then the steps after it again from the checkpoint in
    a fresh state: equal losses and parameters, bit for bit.  K1's launches
    by path over the steps (every bf16 product on wgmma; simt only at the
    unembed's two f32-cotangent products a step, fma none; K2 none); every
    gradient leaf finite in every step.  Then one bf16 step against the plain
    versions, one f32 step at ``f32_cut`` against them (loss, every
    gradient leaf, every parameter after the step), and one timed step:
    K1's device time by role (``k1_split``), the GEMM shapes the step
    issues and their registry provenance."""
    import contextlib
    import dataclasses
    import shutil
    import warnings
    from unittest import mock

    from repro_torch import kernels
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.catalog import get_config
    from repro_torch.core import GLOBAL_REGISTRY, capture_gemm_shapes
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.models.params import map_tree, tree_paths
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.profiling import annotate
    from repro_torch.train import (Trainer, TrainerConfig,
                                   abstract_train_state, init_train_state,
                                   make_train_step)
    from repro_torch.train import trainer as trainer_mod

    spec = TRAIN_PHASES[phase]
    steps, save_at = spec["steps"], spec["save_at"]
    t_phase = time.perf_counter()
    ctx.clear()
    free_card(torch)
    cfg = dataclasses.replace(get_config(spec["arch"]), dtype="bfloat16",
                              attention_impl="chunked", remat=True,
                              **spec["cut"])
    model = build_model(cfg)
    opt = AdamW(learning_rate=warmup_cosine(1e-3, 10, steps))
    b, s = spec["batch"]
    tokens_of = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=s, global_batch=b),
                              device="cuda")

    def pipe(step, c=cfg):
        return dict(tokens_of(step), **train_extras(
            torch, c, b, step, getattr(torch, c.dtype)))
    tokens = b * s
    ckdir = os.path.join(HERE, "build", "train_checkpoint")
    out = {"phase": phase, "main_run": "run",
           "card": torch.cuda.get_device_name(0),
           "model": cfg.name, "dtype": cfg.dtype, "params":
           model.param_count(), "depth_cut": spec["cut"], "batch": [b, s],
           "extra_inputs": sorted(train_extras(torch, cfg, 1, 0,
                                               torch.bfloat16)),
           "attention_impl": cfg.attention_impl, "remat": cfg.remat_policy,
           "schedule": f"warmup_cosine(1e-3, 10, {steps})"}
    if save_at is not None:
        shutil.rmtree(ckdir, ignore_errors=True)
        os.makedirs(ckdir)
        out["disk_free_gb"] = shutil.disk_usage(ckdir).free / 1e9

    def tcfg(total, every):
        # step_deadline_s syncs each step, so step_walls holds its wall
        return TrainerConfig(total_steps=total, log_every=1,
                             checkpoint_every=every, step_deadline_s=1e9)

    # every gradient of every step, checked finite on the card (one flag a
    # step, read once at the end)
    finite = []
    real_vg = trainer_mod._value_and_grad

    def checked_vg(*a, **kw):
        loss, metrics, grads = real_vg(*a, **kw)
        finite.append(torch.stack([torch.isfinite(g).all()
                                   for g in tree_paths(grads).values()]).all())
        return loss, metrics, grads

    # index_select's backward (the embedding gradient) adds with atomics
    # on the card; a bit-equal resume needs its deterministic algorithm
    torch.use_deterministic_algorithms(True, warn_only=True)
    out["deterministic_algorithms"] = (
        "on: index_select's backward (the embedding gradient) accumulates "
        "with atomics on the card")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            # -- the steps (checkpoint at save_at; launch counts from 0) --
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            held = [init_train_state(model, opt, 0, device="cuda")]
            torch.cuda.synchronize()
            out["init_seconds"] = time.perf_counter() - t0
            out["state_gb"] = sum(
                t.numel() * t.element_size() for tree in
                (held[0].params, held[0].opt.m, held[0].opt.v,
                 held[0].opt.master)
                for t in tree_paths(tree).values()) / 1e9
            first_steps = steps if save_at is None else save_at
            ck = None
            if save_at is not None:
                assert out["disk_free_gb"] > 1.1 * out["state_gb"], (
                    "no room for the checkpoint", out["disk_free_gb"],
                    out["state_gb"])
                ck = Checkpointer(ckdir, keep=1)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with mock.patch.object(trainer_mod, "_value_and_grad",
                                   checked_vg):
                first = Trainer(model, opt, pipe, tcfg(first_steps,
                                                       first_steps),
                                checkpointer=ck)
                state, hist_a = run_from(first, held)
                run1 = time.perf_counter() - t0
                second = Trainer(model, opt, pipe, tcfg(steps, 10 ** 9))
                held = [state]
                del state
                state, hist_b = run_from(second, held, first_steps)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            gemm_paths = kernels.gemm_launches_by_path()
            flash_paths = kernels.flash_launches_by_path()
            walls = first.step_walls + second.step_walls
            history = hist_a + hist_b
            out["run"] = {"launches": launches,
                          "gemm_launches_by_path": gemm_paths,
                          "flash_launches_by_path": flash_paths}
            out.update(
                losses=[l for _, l in history], step_walls=walls,
                grads_finite_by_step=[bool(f) for f in finite],
                tok_per_s_warm=tokens * (steps - 1) / sum(walls[1:]),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if save_at is not None:
                out["checkpoint_save_seconds"] = run1 - sum(first.step_walls)
            final = {p: t for p, t in tree_paths(state.params).items()}
            del state, first, second
            free_card(torch)
            # -- resume from the checkpoint in a fresh state ---------------
            if save_at is not None:
                t0 = time.perf_counter()
                held = [ck.restore(save_at, abstract_train_state(model, opt),
                                   device="cuda")]
                torch.cuda.synchronize()
                out["checkpoint_restore_seconds"] = time.perf_counter() - t0
                assert int(held[0].step) == save_at
                out["restored_layouts_as_init"] = all(
                    t.stride() == final[p].stride()
                    for p, t in tree_paths(held[0].params).items())
                resumed, hist_r = run_from(Trainer(model, opt, pipe, tcfg(
                    steps, 10 ** 9)), held, save_at)
                out["resumed_losses"] = [l for _, l in hist_r]
                out["resume_bit_equal"] = hist_r == hist_b and all(
                    torch.equal(t, final[p])
                    for p, t in tree_paths(resumed.params).items())
                del resumed
                free_card(torch)
                shutil.rmtree(ckdir, ignore_errors=True)
            del final
            # -- the same steps under remat_policy="dots" ------------------
            if "dots_wgmma" in spec:
                out["dots"] = dots_run(torch, cfg, opt, pipe, tcfg(
                    steps, 10 ** 9), tokens, history)
            # -- one bf16 step: K1 against the plain versions, and with
            # the unembed's f32 backward on the fma kernel ----------------
            step = make_train_step(model, opt)
            batch = pipe(0)
            hold = {}
            for name in ("kernel", "fma", "plain"):
                state = init_train_state(model, opt, 0, device="cuda")
                kernels.reset_launch_counts()
                with (plain_matmul(torch) if name == "plain" else
                      on_fma() if name == "fma" else
                      contextlib.nullcontext()):
                    new, m = step(state, batch)
                hold[name] = ({k: float(m[k]) for k in ("loss", "grad_norm")},
                              kernels.launch_counts()["gemm"],
                              kernels.gemm_launches_by_path())
                del state, new, m
                free_card(torch)
            out["bf16_step_vs_plain"] = {
                "kernel": hold["kernel"][0], "plain": hold["plain"][0],
                "plain_gemm_launches": hold["plain"][1],
                "tol_rel": TRAIN_BF16_TOL}
            out["step_on_fma"] = {
                "metrics": hold["fma"][0],
                "bit_equal_simt": hold["fma"][0] == hold["kernel"][0],
                "gemm_launches_by_path": hold["fma"][2]}
            # -- one timed step: K1 by role, shapes, provenance ------------
            state = init_train_state(model, opt, 0, device="cuda")
            step(state, pipe(1))                         # warm
            lookups = {}
            real_lookup = GLOBAL_REGISTRY.lookup_op

            def lookup(op, hw, dtype, shape):
                res = real_lookup(op, hw, dtype, shape)
                lookups[(op, str(dtype).split(".")[1], tuple(shape))] = (
                    res.source, res.config.schedule)
                return res
            batch2 = pipe(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mock.patch.object(GLOBAL_REGISTRY, "lookup_op", lookup), \
                    capture_gemm_shapes(calls=True) as shapes:
                split, counts = k1_split(torch, lambda: step(state, batch2))
            out["timed_step_wall"] = time.perf_counter() - t0
            out["k1_device_ms_by_role"] = split
            out["k1_launches_by_role"] = counts
            out["step_gemm_shapes"] = sorted(
                {f"{m}x{k}x{n}{' kmajor' if km else ''} "
                 f"out {str(od).split('.')[1]}" for m, k, n, km, od in shapes})
            out["step_gemm_provenance"] = {
                f"{dt} {'x'.join(map(str, shp))}": {"source": src,
                                                    "schedule": sched}
                for (op, dt, shp), (src, sched) in sorted(lookups.items())
                if op == "gemm"}
            # -- one more warm step under profiling.trace ------------------
            def traced_step():
                with annotate("train.step"):
                    step(state, batch2)
            _, events, secs = traced(phase, traced_step)
            _, prof = profile_summary("training", events)
            MEASURED_STEPS.append({
                "label": phase, "cfg": cfg, "kind": "train",
                "calls": {(b, s): 1},
                "measured": span_times(events, "train.step"),
                "peak_mem_gb": out["peak_mem_gb"]})
            del events
            prof.update(secs)
            emit(dict({"phase": "train_profile", "train_phase": phase,
                       "card": out["card"], "model": cfg.name,
                       "batch": [b, s], "steps_traced": 1}, **prof))
            out["profile_k1_share"] = prof["k1"]["share"]
            del state, batch, batch2
            free_card(torch)
            # -- one f32 step at f32_cut against the plain versions --------
            cfg32 = dataclasses.replace(cfg, dtype="float32",
                                        **spec["f32_cut"])
            m32 = build_model(cfg32)
            b32 = pipe(3, cfg32)
            res = {}
            for name in ("kernel", "plain"):
                st = init_train_state(m32, opt, 1, device="cuda")
                with (plain_matmul(torch) if name == "plain"
                      else contextlib.nullcontext()):
                    kernels.reset_launch_counts()
                    loss, metrics, grads = grads_of(torch, m32, st.params, b32)
                    new, sm = make_train_step(m32, opt)(st, b32)
                    # the kernel run's trees wait on the host
                    keep = (lambda d: d) if name == "plain" else (
                        lambda d: {p: t.cpu() for p, t in d.items()})
                    res[name] = (loss, metrics, keep(grads),
                                 keep(tree_paths(new.params)), sm,
                                 kernels.gemm_launches_by_path())
                del st, new, grads
                free_card(torch)
            kern, plain = res["kernel"], res["plain"]
            rel = lambda a, b: abs(float(a) - float(b)) / max(  # noqa: E731
                abs(float(b)), 1e-30)
            metric_err = max([rel(kern[0], plain[0])]
                             + [rel(kern[1][k], plain[1][k]) for k in plain[1]]
                             + [rel(kern[4][k], plain[4][k]) for k in plain[4]])

            def leaf_err(g, want):
                return ((g.to(want.device) - want).abs().max()
                        / want.abs().max().clamp(min=1e-30)).item()
            top = max(g.abs().max().item() for g in plain[2].values())
            zero = {p: [kern[2][p].abs().max().item() / top,
                        g.abs().max().item() / top]
                    for p, g in plain[2].items()
                    if p.endswith(ZERO_GRAD_LEAVES)}
            grad_err = {p: leaf_err(g, plain[2][p])
                        for p, g in kern[2].items() if p not in zero}
            grad_tol = TRAIN_F32_TOL["grad"]
            spread = None
            if spec.get("f32_spread"):
                gen = torch.Generator(device="cuda").manual_seed(7)
                st = init_train_state(m32, opt, 1, device="cuda")
                noisy = map_tree(lambda _p, t: t * (1 + 1e-7 * torch.randn(
                    t.shape, generator=gen, device="cuda")), st.params)
                del st
                with plain_matmul(torch):
                    _, _, g_noise = grads_of(torch, m32, noisy, b32)
                spread = max(leaf_err(g, plain[2][p])
                             for p, g in g_noise.items() if p not in zero)
                grad_tol = max(grad_tol, SPREAD_FACTOR * spread)
                del noisy, g_noise
            ptol = TRAIN_F32_TOL["param"]
            lr1 = float(opt.lr(torch.ones((), dtype=torch.int32)))
            param_ok, param_err = {}, {}
            for p, t in kern[3].items():
                want, g = plain[3][p], plain[2][p].abs()
                t = t.to(want.device)
                big = g >= TRAIN_F32_TOL["grad_floor"] * g.max()
                param_ok[p] = bool(
                    torch.allclose(t[big], want[big], atol=ptol, rtol=ptol)
                    and (t - want).abs().max() <= 2 * lr1)
                param_err[p] = [(t - want)[big].abs().max().item()
                                if big.any() else 0.0,
                                (t - want).abs().max().item()]
            out["f32_step_vs_plain"] = {
                "cut": spec["f32_cut"], "params": m32.param_count(),
                "loss": [float(kern[0]), float(plain[0])],
                "metrics_max_rel_err": metric_err,
                "grad_max_rel_err": grad_err, "grad_tol": grad_tol,
                "plain_spread_under_ulp_noise": spread,
                "zero_grad_leaves_max_over_top_kernel_plain": zero,
                "lr": lr1,
                "param_max_abs_err_large_grad_and_all": param_err,
                "kernel_gemm_launches_by_path": kern[5],
                "plain_gemm_launches_by_path": plain[5],
                "tol": TRAIN_F32_TOL}
            del res, kern, plain
            free_card(torch)
        out["warnings"] = sorted({str(w.message)[:160] for w in caught})
    finally:
        torch.use_deterministic_algorithms(False)
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit(out)

    # the checks, after the line is out
    per_step = spec["wgmma"](cfg)
    assert all(math.isfinite(l) for l in out["losses"]), out["losses"]
    assert len(out["losses"]) == steps, out["losses"]
    assert out["grads_finite_by_step"] == [True] * steps, out[
        "grads_finite_by_step"]
    if save_at is not None:
        assert out["restored_layouts_as_init"], out
        assert out["resume_bit_equal"], (out["losses"],
                                         out["resumed_losses"])
    assert launches["flash_attention"] == 0, flash_paths
    assert gemm_paths["decode"] == 0 and gemm_paths["wmma"] == 0, gemm_paths
    assert gemm_paths["wgmma"] == per_step * steps, (gemm_paths, per_step)
    assert gemm_paths["simt"] == 2 * steps and gemm_paths["fma"] == 0, \
        gemm_paths
    roles = out["k1_launches_by_role"]
    assert roles.get("unembed_dX") == roles.get("unembed_dW") == 1, roles
    assert sum(roles.values()) == per_step + 2, roles
    assert out["bf16_step_vs_plain"]["plain_gemm_launches"] == 0
    on = out["step_on_fma"]
    assert on["bit_equal_simt"], (on, hold["kernel"][0])
    assert on["gemm_launches_by_path"]["fma"] == 2 and \
        on["gemm_launches_by_path"]["simt"] == 0, on
    for k, tol in TRAIN_BF16_TOL.items():
        got, want = hold["kernel"][0][k], hold["plain"][0][k]
        assert math.isfinite(got) and abs(got - want) <= tol * abs(want), \
            (k, got, want, tol)
    assert prof["annotations"].get("train.step", {}).get("count") == 1, prof
    assert prof["k1"]["families"] == ["gemm"] and prof["k1"]["launches"], prof
    assert prof["k2"]["launches"] == 0, prof
    if "dots_wgmma" in spec:
        dots = out["dots"]
        assert dots["losses_bit_equal_full"], (dots["losses"], out["losses"])
        paths = dots["gemm_launches_by_path"]
        assert paths["wgmma"] == spec["dots_wgmma"](cfg) * steps, (paths,
                                                                    spec)
        assert paths["simt"] == 2 * steps and paths["fma"] == 0, paths
        assert paths["decode"] == paths["wmma"] == 0, paths
        assert dots["k1_launches_by_role"].get("forward_recompute", 0) == 0, \
            dots["k1_launches_by_role"]
    f32 = out["f32_step_vs_plain"]
    assert sum(f32["plain_gemm_launches_by_path"].values()) == 0, f32
    assert f32["kernel_gemm_launches_by_path"]["simt"] > 0, f32
    assert f32["metrics_max_rel_err"] <= TRAIN_F32_TOL["metrics"], f32
    assert max(f32["grad_max_rel_err"].values()) <= f32["grad_tol"], f32
    assert all(max(v) <= ZERO_GRAD_TOL for v in zero.values()), f32
    assert all(param_ok.values()), f32
    return out


# ---------------------------------------------------------------------------
# phase: mesh
# ---------------------------------------------------------------------------

def mesh_serve_run(torch, eng, prompts, max_new):
    """One serve of ``prompts`` with the launch counts from 0 (the prefix
    cache cleared first: every run prefills its prompts): tokens, wall,
    launches by path and the engine's counters over the run."""
    from repro_torch import kernels
    eng.clear_prefix_cache()
    before = eng.stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    d = {k: st[k] - before[k] for k in (
        "tokens_generated", "decode_seconds", "prefill_seconds", "chunks",
        "device_transfers", "admission_prefills")}
    return outs, dict(d, wall_seconds=wall,
                      decode_tok_per_s=d["tokens_generated"]
                      / d["decode_seconds"],
                      launches=kernels.launch_counts(),
                      gemm_launches_by_path=kernels.gemm_launches_by_path(),
                      flash_launches_by_path=kernels.flash_launches_by_path())


def phase_mesh(torch, serve_outs, families):
    """The distribution layer on a one-rank NCCL mesh (data=1,model=1),
    through the code that serves a multi-rank one: DTensor placements,
    collectives over a world of one, K1 and K2 on the local shards.  Serve:
    the serve phase's llama3.2-1b weights (seed 0) and 12 requests through
    an engine with no mesh and one on the mesh, cold then warm, in turns;
    the tokens (also the serve phase's), launches by path and transfers
    must agree.  Train: the train phase's first 3 steps under the FSDP
    rules on the mesh; the losses bit-equal to that phase's (else within
    ``TRAIN_BF16_TOL``), 28 wgmma products a layer + 1 and 2 simt a step,
    and the params saved from the mesh restore with no mesh bit for bit.
    -> two entries for ``summarize`` (``mesh_serve``, ``mesh_train``)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.catalog import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_paths
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.train import (Trainer, TrainerConfig,
                                   abstract_train_state, init_train_state)

    t_phase = time.perf_counter()
    free_card(torch)
    mesh = build_mesh("data=1,model=1")
    out = {"phase": "mesh", "card": torch.cuda.get_device_name(0),
           "backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh": sh.mesh_sizes(mesh)}
    try:
        # -- serve: no mesh and mesh, cold then warm, in turns -----------
        cfg = dataclasses.replace(get_config("llama3.2-1b"),
                                  dtype="bfloat16", attention_impl="flash")
        model = build_model(cfg)
        params = model.init(seed=0, device="cuda")
        rng = np.random.default_rng(0)
        lens = rng.integers(5, 301, size=12)
        prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
                   for n in lens]
        max_new = 32
        scfg = dict(max_batch=8, max_len=1024, decode_chunk=8, profile=True)
        engines = {"plain": Engine(model, params, ServeConfig(**scfg)),
                   "mesh": Engine(model, params, ServeConfig(**scfg,
                                                             mesh=mesh))}
        runs, toks = {}, {}
        for name, when in (("plain", "cold"), ("mesh", "cold"),
                           ("mesh", "warm"), ("plain", "warm")):
            toks[f"{name}_{when}"], runs[f"{name}_{when}"] = mesh_serve_run(
                torch, engines[name], prompts, max_new)
        eng = engines["mesh"]
        eng.clear_prefix_cache()
        before = eng.stats()
        outs_traced, events, secs = traced(
            "mesh_serve", lambda: eng.generate(prompts, max_new))
        st = eng.stats()
        _, prof = profile_summary("serving", events)
        del events
        prof.update(secs)
        prof.update({k: st[k] - before[k] for k in (
            "chunks", "device_transfers", "admission_prefills")})
        serve = {"runs": runs, "profile": prof,
                 "tokens_equal": {k: v == toks["plain_cold"]
                                  for k, v in toks.items()},
                 "tokens_equal_serve_phase": toks["mesh_cold"] == serve_outs,
                 "traced_tokens_equal": outs_traced == toks["plain_cold"],
                 "stats_mesh": st["mesh"], "stats_sharding": st["sharding"],
                 "template_leaves": len(tree_paths(model.template)),
                 "decode_tile_lookups": st["decode_tile_lookups"]}
        for w in ("cold", "warm"):
            p, m = runs[f"plain_{w}"], runs[f"mesh_{w}"]
            serve[f"{w}_wall_mesh_over_plain"] = (m["wall_seconds"]
                                                  / p["wall_seconds"])
            serve[f"{w}_decode_tok_s_mesh_over_plain"] = (
                m["decode_tok_per_s"] / p["decode_tok_per_s"])
        out["serve"] = serve
        del engines, eng, params
        free_card(torch)

        # -- train: the train phase's steps 1-3 on the mesh, FSDP rules --
        spec = TRAIN_PHASES["train"]
        n_steps = 3
        cfg = dataclasses.replace(get_config("llama3.2-1b"),
                                  dtype="bfloat16", attention_impl="chunked",
                                  remat=True)
        model = build_model(cfg)
        opt = AdamW(learning_rate=warmup_cosine(1e-3, 10, spec["steps"]))
        b, s = spec["batch"]
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=s, global_batch=b),
                             device="cuda")
        rules = sh.rules_for_mesh(mesh)
        ckdir = os.path.join(HERE, "build", "mesh_checkpoint")
        shutil.rmtree(ckdir, ignore_errors=True)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            held = [init_train_state(model, opt, 0, device="cuda", mesh=mesh,
                                     rules=rules)]
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            trainer = Trainer(model, opt, pipe, TrainerConfig(
                total_steps=n_steps, log_every=1,
                checkpoint_every=10 ** 9, step_deadline_s=1e9),
                mesh=mesh, rules=rules)
            kernels.reset_launch_counts()
            state, hist = run_from(trainer, held)
            torch.cuda.synchronize()
            train_run = {"launches": kernels.launch_counts(),
                         "gemm_launches_by_path":
                         kernels.gemm_launches_by_path(),
                         "flash_launches_by_path":
                         kernels.flash_launches_by_path()}
            peak = torch.cuda.max_memory_allocated() / 1e9
        finally:
            torch.use_deterministic_algorithms(False)
        ref = next(f for f in families if f.get("phase") == "train")
        losses = [l for _, l in hist]
        want = ref["losses"][:n_steps]
        ck = Checkpointer(ckdir, keep=1)
        t0 = time.perf_counter()
        ck.save(n_steps, {"params": state.params})
        save_s = time.perf_counter() - t0
        whole = {p: sh.full(t) for p, t in tree_paths(state.params).items()}
        del state, held
        free_card(torch)
        template = {"params": abstract_train_state(model, opt).params}
        back = ck.restore(n_steps, template, device="cuda")["params"]
        restored_equal = all(torch.equal(t, whole[p])
                             for p, t in tree_paths(back).items())
        del back, whole
        shutil.rmtree(ckdir, ignore_errors=True)
        out["train"] = {
            "model": cfg.name, "batch": [b, s], "steps": n_steps,
            "rules": rules.describe(), "init_seconds": init_s,
            "losses": losses, "train_phase_losses": want,
            "losses_bit_equal": losses == want,
            "loss_max_rel_diff": max(abs(a - w) / abs(w)
                                     for a, w in zip(losses, want)),
            "step_walls": trainer.step_walls,
            "train_phase_step_walls": ref["step_walls"][:n_steps],
            "tok_per_s_warm": b * s * (n_steps - 1)
            / sum(trainer.step_walls[1:]),
            "train_phase_tok_per_s_warm": ref["tok_per_s_warm"],
            "run": train_run, "peak_mem_gb": peak,
            "params_checkpoint_save_seconds": save_s,
            "restored_without_mesh_bit_equal": restored_equal}
    finally:
        dist.destroy_process_group()
        free_card(torch)
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit(out)

    # the checks, after the line is out
    sv, tr = out["serve"], out["train"]
    assert out["backend"] == "nccl" and out["world"] == 1, out
    assert all(sv["tokens_equal"].values()), sv["tokens_equal"]
    assert sv["tokens_equal_serve_phase"] and sv["traced_tokens_equal"]
    for w in ("cold", "warm"):
        p, m = runs[f"plain_{w}"], runs[f"mesh_{w}"]
        for key in ("gemm_launches_by_path", "flash_launches_by_path",
                    "device_transfers", "chunks"):
            assert m[key] == p[key], (w, key, m[key], p[key])
        assert m["device_transfers"] == m["chunks"], m
    g, f = runs["mesh_cold"]["gemm_launches_by_path"], runs["mesh_cold"][
        "flash_launches_by_path"]
    assert g["decode"] > 0 and g["wgmma"] > 0, g
    assert g["wmma"] == g["fma"] == g["simt"] == 0, g
    assert f["wgmma"] > 0 and f["fma"] == 0, f
    prof = sv["profile"]
    assert prof["host_syncs"] == prof["chunks"] == prof[
        "device_transfers"], prof
    assert sv["stats_mesh"] == {"devices": 1, "axes": {"data": 1, "model": 1},
                                "label": "data1xmodel1"}, sv["stats_mesh"]
    assert sum(sv["stats_sharding"]["params"].values()) == sv[
        "template_leaves"], sv["stats_sharding"]
    lookups = sv["decode_tile_lookups"]
    assert lookups and all(v["local_shape"] == k and v["source"] == "exact"
                           for k, v in lookups.items()), lookups
    paths = tr["run"]["gemm_launches_by_path"]
    assert paths["wgmma"] == spec["wgmma"](cfg) * n_steps, paths
    assert paths["simt"] == 2 * n_steps and paths["fma"] == 0, paths
    assert paths["decode"] == paths["wmma"] == 0, paths
    assert tr["run"]["launches"]["flash_attention"] == 0, tr["run"]
    assert all(math.isfinite(l) for l in tr["losses"]), tr["losses"]
    assert tr["losses_bit_equal"] or tr["loss_max_rel_diff"] <= \
        TRAIN_BF16_TOL["loss"], (tr["losses"], tr["train_phase_losses"])
    assert tr["restored_without_mesh_bit_equal"], tr
    return [{"phase": "mesh_serve", "main_run": "run",
             "run": runs["mesh_cold"]},
            {"phase": "mesh_train", "main_run": "run", "run": tr["run"]}]


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase: roofline
# ---------------------------------------------------------------------------

#: the roofline terms a phase line sums over the calls of a step
ROOF_TERMS = ("compute_s", "memory_s", "collective_s", "est_step_s",
              "compute_bf16_peak_s", "model_flops")


def phase_roofline(torch):
    """The dry run's roofline (``launch.dryrun.cell_record`` on one device,
    fake tensors; ``launch.roofline.roofline_row`` on the ``h100``
    profile) of every traced step of the earlier phases
    (``MEASURED_STEPS``): the serve phase's prefills and decode steps at
    the shapes the traced serve ran them, each train phase's step at its
    depth and batch.  Each line has the terms summed over the step's calls,
    the dominant one, the measured spans (wall and device busy), the
    share ``est_step_s / measured`` of each, the MFU proxy, and the dry
    run's peak-memory estimate beside the phase's measured peak.  Nothing
    here is caught."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.hardware import H100
    from repro_torch.launch.dryrun import cell_record
    from repro_torch.launch.roofline import roofline_row

    t_phase = time.perf_counter()
    card, smi_line = torch.cuda.get_device_name(0), smi()
    peak = H100.peak_flops["bfloat16"]
    assert MEASURED_STEPS, "no traced step to bound"
    for st in MEASURED_STEPS:
        t0 = time.perf_counter()
        sums = dict.fromkeys(ROOF_TERMS, 0.0)
        by_dtype, flash, peak_bytes, shapes = {}, 0.0, 0, []
        for (b, length), n in sorted(st["calls"].items()):
            rec = cell_record(st["cfg"], ShapeSpec(st["label"], length, b,
                                                   st["kind"]))
            row = roofline_row(rec, H100)
            for k in ROOF_TERMS:
                sums[k] += n * row[k]
            for dt, f in rec["step_stats"]["flops_by_dtype"].items():
                by_dtype[dt] = by_dtype.get(dt, 0.0) + n * f
            flash += n * rec["step_stats"]["flash_flops"]
            peak_bytes = max(peak_bytes, rec["memory"]["peak_bytes"])
            shapes.append({"batch": b, "length": length, "calls": n,
                           "est_step_s": row["est_step_s"],
                           "dominant": row["dominant"]})
        terms = {k: sums[f"{k}_s"] for k in ("compute", "memory",
                                             "collective")}
        spans, wall_ms, busy_ms = st["measured"]
        est = sums["est_step_s"]
        line = {
            "phase": "roofline", "step": st["label"], "card": card,
            "nvidia_smi": smi_line, "hardware": H100.name,
            "model": st["cfg"].name, "kind": st["kind"],
            "layers": st["cfg"].num_layers, "shapes": shapes,
            **{k: sums[k] for k in ROOF_TERMS},
            "dominant": max(terms, key=terms.get),
            "flops_by_dtype": by_dtype, "flash_flops": flash,
            "measured": {"spans": spans, "wall_s": wall_ms / 1e3,
                         "device_busy_s": busy_ms / 1e3},
            "share_of_wall": est / (wall_ms / 1e3),
            "share_of_device_busy": est / (busy_ms / 1e3),
            "mfu_proxy": sums["model_flops"] / est / peak,
            "mfu_measured_wall": sums["model_flops"] / (wall_ms / 1e3) / peak,
            "dryrun_peak_gb": peak_bytes / 1e9,
            "measured_peak_mem_gb": st["peak_mem_gb"],
            "seconds": time.perf_counter() - t0}
        assert spans > 0 and wall_ms > 0 and busy_ms > 0, line
        assert est > 0 and math.isfinite(est) and peak_bytes > 0, line
        assert sum(by_dtype.values()) > 0, line
        emit(line)
    emit({"phase": "roofline_done", "steps": len(MEASURED_STEPS),
          "seconds": time.perf_counter() - t_phase})


def _sums(mine):
    t_ops = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
    t_bytes = sum(r["bound_ms"] for r in mine if r["bound_by"] == "bytes")
    ms = sum(r["kernel_ms"] for r in mine)
    device_ms = sum(r["kernel_device_ms"] for r in mine)
    return {"cases": len(mine), "ms": ms, "device_ms": device_ms,
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "library_ms": sum(r["library_ms"] for r in mine),
            "library_device_ms": sum(r["library_device_ms"] for r in mine),
            "bound_ms": t_ops + t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": (t_ops + t_bytes) / ms if ms else None,
            "share_of_bound_device": (t_ops + t_bytes) / device_ms
            if device_ms else None}


def summarize(rows, launches, paths, features, families):
    """One entry per kernel: its main-path cases summed (each model's shapes
    once; ``by_model`` splits the sums), and the same sums per path with the
    serve phase's launches by path.  ``launches`` sums the main-path runs of
    every model (the serve phase; the continuous run of serve_moe,
    serve_vlm, serve_stablelm, serve_audio and serve_hybrid; serve_ssm's
    forced wave run; each train phase's steps; each with the counts set
    to 0 before it);
    ``launches_by_run`` splits it, and ``launches_by_pass`` has the
    launches by path of every serve_features run and every run of the
    family phases."""
    out = []
    family_runs = {f"{fam['phase']} {k}": v for fam in families
                   for k, v in fam.items()
                   if isinstance(v, dict) and "launches" in v}
    for kname, route_src, repl, repl_fn in KERNELS:
        mine = [r for r in rows if r["name"] == kname and r["main_path"]]
        by_run = {"serve": launches[kname]}
        by_run.update({fam["phase"]: fam[fam.get("main_run", "continuous")]
                       ["launches"][kname] for fam in families})
        entry = {"name": kname, "route": "cuda", "source": route_src,
                 "replaces": repl, "replaces_function": repl_fn,
                 "launches": sum(by_run.values()), "launches_by_run": by_run,
                 "max_abs_err": max(r["max_abs_err"] for r in rows
                                    if r["name"] == kname)}
        sums = _sums(mine)
        entry.update(sums, kernel_ms=sums["ms"])
        entry["by_model"] = {m: _sums([r for r in mine if r["model"] == m])
                             for m in sorted({r["model"] for r in mine})}
        entry["launches_by_path"] = paths[kname]
        key = ("gemm_launches_by_path" if kname == "gemm"
               else "flash_launches_by_path")
        entry["launches_by_pass"] = {name: res[key] for name, res in
                                     list(features.items())
                                     + list(family_runs.items())
                                     if isinstance(res, dict) and key in res}
        entry["paths"] = {p: _sums([r for r in mine if r["path"] == p])
                          for p in sorted({r["path"] for r in mine})}
        out.append(entry)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for the compiler report and case table")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build   # fails outside the repository
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    card = smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "dir": str(_build.BUILD_DIR)})
    if args.out:
        for name, log in _build.PTXAS_LOG.items():
            with open(os.path.join(args.out, f"ptxas_{name}.log"), "w") as f:
                f.write(log)
    rows = phase_kernels(torch, args.out)
    phase_tuning(torch)
    launches, paths, ctx = phase_serve(torch)
    serve_outs = ctx["outs"]
    features = phase_serve_features(torch, ctx)
    phase_ir(torch, ctx)
    families = [phase_serve_moe(torch, ctx), phase_serve_vlm(torch, ctx),
                phase_serve_stablelm(torch, ctx), phase_serve_audio(torch, ctx),
                phase_serve_ssm(torch, ctx), phase_serve_hybrid(torch, ctx)]
    phase_examples(torch, ctx)
    families += [phase_train(torch, ctx, p) for p in TRAIN_PHASES]
    families += phase_mesh(torch, serve_outs, families)
    phase_roofline(torch)
    print(card, flush=True)
    emit({"kernels": summarize(rows, launches, paths, features, families)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
