#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line:

1. ``device``  — the card, its power limit, torch and CUDA versions.
2. ``build``   — build the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and time it.
3. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card at the shapes the serving path of llama3.2-1b gives it and at the
   edges of each GEMM path (decode M = 1..16, split-K with C and bias, the
   K-major unembed, ragged prefill M, operands only WMMA takes), launch each
   GEMM twice and require the same bits, require decode rows computed at
   M = 8 to equal the same rows at M = 1 bit for bit, and time the kernel,
   the plain version, one PyTorch library call computing the same function
   (a yardstick only; the port never calls it) and the bound (max of bytes
   / 3.35 TB/s and FLOPs / the peak for the input type); the kernel and
   the library call are timed again by a device-only timer (``Timer``).
   Flash attention runs at the serving prefill shape, its ragged, short
   and f32 edges, and two long prompts (4096 tokens causal, 4 x 1024
   ragged) that are not on the serve path; each flash launch runs twice
   and must give the same bits.  Each row names the path (kernel) it took
   and its share of bound.
4. ``serve``   — full-width llama3.2-1b in bf16 with seeded random weights,
   flash prefill: 12 requests through ``Engine`` over 8 slots; the kernels'
   launch counts by path are set to 0 just before and read just after:
   every product must go through the decode or the wgmma GEMM kernel, and
   every prefill attention through the wgmma flash kernel.  Then the
   batched ragged prefill against per-prompt prefill, and a float32 pass
   (full width, 2 layers, flash through the fma kernel) whose engine
   tokens must equal the per-prompt oracle's exactly.  The prefix cache is
   on (the default); these prompts share no prefix and hit nothing.
5. ``serve_features`` — the same model and weights through the paths the
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
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core and f32 peaks, HBM rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
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
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def gemm_cases(torch):
    """(label, M, K, N, dtype, b_transposed, activation, out_dtype, extras,
    main_path).  The main path's shapes first, each once; then the edges of
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


def run_gemm_case(torch, timers, case, gen):
    from repro_torch.core.tile_config import gemm_tiles
    from repro_torch.kernels.gemm import gemm_cuda
    from repro_torch.kernels.ref import gemm_ref
    label, m, k, n, dtype, b_t, act, out_dtype, extras, main = case
    a, b = gemm_operands(torch, gen, m, k, n, dtype, b_t)
    kw = dict(activation=act, out_dtype=out_dtype)
    c = None
    if extras:
        c = torch.randn(m, n, generator=gen, device="cuda")
        kw.update(alpha=0.5, beta=0.25,
                  bias=torch.randn(n, generator=gen, device="cuda"))
    tile = gemm_tiles(dtype, m, k, n)
    before = dict(gemm_cuda.launches_by_path)
    out = gemm_cuda(a, b, c, config=tile, **kw)
    path = [p for p, v in gemm_cuda.launches_by_path.items()
            if v != before[p]][0]
    again = gemm_cuda(a, b, c, config=tile, **kw)
    ref = gemm_ref(a, b, c, **kw)
    torch.cuda.synchronize()
    same_bits = bool(torch.equal(out, again))
    err = (out.float() - ref.float()).abs().max().item()
    # bf16 output: one bf16 ulp (2**-8 relative) of values up to ~4;
    # f32 output: summation order over K only.
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-4
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    in_bytes = a.element_size()
    nbytes = (m * k + k * n) * in_bytes + m * n * out.element_size()
    if extras:
        nbytes += m * n * 4 + n * 4
    b_ms, b_by = bound(2.0 * m * n * k, nbytes, str(dtype).split(".")[1])
    timer, device_timer = timers
    kernel = lambda: gemm_cuda(a, b, c, config=tile, **kw)
    library = lambda: torch.matmul(a, b)
    kernel_ms, kernel_device_ms = timer(kernel), device_timer(kernel)
    return {
        "name": "gemm", "replaces": KERNELS[0][3], "case": label,
        "shape": [m, k, n], "dtype": str(dtype).split(".")[1],
        "tile": tile.label, "schedule": tile.schedule, "path": path,
        "max_abs_err": err, "tol": f"atol=rtol={tol}",
        "same_bits_twice": same_bits, "ok": bool(ok) and same_bits,
        "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
        "plain_ms": timer(lambda: gemm_ref(a, b, c, **kw)),
        "library_ms": timer(library),
        "library_device_ms": device_timer(library),
        "library": "torch.matmul",
        "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / kernel_ms,
        "share_of_bound_device": b_ms / kernel_device_ms,
        "main_path": main,
    }


def decode_batch_invariance(torch, gen):
    """Decode rows computed at M = 8 equal the same rows computed alone
    (M = 1), bit for bit (bf16), at every decode shape of the main path."""
    from repro_torch.core.tile_config import gemm_tiles
    from repro_torch.kernels.gemm import gemm_cuda
    rows = []
    for name, k, n, b_t, act, out_dtype in (
            ("q/o", 2048, 2048, False, None, torch.bfloat16),
            ("k/v", 2048, 512, False, None, torch.bfloat16),
            ("gate+silu", 2048, 8192, False, "silu", torch.bfloat16),
            ("down", 8192, 2048, False, None, torch.bfloat16),
            ("unembed", 2048, 128256, True, None, torch.float32)):
        a, b = gemm_operands(torch, gen, 8, k, n, torch.bfloat16, b_t)
        run = lambda x: gemm_cuda(x, b, config=gemm_tiles(
            torch.bfloat16, x.shape[0], k, n), activation=act,
            out_dtype=out_dtype)
        batch = run(a)
        solo = torch.cat([run(a[i:i + 1]) for i in range(8)])
        torch.cuda.synchronize()
        rows.append({"case": f"decode {name} M=8 vs M=1", "shape": [8, k, n],
                     "bit_equal": bool(torch.equal(batch, solo))})
    return rows


def flash_cases():
    """(label, B, S, Skv, H, KV, d, dtype, kv_start, main_path).  The main
    path's prefill shape first; the two long prompts are not on the serve
    path (its prompts are at most 300 tokens), so the kernels line's sums
    stay comparable with earlier runs."""
    ragged = [0, 17, 100, 255, 256, 3, 64, 200]     # 256: fully masked row
    return [
        ("prefill (8,256,32,64) ragged + fully masked row", 8, 256, 256, 32, 8,
         64, "bfloat16", ragged, True),
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
    from repro_torch.core.tile_config import flash_tiles
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref
    label, b, s, skv, h, kvh, d, dtype, ks, main = case
    q, k, v, kv_start = flash_operands(torch, case, gen)
    tile = flash_tiles(q.dtype, s, skv, d)
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
        "tol": f"atol=rtol={tol}", "path": path, "finite": finite,
        "same_bits_twice": same_bits, "ok": bool(ok),
        "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
        "plain_ms": timer(lambda: flash_attention_ref(
            q, k, v, causal=True, kv_start=kv_start)),
        "library_ms": timer(lib), "library_device_ms": device_timer(lib),
        "library": "F.scaled_dot_product_attention",
        "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / kernel_ms,
        "share_of_bound_device": b_ms / kernel_device_ms,
        "main_path": main,
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
        raise AssertionError(f"decode rows differ between M = 8 and 1: {bad}")
    slow = [r["case"] for r in rows if r["main_path"] and r["path"] not in (
        ("decode", "wgmma") if r["name"] == "gemm" else ("wgmma",))]
    if slow:
        raise AssertionError(f"main-path shapes off the new kernels: {slow}")
    return rows


# ---------------------------------------------------------------------------
# phase: serve
# ---------------------------------------------------------------------------

def phase_serve(torch):
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
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
    assert gemm_paths["wmma"] == 0 and gemm_paths["fma"] == 0, gemm_paths
    # and every bf16 prefill attention through the wgmma flash kernel
    assert flash_paths["wgmma"] > 0 and flash_paths["fma"] == 0, flash_paths
    assert st["device_transfers"] == st["chunks"], st
    assert st["admissions"] >= 12 and st["admission_prefills"] >= 2, st
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
    }

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
# phase: serve_features
# ---------------------------------------------------------------------------

def prefix_traffic(rng, vocab: int, prefix, repeat_of):
    """8 prompts sharing ``prefix`` (256 tokens: 16 pages of 16), each with
    its own suffix of 5-60 tokens, then 4 exact repeats of ``repeat_of``'s
    first four (of the 8 themselves when ``repeat_of`` is None)."""
    fresh = [prefix + rng.integers(0, vocab, size=int(n)).tolist()
             for n in rng.integers(5, 61, size=8)]
    return fresh + [list(p) for p in (repeat_of or fresh)[:4]]


def drain(eng, Request, prompts, max_new):
    handles = [eng.submit(Request(prompt=p, max_new_tokens=max_new))
               for p in prompts]
    eng.run()
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
        assert gemm["wmma"] == 0 and gemm["fma"] == 0, (name, gemm)
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


def summarize(rows, launches, paths, features):
    """One entry per kernel: its main-path cases summed (each shape once),
    and the same sums per path with the serve phase's launches by path;
    ``launches_by_pass`` the launches by path of each serve_features pass."""
    out = []
    for kname, route_src, repl, repl_fn in KERNELS:
        mine = [r for r in rows if r["name"] == kname and r["main_path"]]
        entry = {"name": kname, "route": "cuda", "source": route_src,
                 "replaces": repl, "replaces_function": repl_fn,
                 "launches": launches[kname],
                 "max_abs_err": max(r["max_abs_err"] for r in rows
                                    if r["name"] == kname)}
        sums = _sums(mine)
        entry.update(sums, kernel_ms=sums["ms"])
        entry["launches_by_path"] = paths[kname]
        key = ("gemm_launches_by_path" if kname == "gemm"
               else "flash_launches_by_path")
        entry["launches_by_pass"] = {name: res[key]
                                     for name, res in features.items()
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
    launches, paths, ctx = phase_serve(torch)
    features = phase_serve_features(torch, ctx)
    print(card, flush=True)
    emit({"kernels": summarize(rows, launches, paths, features)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
