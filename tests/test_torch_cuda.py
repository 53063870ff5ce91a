"""On the card: each CUDA kernel against its plain PyTorch version, and the
engine's kernels on the serving path.  Needs no JAX, so it runs on the GPU
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips (decided at run time, in a fixture).
Tolerances: float32 GEMM atol=rtol=1e-4 (summation order over K up to 8192),
float32 flash 1e-5; bfloat16 outputs 2e-2 (one bf16 ulp).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.tile_config import flash_tiles, gemm_tiles  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    instantiated_schedules as flash_schedules)
from repro_torch.kernels.gemm import instantiated_schedules  # noqa: E402

ACTIVATIONS = [None, "relu", "gelu", "silu", "tanh"]
BF16 = dict(atol=2e-2, rtol=2e-2)
F32 = dict(atol=1e-4, rtol=1e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _operands(dev, seed, m, k, n, dtype=torch.bfloat16, kmajor=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    b = (torch.randn(n, k, generator=gen, device=dev) * k ** -0.5).to(dtype)
    return a, (b.t() if kmajor else b.t().contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,transposed", [
    (8, 2048, 512, False), (37, 100, 77, True), (300, 256, 192, False)])
def test_cuda_gemm_matches_plain_version(cuda, dtype, m, k, n, transposed):
    from repro_torch import kernels
    from repro_torch.kernels.gemm import gemm_cuda
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    b = torch.randn(n, k, generator=gen, device=cuda).to(dtype) * k ** -0.5
    b = b.t() if transposed else b.t().contiguous()
    c = torch.randn(m, n, generator=gen, device=cuda)
    bias = torch.randn(n, generator=gen, device=cuda)
    for act in ACTIVATIONS:
        kw = dict(alpha=0.5, beta=2.0, bias=bias, activation=act)
        before = kernels.launch_counts()["gemm"]
        got = gemm_cuda(a, b, c, config=gemm_tiles(dtype, m, k, n), **kw)
        assert kernels.launch_counts()["gemm"] == before + 1
        want = ref.gemm_ref(a, b, c, **kw)
        torch.cuda.synchronize()
        tol = F32 if dtype == torch.float32 else BF16
        torch.testing.assert_close(got.float(), want.float(), **tol)


# (M, K, N, K-major B, activation, f32 out, +C +bias, expected kernel)
NEW_PATHS = [
    (1, 2048, 512, False, None, False, False, "decode"),
    (3, 2048, 512, False, "silu", False, False, "decode"),
    (8, 2048, 512, False, None, True, True, "decode"),
    (16, 2048, 512, False, "gelu", False, True, "decode"),
    (1, 8192, 2048, False, "silu", True, False, "decode"),
    (8, 8192, 2048, False, None, False, True, "decode"),
    (16, 8192, 2048, False, "tanh", True, False, "decode"),
    (8, 2048, 8192, False, "silu", False, False, "decode"),
    (8, 2048, 4160, True, None, True, False, "decode"),      # unembed layout
    (5, 200, 72, True, "relu", False, True, "decode"),       # ragged K tile
    (1800, 2048, 512, False, None, False, False, "wgmma"),   # M % 128 != 0
    (2048, 2048, 2048, False, "silu", False, False, "wgmma"),
    (256, 1024, 4096, False, None, True, True, "wgmma"),
    (200, 2048, 1000, True, None, True, False, "wgmma"),     # K-major B
    (130, 200, 520, False, "gelu", False, True, "wgmma"),    # ragged K and N
    (24, 8192, 2048, False, "relu", False, False, "wgmma"),
]


@pytest.mark.parametrize("case", NEW_PATHS, ids=[
    f"{c[7]}-{c[0]}x{c[1]}x{c[2]}{'-kmajor' if c[3] else ''}-{c[4]}"
    f"{'-f32out' if c[5] else ''}{'-C-bias' if c[6] else ''}" for c in NEW_PATHS])
def test_cuda_gemm_decode_and_wgmma_match_plain_version(cuda, case):
    from repro_torch.kernels.gemm import gemm_cuda
    m, k, n, kmajor, act, f32_out, extras, path = case
    a, b = _operands(cuda, m + k + n, m, k, n, kmajor=kmajor)
    kw = dict(activation=act,
              out_dtype=torch.float32 if f32_out else torch.bfloat16)
    c = None
    if extras:
        gen = torch.Generator(device=cuda).manual_seed(7)
        c = torch.randn(m, n, generator=gen, device=cuda)
        kw.update(alpha=0.5, beta=0.25,
                  bias=torch.randn(n, generator=gen, device=cuda))
    tile = gemm_tiles(torch.bfloat16, m, k, n)
    assert tile.kernel == path
    before = gemm_cuda.launches_by_path[path]
    got = gemm_cuda(a, b, c, config=tile, **kw)
    assert gemm_cuda.launches_by_path[path] == before + 1
    want = ref.gemm_ref(a, b, c, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if f32_out else BF16))


# every decode and wgmma schedule gemm.cu instantiates, at a ragged shape
SCHEDULES = [(kernel, bk, bn, stages) for kernel in ("decode", "wgmma")
             for _, bk, bn, stages in sorted(instantiated_schedules()[kernel],
                                             reverse=True)]


@pytest.mark.parametrize("sched", SCHEDULES, ids=[
    f"{k}-{bk}x{bn}-s{st}" for k, bk, bn, st in SCHEDULES])
@pytest.mark.parametrize("kmajor", [False, True], ids=["rowmajor", "kmajor"])
def test_cuda_gemm_every_schedule_matches_plain_version(cuda, sched, kmajor):
    from repro_torch.core.tile_config import TileConfig
    from repro_torch.kernels.gemm import gemm_cuda
    kernel, bk, bn, stages = sched
    m = 13 if kernel == "decode" else 700     # 700: a ragged last M tile
    k, n = 1000, 1096
    a, b = _operands(cuda, bn + stages, m, k, n, kmajor=kmajor)
    cfg = TileConfig(16 if kernel == "decode" else 128, bk, bn, kernel=kernel,
                     stages=stages, split_k=3 if kernel == "decode" else 1,
                     group_m=3 if kernel == "wgmma" else 1)
    before = gemm_cuda.launches_by_path[kernel]
    got = gemm_cuda(a, b, config=cfg, activation="gelu")
    assert gemm_cuda.launches_by_path[kernel] == before + 1
    want = ref.gemm_ref(a, b, activation="gelu")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.parametrize("k,n,kmajor", [
    (2048, 512, False), (8192, 2048, False), (2048, 8192, False),
    (2048, 4160, True)])
def test_cuda_decode_is_deterministic_and_batch_invariant(cuda, k, n, kmajor):
    """The same product twice gives the same bits; each row of an M = 8
    product equals that row computed alone (M = 1) and in M = 3 and 16,
    bit for bit; a launch right after another one through the split-K
    workspace does not see the first one's partial sums."""
    from repro_torch.kernels.gemm import gemm_cuda
    a, b = _operands(cuda, k + n, 16, k, n, kmajor=kmajor)
    other, _ = _operands(cuda, 99, 8, k, n)
    run = lambda x: gemm_cuda(x, b, config=gemm_tiles(torch.bfloat16, x.shape[0],
                                                      k, n), activation="silu")
    first = run(a[:8])
    again = run(a[:8])
    assert torch.equal(first, again)
    for i in range(8):
        assert torch.equal(run(a[i:i + 1])[0], first[i]), i
    assert torch.equal(run(a[:3]), first[:3])
    assert torch.equal(run(a)[:8], first)
    run(other)                              # a different product in between
    assert torch.equal(run(a[:8]), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_plain_version(cuda, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, kvh, d = 4, 200, 32, 8, 64
    q = torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, s, kvh, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, s, kvh, d, generator=gen, device=cuda).to(dtype)
    ks = torch.tensor([0, 13, 199, 200], dtype=torch.int32, device=cuda)
    got = flash_attention_cuda(q, k, v, config=flash_tiles(dtype, s, s, d),
                               kv_start=ks)
    want = ref.flash_attention_ref(q, k, v, kv_start=ks)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)


# (B, S, Skv, H, KV, d, kv_start, cache rows K / V are a view of, or None)
WGMMA_FLASH = [
    (8, 256, 256, 32, 8, 64, [0, 17, 100, 255, 256, 3, 64, 200], None),
    (2, 256, 256, 32, 8, 128, [0, 65], None),
    (2, 200, 200, 16, 16, 64, [0, 199], None),               # H / KV = 1
    (2, 37, 37, 64, 8, 128, [5, 37], None),                  # H / KV = 8
    (2, 100, 256, 32, 8, 64, [0, 40], None),                 # S < S_kv
    (3, 37, 37, 32, 8, 64, [0, 1, 36], None),
    (4, 200, 200, 32, 8, 64, [0, 129, 63, 200], 1024),       # cache views
    (2, 300, 300, 8, 1, 128, [17, 0], 1024),
] + [(4, n, n, 32, 8, 64, [0, n // 3, n - 1, n], 1024)       # engine buckets
     for n in (8, 16, 32, 64, 128, 512)]


def _flash_operands(dev, seed, b, s, skv, h, kvh, d, cache):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16)
    rows = cache or skv
    k = torch.randn(b, rows, kvh, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(b, rows, kvh, d, generator=gen, device=dev).to(torch.bfloat16)
    return q, k[:, :skv], v[:, :skv]


@pytest.mark.parametrize("case", WGMMA_FLASH, ids=[
    f"b{c[0]}-s{c[1]}-skv{c[2]}-h{c[3]}-kv{c[4]}-d{c[5]}"
    f"{'-cache' if c[7] else ''}" for c in WGMMA_FLASH])
def test_cuda_flash_wgmma_matches_plain_version(cuda, case):
    """The bf16 kernel against the plain version: packed GQA heads, ragged
    lengths, kv_start off the tile grid, fully masked rows (zeros), K / V
    read in place from a larger cache; the table's schedule takes the
    wgmma path, and a second launch gives the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, wgmma_takes
    b, s, skv, h, kvh, d, ks, cache = case
    q, k, v = _flash_operands(cuda, s + d + h, b, s, skv, h, kvh, d, cache)
    kv_start = torch.tensor(ks, dtype=torch.int32, device=cuda)
    tile = flash_tiles(torch.bfloat16, s, skv, d)
    assert tile.kernel == "wgmma" and wgmma_takes(q, k, v, d ** -0.5)
    before = dict(flash_attention_cuda.launches_by_path)
    got = flash_attention_cuda(q, k, v, config=tile, kv_start=kv_start)
    again = flash_attention_cuda(q, k, v, config=tile, kv_start=kv_start)
    assert flash_attention_cuda.launches_by_path["wgmma"] == before["wgmma"] + 2
    assert flash_attention_cuda.launches_by_path["fma"] == before["fma"]
    want = ref.flash_attention_ref(q, k, v, kv_start=kv_start)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    for i, start in enumerate(ks):
        if start >= skv:                          # no valid column: zeros
            assert not got[i].any()


FLASH_SCHEDULES = sorted(flash_schedules()["wgmma"])


@pytest.mark.parametrize("sched", FLASH_SCHEDULES, ids=[
    f"{bq}x{bk}-s{st}" for bq, bk, st in FLASH_SCHEDULES])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_flash_every_wgmma_schedule_matches_plain_version(cuda, sched, d):
    from repro_torch.core.tile_config import FlashAttentionConfig
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    bq, bk, stages = sched
    # S = 333: in the last block of 32 positions the second warpgroup has no
    # real row and skips all of up to 6 tiles while the first one runs them
    q, k, v = _flash_operands(cuda, bq + bk + d, 3, 333, 333, 16, 4, d, 512)
    kv_start = torch.tensor([0, 70, 333], dtype=torch.int32, device=cuda)
    cfg = FlashAttentionConfig(bq, bk, kernel="wgmma", stages=stages)
    before = flash_attention_cuda.launches_by_path["wgmma"]
    got = flash_attention_cuda(q, k, v, config=cfg, kv_start=kv_start)
    assert flash_attention_cuda.launches_by_path["wgmma"] == before + 1
    want = ref.flash_attention_ref(q, k, v, kv_start=kv_start)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **BF16)


def test_cuda_flash_operands_wgmma_does_not_take_run_fma(cuda):
    """bf16 with head dim 32 or H / KV = 12: the wrapper picks the fma
    kernel before the launch, and it agrees with the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    for h, kvh, d in ((8, 2, 32), (12, 1, 64)):
        q, k, v = _flash_operands(cuda, d, 2, 50, 50, h, kvh, d, None)
        before = dict(flash_attention_cuda.launches_by_path)
        got = flash_attention_cuda(q, k, v, config=flash_tiles(
            torch.bfloat16, 50, 50, d))
        assert flash_attention_cuda.launches_by_path["fma"] == before["fma"] + 1
        assert flash_attention_cuda.launches_by_path["wgmma"] == before["wgmma"]
        want = ref.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **BF16)


def test_cuda_engine_runs_through_both_kernels(cuda):
    """Reduced llama on the card: flash prefill + decode chunks launch both
    kernels, and the tokens equal the per-prompt oracle's (float32)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig, generate_per_prompt

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              attention_impl="flash")
    model = build_model(cfg)
    params = model.init(1, device=cuda)
    prompts = [[5, 9, 2, 7], [1, 3, 3], [(i * 7 + 3) % 256 for i in range(37)]]
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128))
    kernels.reset_launch_counts()
    got = eng.generate(prompts, 6)
    counts = kernels.launch_counts()
    assert counts["gemm"] > 0 and counts["flash_attention"] > 0, counts
    assert got == generate_per_prompt(model, params, prompts, 6, max_len=128)
    st = eng.stats()
    assert st["device_transfers"] == st["chunks"]


def test_cuda_engine_bf16_goes_through_decode_and_wgmma(cuda):
    """Reduced llama in bf16: every GEMM of the serve path runs through the
    decode or the wgmma kernel, none through WMMA or FMA."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              attention_impl="flash", dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(1, device=cuda)
    prompts = [[(i * 7 + 3) % 256 for i in range(n)] for n in (37, 5, 64)]
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128))
    kernels.reset_launch_counts()
    eng.generate(prompts, 4)
    paths = kernels.gemm_launches_by_path()
    assert paths["decode"] > 0 and paths["wgmma"] > 0, paths
    assert paths["wmma"] == 0 and paths["fma"] == 0, paths


def test_cuda_engine_bf16_prefill_attention_goes_through_wgmma(cuda):
    """Reduced llama in bf16 with llama3.2-1b's head dim (64) and GQA group
    (4): every prefill attention of the serve path runs the wgmma kernel."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              attention_impl="flash", dtype="bfloat16",
                              head_dim=64, num_heads=8, num_kv_heads=2)
    model = build_model(cfg)
    params = model.init(1, device=cuda)
    prompts = [[(i * 7 + 3) % 256 for i in range(n)] for n in (37, 5, 64)]
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128))
    kernels.reset_launch_counts()
    eng.generate(prompts, 4)
    flash = kernels.flash_launches_by_path()
    assert flash["wgmma"] > 0 and flash["fma"] == 0, flash
