"""On the card: each CUDA kernel against its plain PyTorch version, the
engine's kernels on the serving path, and K1 under autograd (the matmul
Function at the training shapes, one train step against the CPU's).  Needs no JAX, so it runs on the GPU
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
    instantiated_head_dims as flash_head_dims)
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
    # whisper-large-v3's untied unembed, K-major: N = 51866 ends mid-tile
    (8, 1280, 51866, True, None, True, False, "decode"),
    (1, 1280, 51866, True, None, True, False, "decode"),
    (2000, 1280, 51866, True, None, True, False, "wgmma"),
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


def _f32_with_stride(dev, seed, rows, cols, vec_bytes, scale=1.0):
    """A (rows, cols) f32 view whose row stride admits ``vec_bytes``-wide
    loads and no wider (16, 8; 4: an odd stride), over seeded values."""
    floats = vec_bytes // 4
    ld = -(-cols // floats) * floats
    if vec_bytes == 8 and ld % 4 == 0:
        ld += 2
    if vec_bytes == 4 and ld % 2 == 0:
        ld += 1
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(rows, ld, generator=gen, device=dev) * scale)[:, :cols]


SIMT_SCHEDULES = sorted(instantiated_schedules()["simt"])


@pytest.mark.parametrize("vec", [16, 8, 4])
@pytest.mark.parametrize("kmajor", [False, True], ids=["rowmajor", "kmajor"])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["f32out", "bf16out"])
@pytest.mark.parametrize("m,k,n", [(300, 1001, 333), (37, 100, 77),
                                   (129, 8, 64), (200, 2, 5)])
def test_cuda_simt_is_bit_equal_to_fma(cuda, m, k, n, out, kmajor, vec):
    """The ``simt`` kernel, under every schedule ``gemm.cu`` instantiates,
    gives the bits of an explicit ``fma`` launch at ragged shapes: both B
    layouts, 16- and 8-byte vector loads (operands whose row strides allow
    only 4 go to ``fma`` in the wrapper), f32 and bf16 out, with C, a bias,
    alpha, beta and each activation; a K of 2 and an N of 5 too."""
    from repro_torch.core.tile_config import TileConfig
    from repro_torch.kernels.gemm import gemm_cuda, simt_vector_bytes
    a = _f32_with_stride(cuda, m + k, m, k, vec)
    b = (_f32_with_stride(cuda, k + n, n, k, vec, k ** -0.5).t() if kmajor
         else _f32_with_stride(cuda, k + n, k, n, vec, k ** -0.5))
    gen = torch.Generator(device=cuda).manual_seed(3)
    c = torch.randn(m, n, generator=gen, device=cuda)
    bias = torch.randn(n, generator=gen, device=cuda)
    want_vec = simt_vector_bytes(a.data_ptr(), a.stride(0), b.data_ptr(),
                                 b.stride(0), b.stride(1),
                                 int(b.stride(1) != 1 and b.stride(0) == 1))
    assert want_vec == (0 if vec == 4 else vec)
    path = "simt" if want_vec else "fma"
    fma = TileConfig(64, 16, 64, kernel="fma")
    for act in ACTIVATIONS:
        kw = dict(alpha=0.5, beta=-1.5, bias=bias, activation=act,
                  out_dtype=out)
        yard = gemm_cuda(a, b, c, config=fma, **kw)
        for bm, bk, bn, st in SIMT_SCHEDULES:
            cfg = TileConfig(bm, bk, bn, kernel="simt", stages=st, group_m=3)
            before = gemm_cuda.launches_by_path[path]
            got = gemm_cuda(a, b, c, config=cfg, **kw)
            assert gemm_cuda.launches_by_path[path] == before + 1, path
            torch.cuda.synchronize()
            assert torch.equal(got, yard), (cfg.schedule, act)
    want = ref.gemm_ref(a, b, c, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if out == torch.float32 else BF16))


def test_cuda_f32_rows_at_m8_on_fma_equal_them_inside_m300_on_simt(cuda):
    """f32 rows computed at M = 8 (``fma``, the f32 oracles' decode) equal
    the same rows inside an M = 300 product (``simt``, their prefill), bit
    for bit, in both B layouts and at the unembed's width, each product
    through the table's schedule."""
    from repro_torch.kernels.gemm import gemm_cuda
    for k, n, kmajor in ((2048, 2048, False), (2048, 50280, True),
                         (1280, 51866, True), (1000, 334, False)):
        a, b = _operands(cuda, k + n, 300, k, n, dtype=torch.float32,
                         kmajor=kmajor)
        run = lambda x: gemm_cuda(x, b, config=gemm_tiles(
            torch.float32, x.shape[0], k, n), activation="silu")
        before = dict(gemm_cuda.launches_by_path)
        full = run(a)
        assert gemm_cuda.launches_by_path["simt"] == before["simt"] + 1
        for lo in (0, 128, 292):
            rows = run(a[lo:lo + 8])
            torch.cuda.synchronize()
            assert torch.equal(rows, full[lo:lo + 8]), (k, n, lo)
        assert gemm_cuda.launches_by_path["fma"] == before["fma"] + 3


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


def test_cuda_unaligned_unembed_matches_matmul(cuda):
    """whisper-large-v3's unembed (N = 51866, N % 8 = 2) in the layout the
    port stores it, a K-major (V, D) buffer read as its transpose: decode at
    M = 8 and wgmma at a prefill M, through the matmul front end, agree
    with the plain version and with torch.matmul; the row-major layout of
    the same weight would leave both fast kernels."""
    from repro_torch.core import matmul
    from repro_torch.kernels.gemm import gemm_cuda
    d, vocab = 1280, 51866
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = (torch.randn(vocab, d, generator=gen, device=cuda) * d ** -0.5
         ).to(torch.bfloat16).t()
    for m, path in ((8, "decode"), (8 * 300, "wgmma")):
        x = torch.randn(m, d, generator=gen, device=cuda).to(torch.bfloat16)
        before = dict(gemm_cuda.launches_by_path)
        got = matmul(x, w, out_dtype=torch.float32)
        assert gemm_cuda.launches_by_path[path] == before[path] + 1, path
        want = ref.gemm_ref(x, w, out_dtype=torch.float32)
        lib = torch.matmul(x.float(), w.float())
        torch.cuda.synchronize()
        assert tuple(got.shape) == (m, vocab)
        torch.testing.assert_close(got, want, **F32)
        torch.testing.assert_close(got, lib, **F32)
    before = dict(gemm_cuda.launches_by_path)
    matmul(x[:8], w.contiguous(), out_dtype=torch.float32)
    assert gemm_cuda.launches_by_path["wmma"] == before["wmma"] + 1


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
    (8, 256, 256, 16, 16, 128, [0, 17, 100, 255, 256, 3, 64, 200], None),  # olmoe
    # one case per (H, KV, d) of the catalog's archs that no row above has
    (8, 256, 256, 32, 8, 160, [0, 17, 100, 255, 256, 3, 64, 200], None),   # stablelm
    (3, 333, 333, 32, 8, 160, [0, 70, 333], 1024),           # d 160, cache views
    (8, 256, 256, 32, 32, 80, [0, 17, 100, 255, 256, 3, 64, 200], None),   # zamba2
    (3, 333, 333, 32, 32, 80, [5, 0, 333], 1024),            # d 80, cache views
    (8, 256, 256, 20, 20, 64, [0, 17, 100, 255, 256, 3, 64, 200], None),   # whisper
    (4, 200, 200, 32, 2, 128, [0, 13, 199, 200], None),      # chatglm3, H / KV 16
    (2, 100, 256, 32, 8, 128, [0, 40], None),                # yi / vlm, S < S_kv
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


# every wgmma schedule flash_attention.cu instantiates, at each head dim
FLASH_SCHEDULES = [(sched, d) for sched, dims in sorted(
    flash_head_dims()["wgmma"].items()) for d in dims]


@pytest.mark.parametrize("sched,d", FLASH_SCHEDULES, ids=[
    f"{bq}x{bk}-s{st}-d{d}" for (bq, bk, st), d in FLASH_SCHEDULES])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 160])
def test_cuda_flash_fma_head_dims_80_and_160(cuda, d, dtype):
    """The fma kernel (the float32 exactness passes) at zamba2-2.7b's and
    stablelm-12b's head dims, ragged rows and S < S_kv included."""
    from repro_torch.core.tile_config import FlashAttentionConfig
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    for b, s, skv, h, kvh, ks in ((4, 300, 300, 32, 8, [0, 7, 150, 300]),
                                  (2, 37, 100, 8, 8, [3, 0])):
        q, k, v = _flash_operands(cuda, d + s, b, s, skv, h, kvh, d, None)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        kv_start = torch.tensor(ks, dtype=torch.int32, device=cuda)
        for cfg in (flash_tiles(torch.float32, s, skv, d),
                    FlashAttentionConfig(32, 64)):
            before = dict(flash_attention_cuda.launches_by_path)
            got = flash_attention_cuda(q, k, v, config=cfg, kv_start=kv_start)
            assert flash_attention_cuda.launches_by_path["fma"] == before["fma"] + 1
            want = ref.flash_attention_ref(q, k, v, kv_start=kv_start)
            torch.cuda.synchronize()
            tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else BF16
            torch.testing.assert_close(got.float(), want.float(), **tol)


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


def test_cuda_engine_times_prefill_and_decode_on_the_device(cuda):
    """``prefill_seconds`` / ``decode_seconds`` are the device's time, from
    CUDA events read after each chunk's host copy: each positive, both
    within the drain's wall time, none left unread at its end."""
    import time

    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    model = build_model(get_config("olmoe-1b-7b").reduced())
    params = model.init(1, device=cuda)
    prompts = [[(i * 7 + 3) % 256 for i in range(n)] for n in (37, 5, 64)]
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128))
    eng.generate(prompts, 6)                   # builds, allocator
    before = eng.stats()
    t0 = time.perf_counter()
    eng.generate(prompts, 6)
    wall = time.perf_counter() - t0
    st = eng.stats()
    pre = st["prefill_seconds"] - before["prefill_seconds"]
    dec = st["decode_seconds"] - before["decode_seconds"]
    assert pre > 0.0 and dec > 0.0
    assert pre + dec <= wall
    assert eng._clock._open == []


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


def _reduced_on_both(cuda, **model_kw):
    """Reduced llama in float32 with the same weights on the CPU and on the
    card: (model, cpu params, card params)."""
    import dataclasses

    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              attention_impl="flash", **model_kw)
    model = build_model(cfg)
    cpu = model.init(1, device="cpu")

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        return tree.to(cuda)
    return model, cpu, move(cpu)


PREFIX = [(i * 11 + 5) % 256 for i in range(20)]
SERVE_FEATURES = {
    "wave": (dict(), dict(scheduler="wave")),
    "prefix_cache": (dict(), dict(page_size=4)),
    "int8_kv": (dict(kv_quant=True), dict()),
}


@pytest.mark.parametrize("feature", sorted(SERVE_FEATURES))
def test_cuda_serve_features_match_cpu(cuda, feature):
    """The wave, prefix-cache and int8 engines on the card give the tokens
    the same engine gives on the CPU (float32, the same weights); the
    prefix-cache engine serves its traffic twice, cold and warm."""
    from repro_torch.serve import Engine, ServeConfig

    model_kw, serve_kw = SERVE_FEATURES[feature]
    model, cpu, card = _reduced_on_both(cuda, **model_kw)
    prompts = [[5, 9, 2, 7], PREFIX + [3, 1, 4], PREFIX + [1, 5],
               PREFIX + [3, 1, 4], [(i * 7 + 3) % 256 for i in range(37)]]
    outs = []
    for params, dev in ((cpu, "cpu"), (card, None)):
        eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128,
                                                device=dev, **serve_kw))
        outs.append([eng.generate(prompts, 6), eng.generate(prompts, 6)])
        st = eng.stats()
        assert st["device_transfers"] == st["chunks"] + st["waves"]
    assert outs[1] == outs[0]
    if feature == "prefix_cache":
        pc = st["prefix_cache"]
        assert pc["hits_full"] > 0 and pc["hits_partial"] > 0, pc
    if feature == "int8_kv":
        assert st["scheduler"] == "wave" and st["scheduler_forced"]


def test_cuda_wave_bf16_goes_through_decode_and_wgmma(cuda):
    """A bf16 wave serve (head dim 64, GQA group 4): every GEMM runs the
    decode or the wgmma kernel, every prefill attention the wgmma flash
    kernel, and one host transfer per wave."""
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
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128,
                                            scheduler="wave"))
    kernels.reset_launch_counts()
    eng.generate(prompts, 4)
    paths = kernels.gemm_launches_by_path()
    flash = kernels.flash_launches_by_path()
    assert paths["decode"] > 0 and paths["wgmma"] > 0, paths
    assert paths["wmma"] == 0 and paths["fma"] == 0, paths
    assert flash["wgmma"] > 0 and flash["fma"] == 0, flash
    st = eng.stats()
    assert st["waves"] == 2 and st["device_transfers"] == 2


# ---------------------------------------------------------------------------
# the moe family
# ---------------------------------------------------------------------------

def _moe_reduced(**kw):
    import dataclasses

    from repro_torch.configs.catalog import get_config
    return dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                               attention_impl="flash", **kw)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_cuda_flash_f32_group1_d128_matches_plain_version(cuda):
    """The float32 pass of olmoe runs the fma kernel at head dim 128 with
    16 query heads over 16 KV heads, ragged."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(4, 130, 16, 128, generator=gen, device=cuda)
               for _ in range(3))
    kv_start = torch.tensor([0, 7, 129, 130], dtype=torch.int32, device=cuda)
    tile = flash_tiles(torch.float32, 130, 130, 128)
    got = flash_attention_cuda(q, k, v, config=tile, kv_start=kv_start)
    want = ref.flash_attention_ref(q, k, v, kv_start=kv_start)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_cuda_expert_einsum_bf16_is_f32_without_weight_copies(cuda):
    """The expert products of bf16 operands return f32 equal to the upcast
    product (summation order only), and allocate no f32 copy of the
    (E, D, F) stack: the peak grows by the outputs, not by 2 x the stack."""
    from repro_torch.core import einsum
    gen = torch.Generator(device=cuda).manual_seed(0)
    e, b, c, d, f = 64, 8, 8, 2048, 1024
    buf = torch.randn(e, b, c, d, generator=gen, device=cuda).bfloat16()
    w = (torch.randn(e, d, f, generator=gen, device=cuda) * d ** -0.5).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = einsum("ebcd,edf->ebcf", buf, w)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert got.dtype == torch.float32 and tuple(got.shape) == (e, b, c, f)
    assert grown < w.numel() * 4 // 4, grown       # f32 copy: 4 B an element
    want = torch.einsum("ebcd,edf->ebcf", buf.float(), w.float())
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_cuda_moe_layer_matches_cpu(cuda):
    """One MoE layer at olmoe's expert count and top-k (64, 8), float32:
    the card's routing equals the CPU's bit for bit on the same logits, and
    the layer's output matches the CPU's."""
    from repro_torch.core import matmul
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    tpl = moe.moe_template(256, 128, 64)
    cpu = init_params(tpl, seed=2, device="cpu")
    card = _to(cpu, cuda)
    x = torch.randn(4, 50, 256, generator=torch.Generator().manual_seed(0))
    kw = dict(top_k=8, num_experts=64, capacity_factor=1.25)
    logits = matmul(x.to(cuda), card["router"])
    cap = moe.capacity(50, 64, 8, 1.25)
    _, r_card = moe._route_group(x.to(cuda), logits, top_k=8, num_experts=64,
                                 cap=cap)
    _, r_cpu = moe._route_group(x, logits.cpu(), top_k=8, num_experts=64,
                                cap=cap)
    for got, want in zip(r_card[:3], r_cpu[:3]):
        assert torch.equal(got.cpu(), want)
    torch.testing.assert_close(r_card[3].cpu(), r_cpu[3], atol=1e-6, rtol=1e-6)
    got, aux = moe.moe_layer(card, x.to(cuda), **kw)
    want, aux_cpu = moe.moe_layer(cpu, x, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, **F32)
    torch.testing.assert_close(aux.cpu(), aux_cpu, **F32)


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_cuda_moe_engine_matches_cpu(cuda, scheduler):
    """Reduced olmoe in float32: the engine on the card gives the tokens the
    same engine gives on the CPU, one host transfer per chunk or wave."""
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    model = build_model(_moe_reduced())
    cpu = model.init(1, device="cpu")
    prompts = [[5, 9, 2, 7], [1, 3, 3], [(i * 7 + 3) % 256 for i in range(37)]]
    outs = []
    for params, dev in ((cpu, "cpu"), (_to(cpu, cuda), None)):
        eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128,
                                                device=dev,
                                                scheduler=scheduler))
        outs.append(eng.generate(prompts, 6))
        st = eng.stats()
        assert st["device_transfers"] == st["chunks"] + st["waves"]
    assert outs[1] == outs[0]


def test_cuda_moe_engine_bf16_goes_through_decode_and_wgmma(cuda):
    """Reduced olmoe in bf16 at olmoe's head dim (128) and group (1): every
    GEMM (router included) runs the decode or the wgmma kernel, every
    prefill attention the wgmma flash kernel."""
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    model = build_model(_moe_reduced(dtype="bfloat16", head_dim=128,
                                     num_heads=2, num_kv_heads=2))
    params = model.init(1, device=cuda)
    prompts = [[(i * 7 + 3) % 256 for i in range(n)] for n in (37, 5, 64)]
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128))
    kernels.reset_launch_counts()
    eng.generate(prompts, 4)
    paths = kernels.gemm_launches_by_path()
    flash = kernels.flash_launches_by_path()
    assert paths["decode"] > 0 and paths["wgmma"] > 0, paths
    assert paths["wmma"] == 0 and paths["fma"] == 0, paths
    assert flash["wgmma"] > 0 and flash["fma"] == 0, flash


# ---------------------------------------------------------------------------
# the vlm family
# ---------------------------------------------------------------------------

def _vlm_reduced(**kw):
    import dataclasses

    from repro_torch.configs.catalog import get_config
    return dataclasses.replace(get_config("llama-3.2-vision-11b").reduced(),
                               attention_impl="flash", **kw)


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_cuda_vlm_engine_matches_cpu(cuda, scheduler):
    """Reduced llama-3.2-vision in float32 with per-request image
    embeddings: the engine on the card gives the CPU engine's tokens."""
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    model = build_model(_vlm_reduced())
    cpu = model.init(1, device="cpu")
    prompts = [[5, 9, 2, 7], [1, 3, 3], [(i * 7 + 3) % 256 for i in range(37)]]
    spec = model.extra_inputs(len(prompts))["image_embeds"]
    img = torch.randn(spec.shape, generator=torch.Generator().manual_seed(0))
    outs = []
    for params, dev in ((cpu, "cpu"), (_to(cpu, cuda), None)):
        eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128,
                                                device=dev,
                                                scheduler=scheduler))
        outs.append(eng.generate(prompts, 6, extra_inputs={
            "image_embeds": img.to(eng.device)}))
        st = eng.stats()
        assert st["device_transfers"] == st["chunks"] + st["waves"]
    assert outs[1] == outs[0]


def test_cuda_vlm_engine_bf16_goes_through_decode_and_wgmma(cuda):
    """Reduced llama-3.2-vision in bf16 at its head dim (128) and group
    (4): every GEMM (the cross K/V projection included) runs the decode or
    the wgmma kernel, every prefill self-attention the wgmma flash
    kernel."""
    from repro_torch import kernels
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    model = build_model(_vlm_reduced(dtype="bfloat16", head_dim=128,
                                     num_heads=8, num_kv_heads=2))
    params = model.init(1, device=cuda)
    prompts = [[(i * 7 + 3) % 256 for i in range(n)] for n in (37, 5, 64)]
    spec = model.extra_inputs(len(prompts))["image_embeds"]
    img = torch.randn(spec.shape, device=cuda).to(spec.dtype)
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=128))
    kernels.reset_launch_counts()
    eng.generate(prompts, 4, extra_inputs={"image_embeds": img})
    paths = kernels.gemm_launches_by_path()
    flash = kernels.flash_launches_by_path()
    assert paths["decode"] > 0 and paths["wgmma"] > 0, paths
    assert paths["wmma"] == 0 and paths["fma"] == 0, paths
    assert flash["wgmma"] > 0 and flash["fma"] == 0, flash


# ---------------------------------------------------------------------------
# the tuning framework on the card
# ---------------------------------------------------------------------------

def _committed_table():
    from pathlib import Path

    from repro_torch.core import registry, tuning_db
    path = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
            / "tuned" / "h100.json")
    reg = registry.TileRegistry()
    tuning_db.load_into_registry(reg, str(path), strict=True)
    return tuning_db.TuningDB.from_file(str(path)), reg


def test_cuda_measured_sweep_records_exact_and_the_next_launch_takes_it(cuda):
    """A measured sweep of one decode shape records an exact entry, and
    ``core.matmul`` then launches the winner (its kernel's count moves and
    its bits equal a direct launch of the winner)."""
    from repro_torch.core import execution_context, matmul, registry, tuner
    from repro_torch.core import gemm_api
    from repro_torch.kernels.gemm import gemm_cuda
    reg = registry.TileRegistry()
    res = tuner.sweep_gemm(8, 2048, 512, mode="measure", search="exhaustive",
                           repeats=2, registry=reg)
    assert all(p.source == "measure" and p.seconds > 0 for p in res.points)
    look = reg.lookup_op("gemm", "h100", torch.bfloat16, (8, 2048, 512))
    assert (look.source, look.config) == ("exact", res.best.config)
    a, b = _operands(cuda, 5, 8, 2048, 512)
    old = gemm_api.GLOBAL_REGISTRY
    gemm_api.GLOBAL_REGISTRY = reg
    try:
        before = gemm_cuda.launches_by_path[res.best.config.kernel]
        with execution_context(hardware="h100"):
            got = matmul(a, b)
        assert gemm_cuda.launches_by_path[res.best.config.kernel] == before + 1
    finally:
        gemm_api.GLOBAL_REGISTRY = old
    want = gemm_cuda(a, b, config=res.best.config)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_cuda_tune_cli_measures_listed_shapes(cuda, tmp_path):
    """``torch_tune.py sweep --mode measure --shapes`` (problems given as
    M x K x N, B row-major) prints each problem's line with the library's
    time and writes a measured entry."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.core import tuning_db
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(root / "scripts" / "torch_tune.py"), "sweep",
         "--hardware", "h100", "--mode", "measure", "--op", "gemm",
         "--dtype", "float32", "--shapes", "256x512x256", "--top-k", "2",
         "--repeats", "2", "--db-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    (line,) = [json.loads(x) for x in out.stdout.splitlines()
               if x.startswith("{")]
    assert line["shape"] == [256, 512, 256] and line["library_us"] > 0
    db = tuning_db.TuningDB.from_file(str(tmp_path / "h100.json"))
    assert [r.source for r in db.records()] == ["measure"]


@pytest.mark.parametrize("k,n,kmajor", [
    (2048, 2048, False), (2048, 512, False), (2048, 8192, False),
    (8192, 2048, False), (2048, 128256, True)])
def test_cuda_committed_table_keeps_decode_rows_batch_invariant(cuda, k, n,
                                                                 kmajor):
    """Under the committed h100 table, every llama decode shape resolves
    exact and a row computed in a batch of 8 equals it computed alone."""
    from repro_torch.kernels.gemm import gemm_cuda
    _, reg = _committed_table()
    a, b = _operands(cuda, k + n + 1, 8, k, n, kmajor=kmajor)
    looks = {m: reg.lookup_op("gemm", "h100", torch.bfloat16, (m, k, n))
             for m in (1, 8)}
    assert looks[1].source == looks[8].source == "exact"
    assert looks[1].config == looks[8].config
    run = lambda x: gemm_cuda(x, b, config=looks[x.shape[0]].config)
    batch = run(a)
    for i in range(8):
        assert torch.equal(run(a[i:i + 1])[0], batch[i]), i


def test_cuda_every_committed_entry_matches_plain_version(cuda):
    """Each entry of the committed table, at its own shape, on the kernel
    it names, against the plain version: bf16 operands (B K-major where N
    is not a multiple of 8, as the models keep such heads), f32 ones for
    the f32 kernels' entries (B row-major, as the unembed's f32 cotangent
    lies), compared 1024 rows at a time (an f32 copy of a 16384 x 163840
    output is 10.7 GB)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gemm import F32_KERNELS, gemm_cuda
    db, _ = _committed_table()
    for rec in db.records():
        cfg = rec.config
        tol = BF16
        if rec.op == "gemm":
            m, k, n = rec.shape
            if cfg.kernel in F32_KERNELS:
                tol = F32
                a, b = _operands(cuda, m + k + n, m, k, n, torch.float32)
            else:
                a, b = _operands(cuda, m + k + n, m, k, n, kmajor=n % 8 != 0)
            before = gemm_cuda.launches_by_path[cfg.kernel]
            got = gemm_cuda(a, b, config=cfg, activation="silu")
            assert gemm_cuda.launches_by_path[cfg.kernel] == before + 1
            want = ref.gemm_ref(a, b, activation="silu")
        else:
            sq, skv, d = rec.shape
            q, k, v = _flash_operands(cuda, sq + d, 2, sq, skv, 8, 2, d, skv)
            before = flash_attention_cuda.launches_by_path[cfg.kernel]
            got = flash_attention_cuda(q, k, v, config=cfg)
            assert flash_attention_cuda.launches_by_path[cfg.kernel] == \
                before + 1
            want = ref.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        for g, w in zip(got.split(1024), want.split(1024)):
            assert torch.allclose(g.float(), w.float(), **tol), rec


@pytest.mark.parametrize("hw_name", ["cpu", "a100-typo"])
def test_cuda_fallback_profile_runs_the_hand_tables(cuda, hw_name):
    """CUDA tensors served under a profile with no default tier (or an
    unknown name) take the hand tables from the fallback tier: bf16 on the
    decode and wgmma kernels, f32 on fma (M <= 16) and simt (never a
    refused schedule), bf16 flash on wgmma; each against its plain
    version."""
    import warnings

    from repro_torch.core import execution_context, flash_attention, matmul
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gemm import gemm_cuda
    cases = [(8, 2048, 512, torch.bfloat16, "decode"),
             (256, 2048, 512, torch.bfloat16, "wgmma"),
             (8, 256, 192, torch.float32, "fma"),
             (300, 256, 192, torch.float32, "simt")]
    with warnings.catch_warnings(), execution_context(hardware=hw_name):
        warnings.simplefilter("ignore")
        for m, k, n, dtype, path in cases:
            a, b = _operands(cuda, m + n, m, k, n, dtype=dtype)
            before = dict(gemm_cuda.launches_by_path)
            got = matmul(a, b)
            after = gemm_cuda.launches_by_path
            assert after[path] == before[path] + 1, (m, dtype)
            assert sum(after.values()) == sum(before.values()) + 1
            torch.cuda.synchronize()
            tol = BF16 if dtype == torch.bfloat16 else F32
            assert torch.allclose(got.float(), ref.gemm_ref(a, b).float(),
                                  **tol)
        q, kk, v = _flash_operands(cuda, 3, 2, 256, 256, 8, 2, 64, 256)
        before = dict(flash_attention_cuda.launches_by_path)
        got = flash_attention(q, kk, v)
        assert flash_attention_cuda.launches_by_path["wgmma"] == \
            before["wgmma"] + 1
    torch.cuda.synchronize()
    assert torch.allclose(got.float(),
                          ref.flash_attention_ref(q, kk, v).float(), **BF16)


# ---------------------------------------------------------------------------
# training: K1 under autograd
# ---------------------------------------------------------------------------

def test_cuda_gemm_and_flash_refuse_operands_that_require_grad(cuda):
    """Reached outside ``core.matmul``'s autograd Function, the kernels'
    outputs would carry no gradient: under grad mode both wrappers raise."""
    from repro_torch.core import flash_attention
    from repro_torch.kernels.gemm import gemm_cuda
    a, b = _operands(cuda, 0, 256, 2048, 512)
    a.requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        gemm_cuda(a, b, config=gemm_tiles(torch.bfloat16, 256, 2048, 512))
    with torch.no_grad():
        gemm_cuda(a, b, config=gemm_tiles(torch.bfloat16, 256, 2048, 512))
    q, kk, v = _flash_operands(cuda, 1, 2, 256, 256, 8, 2, 64, 256)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q, kk, v)


@pytest.mark.parametrize("name,k,n,act,kmajor,out", [
    ("q", 2048, 2048, None, False, torch.bfloat16),
    ("k/v", 2048, 512, None, False, torch.bfloat16),
    ("gate+silu", 2048, 8192, "silu", False, torch.bfloat16),
    ("down", 8192, 2048, None, False, torch.bfloat16),
    ("unembed tied f32 out", 2048, 128256, None, True, torch.float32)])
def test_cuda_matmul_function_matches_plain_autograd_at_training_shapes(
        cuda, name, k, n, act, kmajor, out):
    """M = 8 x 512 = 4096: the forward and dX, dW on the GEMM kernel (bf16
    products on wgmma; the f32 cotangent of the unembed on simt) against
    autograd through ``gemm_ref`` on the same operands."""
    from repro_torch import kernels
    from repro_torch.core import matmul
    m = 4096
    a, b = _operands(cuda, 7, m, k, n, kmajor=kmajor)
    gen = torch.Generator(device=cuda).manual_seed(8)
    ct = torch.randn(m, n, generator=gen, device=cuda)
    xa, wb = a.clone().requires_grad_(), b.detach().requires_grad_()
    kernels.reset_launch_counts()
    y = matmul(xa, wb, activation=act, out_dtype=out)
    (y.float() * ct).sum().backward()
    paths = kernels.gemm_launches_by_path()
    xr, wr = a.clone().requires_grad_(), b.detach().requires_grad_()
    yr = ref.gemm_ref(xr, wr, activation=act, out_dtype=out)
    (yr.float() * ct).sum().backward()
    torch.cuda.synchronize()
    want = {"wgmma": 1, "simt": 2} if out == torch.float32 else {"wgmma": 3}
    assert {p: c for p, c in paths.items() if c} == want, paths
    for got, exp in ((y, yr), (xa.grad, xr.grad), (wb.grad, wr.grad)):
        assert got.dtype == exp.dtype
        scale = exp.float().abs().max().item()
        err = (got.float() - exp.float()).abs().max().item()
        assert err <= 2e-2 * max(scale, 1.0), (name, err, scale)


def test_cuda_train_step_matches_the_cpu(cuda):
    """One float32 train step of reduced llama3.2-1b on the card (every
    product on the f32 kernels, simt above M = 16) against the same step
    on the CPU."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), remat=True)
    model = build_model(cfg)
    opt = AdamW(learning_rate=1e-3)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    results = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(model, opt, 0, device="cpu")
        state = state._replace(step=state.step.to(dev),
                               params=_to(state.params, dev),
                               opt=type(state.opt)(*(_to(x, dev)
                                                     for x in state.opt)))
        kernels.reset_launch_counts()
        new, metrics = make_train_step(model, opt)(
            state, TokenPipeline(data, device=dev)(0))
        results[dev] = (new, metrics, kernels.gemm_launches_by_path())
    paths = results["cuda"][2]
    assert paths["simt"] > 0 and sum(paths.values()) == paths["fma"] + \
        paths["simt"], paths
    for k, v in results["cpu"][1].items():
        assert abs(float(results["cuda"][1][k]) - float(v)) <= 1e-4 * max(
            abs(float(v)), 1.0), k
    for leaf_c, leaf_g in zip(_leaves(results["cpu"][0].params),
                              _leaves(results["cuda"][0].params)):
        torch.testing.assert_close(leaf_g.cpu(), leaf_c, atol=1e-4, rtol=1e-4)


def _leaves(tree):
    from repro_torch.models.params import tree_leaves
    return tree_leaves(tree)


def _train_batch(model, dev, batch=4, seq=32):
    """Step 0 of the synthetic pipeline on ``dev``, with the model's extra
    inputs (seeded, drawn on the CPU) beside the tokens."""
    from repro_torch.data import DataConfig, TokenPipeline
    out = TokenPipeline(DataConfig(vocab_size=model.cfg.vocab_size,
                                   seq_len=seq, global_batch=batch),
                        device=dev)(0)
    gen = torch.Generator().manual_seed(0)
    for k, spec in model.extra_inputs(batch).items():
        out[k] = (0.02 * torch.randn(spec.shape, generator=gen)).to(
            device=dev, dtype=spec.dtype)
    return out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3",
                                  "mamba2-130m", "zamba2-2.7b"])
def test_cuda_train_step_of_every_family_matches_the_cpu(cuda, arch):
    """One float32 train step of each family's reduced model with remat on
    the card (every product on the f32 kernels) against the CPU: metrics
    within 1e-4, every gradient leaf within 1e-4 of its max (a key bias,
    whose gradient is 0 in exact arithmetic, at roundoff on both), parameters
    within 1e-4 where the gradient is at least 1e-3 of its leaf's max and
    within 2 lr everywhere (AdamW's first update is lr * g / (|g| + eps),
    which a last-bit difference of a near-zero gradient moves anywhere
    within lr)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_paths
    from repro_torch.optim import AdamW
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.trainer import _value_and_grad
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    model = build_model(cfg)
    opt = AdamW(learning_rate=1e-3)
    results = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(model, opt, 0, device="cpu")
        state = state._replace(step=state.step.to(dev),
                               params=_to(state.params, dev),
                               opt=type(state.opt)(*(_to(x, dev)
                                                     for x in state.opt)))
        batch = _train_batch(model, dev)
        kernels.reset_launch_counts()
        _, _, grads = _value_and_grad(model, state.params, batch)
        new, metrics = make_train_step(model, opt)(state, batch)
        results[dev] = (tree_paths(new.params), metrics, tree_paths(grads),
                        kernels.gemm_launches_by_path())
    paths = results["cuda"][3]
    assert paths["simt"] > 0 and sum(paths.values()) == paths["fma"] + \
        paths["simt"], paths
    for k, v in results["cpu"][1].items():
        assert abs(float(results["cuda"][1][k]) - float(v)) <= 1e-4 * max(
            abs(float(v)), 1.0), k
    top = max(g.abs().max().item() for g in results["cpu"][2].values())
    for p, g in results["cpu"][2].items():
        scale = g.abs().max().item()
        got = results["cuda"][2][p].cpu()
        if p.endswith("/bk"):
            # 0 in exact arithmetic (a row's softmax cancels q . bk): both
            # devices give roundoff, far below the other leaves
            assert max(scale, got.abs().max().item()) <= 1e-6 * top, p
        else:
            err = (got - g).abs().max().item()
            assert err <= 1e-4 * max(scale, 1e-30), (p, err, scale)
        big = g.abs() >= 1e-3 * scale
        want, got = results["cpu"][0][p], results["cuda"][0][p].cpu()
        torch.testing.assert_close(got[big], want[big], atol=1e-4, rtol=1e-4)
        assert (got - want).abs().max().item() <= 2e-3, p


def test_cuda_kmajor_head_stays_on_wgmma_after_updates_and_a_restore(
        cuda, tmp_path):
    """Reduced whisper at vocab 250 in bf16: after two updates and after a
    checkpoint's restore, ``lm_head`` is still K-major and the unembed
    (M = 4 x 32 rows) launches the wgmma kernel, not wmma."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.catalog import get_config
    from repro_torch.core import matmul
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train import (abstract_train_state, init_train_state,
                                   make_train_step)
    cfg = dataclasses.replace(get_config("whisper-large-v3").reduced(),
                              vocab_size=250, dtype="bfloat16")
    model = build_model(cfg)
    opt = AdamW(learning_rate=1e-3)
    state = init_train_state(model, opt, 0, device="cuda")
    step = make_train_step(model, opt)
    batch = _train_batch(model, "cuda")
    for _ in range(2):
        state, _ = step(state, batch)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state)
    back = ck.restore(2, abstract_train_state(model, opt), device="cuda")
    x = torch.randn(4 * 32, cfg.d_model, device="cuda").bfloat16()
    for s in (state, back):
        for t in (s.params["lm_head"], s.opt.m["lm_head"],
                  s.opt.master["lm_head"]):
            assert t.stride() == (1, cfg.d_model), t.stride()
        kernels.reset_launch_counts()
        matmul(x, s.params["lm_head"], out_dtype=torch.float32)
        paths = kernels.gemm_launches_by_path()
        assert paths["wgmma"] == 1 and paths["wmma"] == 0, paths


def test_cuda_bf16_dw_of_a_ragged_m_stays_on_wgmma(cuda):
    """A bf16 product at M = 4 x 1601 rows (vlm's cross K/V over image
    tokens) under autograd: forward, dX and dW (its M padded to a multiple
    of 8 with zero rows) all on the wgmma kernel, dW within a bf16 ulp of
    autograd through the plain version."""
    from repro_torch import kernels
    from repro_torch.core import matmul
    a, b = _operands(cuda, 5, 4 * 1601, 256, 128)
    x, w = a.clone().requires_grad_(), b.detach().requires_grad_()
    ct = torch.randn(4 * 1601, 128, device=cuda)
    kernels.reset_launch_counts()
    (matmul(x, w).float() * ct).sum().backward()
    paths = kernels.gemm_launches_by_path()
    wr = b.detach().requires_grad_()
    (ref.gemm_ref(a, wr).float() * ct).sum().backward()
    torch.cuda.synchronize()
    assert {p: c for p, c in paths.items() if c} == {"wgmma": 3}, paths
    scale = wr.grad.float().abs().max().item()
    assert (w.grad.float() - wr.grad.float()).abs().max().item() <= \
        2e-2 * scale


def test_cuda_dots_remat_gives_full_gradients_without_recompute(cuda):
    """``remat_policy="dots"`` on the card at reduced llama3.2-1b in bf16:
    the gradients equal ``"full"``'s bit for bit, and the backward launches
    no forward K1 product (``"full"`` launches the 7 a layer again).
    Deterministic algorithms on, as in ``chip_smoke.py``'s train phases:
    index_select's backward (the embedding gradient) adds with atomics,
    whose order changes the embedding's bits from run to run under any
    policy."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_paths
    from repro_torch.train.trainer import _value_and_grad
    base = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                               dtype="bfloat16")
    params = build_model(base).init(0, device=cuda)
    batch = TokenPipeline(DataConfig(vocab_size=base.vocab_size, seq_len=32,
                                     global_batch=4), device=cuda)(0)
    grads, launches = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, kw in (("none", dict(remat=False)),
                         ("full", dict(remat=True, remat_policy="full")),
                         ("dots", dict(remat=True, remat_policy="dots"))):
            model = build_model(dataclasses.replace(base, **kw))
            kernels.reset_launch_counts()
            _, _, g = _value_and_grad(model, params, batch)
            torch.cuda.synchronize()
            grads[name] = tree_paths(g)
            launches[name] = kernels.gemm_launches_by_path()
    finally:
        torch.use_deterministic_algorithms(False)
    assert launches["dots"] == launches["none"], launches
    assert launches["full"]["wgmma"] == (launches["none"]["wgmma"]
                                         + 7 * base.num_layers), launches
    for path, g in grads["full"].items():
        assert torch.equal(grads["dots"][path], g), path
        assert torch.equal(grads["none"][path], g), path


def test_cuda_profiling_trace_names_k1_and_k2(cuda, tmp_path):
    """A ``profiling.trace`` on the card captures device events: K1's
    kernels fall in the ``gemm`` family, K2's in ``attention``, the
    capture passes ``validate_profile`` on the device timeline, and each
    kernel's launcher is named (K1 and K2, launched under no PyTorch op,
    by themselves)."""
    from repro_torch.core import flash_attention, matmul
    from repro_torch.profiling import (annotate, build_profile,
                                       classify_event_name, trace,
                                       validate_profile)
    a, b = _operands(cuda, 0, 256, 512, 384)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    matmul(a, b), flash_attention(q, k, v)            # builds, outside
    with trace(str(tmp_path)) as s:
        with annotate("serve.unit_test_span"):
            matmul(a, b)
            flash_attention(q, k, v)
    events = s.events()
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    k1 = [n for n in kernels if "gemm_wgmma_kernel" in n]
    k2 = [n for n in kernels if "flash_fwd_wgmma_kernel" in n]
    assert k1 and k2, sorted(kernels)
    assert {classify_event_name(n) for n in k1} == {"gemm"}
    assert {classify_event_name(n) for n in k2} == {"attention"}
    blob = validate_profile(build_profile("serving", events=events,
                                          hardware="h100"))
    assert blob["timeline"] == "device"
    assert blob["families"]["gemm"]["count"] >= 1
    assert blob["families"]["attention"]["count"] >= 1
    assert blob["annotations"]["serve.unit_test_span"]["count"] == 1
    # launched through ctypes under no PyTorch op: named by themselves
    launchers = blob["device_us_by_launching_op"]
    assert "gemm_wgmma_kernel" in launchers, launchers
    assert "flash_fwd_wgmma_kernel" in launchers, launchers


def test_cuda_roofline_row_of_a_traced_train_step(cuda, tmp_path):
    """The dry run's roofline row (``launch.dryrun.cell_record`` on fake
    tensors, ``launch.roofline.roofline_row`` on ``h100``) of the train
    step a trace measures on the card: full-width llama3.2-1b at 2 layers,
    4 x 256 tokens, bf16, remat.  The compute term (each dtype's flops over
    its peak) is a floor of the device's busy time; the dry run's peak
    memory is within 10% of the step's measured one; the row's product
    flops are K1's and the attention einsums' own."""
    import dataclasses

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.catalog import get_config
    from repro_torch.core.hardware import H100
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.dryrun import cell_record
    from repro_torch.launch.roofline import roofline_row
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.profiling import annotate, trace
    from repro_torch.profiling.breakdown import DEVICE_CATEGORIES
    from repro_torch.train import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2,
                              dtype="bfloat16", attention_impl="chunked",
                              remat=True)
    model, opt = build_model(cfg), AdamW(learning_rate=1e-4)
    b, s = 4, 256
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                     global_batch=b), device=cuda)(0)
    state = init_train_state(model, opt, 0, device=cuda)
    step = make_train_step(model, opt)
    step(state, batch)                              # builds, outside
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with trace(str(tmp_path)) as sess:
        with annotate("train.step"):
            step(state, batch)
        torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated()
    busy_s = sum(float(e["dur"]) for e in sess.events()
                 if e.get("ph") == "X"
                 and e.get("cat") in DEVICE_CATEGORIES) / 1e6
    rec = cell_record(cfg, ShapeSpec("unit", s, b, "train"))
    row = roofline_row(rec, H100)
    assert row["hardware"] == "h100" and row["chips"] == 1
    assert set(rec["step_stats"]["flops_by_dtype"]) == {"bfloat16",
                                                       "float32"}
    assert 0 < row["compute_s"] <= busy_s, (row, busy_s)
    assert row["est_step_s"] == max(row["compute_s"], row["memory_s"])
    assert row["collective_s"] == 0 and row["collective_count"] == 0
    assert abs(rec["memory"]["peak_bytes"] - measured_peak) \
        <= 0.1 * measured_peak, (rec["memory"], measured_peak)


@pytest.fixture
def one_rank_mesh(cuda):
    """A data=1,model=1 mesh over NCCL (a world of one), torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import build_mesh
    mesh = build_mesh("data=1,model=1", device="cuda")
    assert dist.get_backend() == "nccl"
    yield mesh
    dist.destroy_process_group()


def test_cuda_one_rank_mesh_serves_the_no_mesh_tokens_and_launches(
        one_rank_mesh):
    """Reduced llama3.2-1b in bf16 with flash prefill on a one-rank NCCL
    mesh: the tokens, K1's and K2's launches by path and the host
    transfers of the engine with no mesh, and every local shape the
    global one."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="bfloat16", attention_impl="flash")
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    prompts = [[(5 * i + j) % cfg.vocab_size for j in range(3 + 4 * i)]
               for i in range(6)]
    out, paths, st = {}, {}, {}
    for name, mesh in (("plain", None), ("mesh", one_rank_mesh)):
        eng = Engine(model, params, ServeConfig(max_batch=4, max_len=128,
                                                mesh=mesh))
        kernels.reset_launch_counts()
        out[name] = eng.generate(prompts, 12)
        torch.cuda.synchronize()
        paths[name] = (kernels.gemm_launches_by_path(),
                       kernels.flash_launches_by_path())
        st[name] = eng.stats()
    assert out["mesh"] == out["plain"]
    assert paths["mesh"] == paths["plain"], paths
    # head dim 16: K2's fma kernel (wgmma takes 64 and up)
    assert paths["mesh"][0]["decode"] > 0 and sum(paths["mesh"][1].values())
    assert st["mesh"]["device_transfers"] == st["mesh"]["chunks"] == \
        st["plain"]["device_transfers"]
    assert st["mesh"]["mesh"] == {"devices": 1,
                                  "axes": {"data": 1, "model": 1},
                                  "label": "data1xmodel1"}
    assert all(v["local_shape"] == k for k, v in
               st["mesh"]["decode_tile_lookups"].items())


def test_cuda_one_rank_mesh_train_step_is_bit_equal(one_rank_mesh):
    """One train step of reduced llama3.2-1b in bf16 under the FSDP rules
    on a one-rank NCCL mesh: the loss and every gradient leaf bit-equal to
    the step with no mesh, with the same K1 launches (deterministic
    algorithms on, as in the dots test above)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs.catalog import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_paths
    from repro_torch.train.trainer import _value_and_grad
    mesh = one_rank_mesh
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="bfloat16", remat=True)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     global_batch=4), device="cuda")(0)
    rules = sh.rules_for_mesh(mesh)
    placed = sh.shard_params(params, mesh, rules, model.template)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kernels.reset_launch_counts()
        loss, _, grads = _value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        plain_paths = kernels.gemm_launches_by_path()
        kernels.reset_launch_counts()
        with dctx.activation_policy(mesh, rules):
            mbatch = sh.distribute_tree(batch, sh.batch_shardings(
                mesh, rules, batch))
            mloss, _, mgrads = _value_and_grad(model, placed, mbatch)
        torch.cuda.synchronize()
        mesh_paths = kernels.gemm_launches_by_path()
    finally:
        torch.use_deterministic_algorithms(False)
    assert mesh_paths == plain_paths, (mesh_paths, plain_paths)
    assert torch.equal(sh.full(mloss), loss)
    for path, g in tree_paths(grads).items():
        assert torch.equal(sh.full(tree_paths(mgrads)[path]), g), path
