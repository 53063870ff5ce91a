"""The port's plain kernel versions against the JAX oracles and the Pallas
kernels in interpret mode, on the same numpy-seeded inputs.

Tolerances: float32 atol=rtol=1e-5 (summation order only); bfloat16 outputs
atol=rtol=2e-2 (one bf16 ulp: the two sides round the same f32 value after
summing in different orders).  The CUDA kernels themselves are held against
these plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.tile_config import TileConfig as JaxTile  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.core.tile_config import (  # noqa: E402
    H100_FLASH_TILES, H100_GEMM_TILES, H100_UNALIGNED_TILES, TileConfig,
    flash_tiles, gemm_tiles)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
ACTIVATIONS = [None, "relu", "gelu", "silu", "tanh"]


def _both(x_np, dtype):
    """The same values as a JAX array and a torch CPU tensor (bf16 bit for bit)."""
    j = jnp.asarray(x_np).astype(dtype)
    return j, params_from_numpy({"x": np.asarray(j)}, device="cpu")["x"]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

SHAPES = [(8, 16, 8), (33, 65, 17), (64, 128, 96), (1, 256, 7)]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_gemm_ref_matches_jax_oracle_and_pallas(m, k, n, dtype):
    rng = np.random.default_rng(m * 1000 + k)
    ja, ta = _both(rng.standard_normal((m, k)), dtype)
    jb, tb = _both(rng.standard_normal((k, n)), dtype)
    got = ref.gemm_ref(ta, tb)
    tol = F32 if dtype == jnp.float32 else BF16
    np.testing.assert_allclose(_np(got), _np(jax_ref.gemm_ref(ja, jb)), **tol)
    pallas = jax_ops.gemm(ja, jb, config=JaxTile(16, 32, 16),
                          backend=jax_ops.BACKEND_PALLAS_INTERPRET)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    assert got.dtype == (torch.float32 if dtype == jnp.float32 else torch.bfloat16)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_gemm_epilogue_matches_jax(activation, dtype):
    """alpha, beta*C, bias, activation (gelu is the tanh form), in order."""
    rng = np.random.default_rng(7)
    m, k, n = 20, 48, 24
    ja, ta = _both(rng.standard_normal((m, k)), dtype)
    jb, tb = _both(rng.standard_normal((k, n)), dtype)
    jc, tc = _both(rng.standard_normal((m, n)), dtype)
    jbias, tbias = _both(rng.standard_normal(n), dtype)
    kw = dict(alpha=0.75, beta=-0.5, activation=activation)
    tol = F32 if dtype == jnp.float32 else BF16
    got = ref.gemm_ref(ta, tb, tc, bias=tbias, **kw)
    want = jax_ref.gemm_ref(ja, jb, jc, bias=jbias, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    pallas = jax_ops.gemm(ja, jb, jc, config=JaxTile(16, 16, 16),
                          backend=jax_ops.BACKEND_PALLAS_INTERPRET,
                          bias=jbias, **kw)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)


def test_gemm_bf16_in_f32_out_and_transposed_b():
    """The tied unembed: bf16 x (a transposed view), f32 out."""
    rng = np.random.default_rng(11)
    ja, ta = _both(rng.standard_normal((5, 64)), jnp.bfloat16)
    jemb, temb = _both(rng.standard_normal((40, 64)), jnp.bfloat16)
    got = ops.gemm(ta, temb.t(), out_dtype=torch.float32)
    want = jax_ref.gemm_ref(ja, jemb.T, out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_gemm_rejects_unknown_activation_and_bad_shapes():
    a, b = torch.ones(2, 3), torch.ones(3, 4)
    with pytest.raises(ValueError):
        ref.gemm_ref(a, b, activation="swish")
    with pytest.raises(ValueError):
        ref.gemm_ref(a, torch.ones(4, 4))


def test_tile_table_covers_every_m_and_names_instantiated_tiles():
    from repro_torch.kernels.gemm import instantiated_schedules
    inst = instantiated_schedules()
    assert set(inst) == {"wmma", "fma", "decode", "wgmma", "simt"}
    assert all(inst.values())
    table = [t for rows in H100_GEMM_TILES.values() for *_, t in rows]
    table += [t for rows in H100_UNALIGNED_TILES.values() for _, t in rows]
    for tile in table:
        assert (tile.bm, tile.bk, tile.bn, tile.stages) in inst[tile.kernel], \
            tile.schedule
    for dtype, rows in H100_GEMM_TILES.items():
        for m in (1, 8, 16, 17, 256, 257, 4096):
            for k, n in ((2048, 2048), (2048, 512), (8192, 2048), (2048, 128256)):
                tile = gemm_tiles(dtype, m, k, n)
                assert dataclasses.replace(tile, split_k=1) in [
                    t for *_, t in rows], tile.schedule
    assert gemm_tiles(torch.bfloat16, 8, 2048, 2048).kernel == "decode"
    assert gemm_tiles(torch.bfloat16, 17, 2048, 2048).kernel == "wgmma"
    assert gemm_tiles(torch.float32, 8, 2048, 2048).kernel == "fma"
    assert gemm_tiles(torch.float32, 16, 2048, 2048).kernel == "fma"
    assert gemm_tiles(torch.float32, 17, 2048, 2048).kernel == "simt"
    assert gemm_tiles(torch.bfloat16, 8, 1, 1, aligned=False) == TileConfig(16, 64, 64)
    assert gemm_tiles(torch.float32, 4096, 1, 1, aligned=False).kernel == "fma"
    for dtype, rows in H100_FLASH_TILES.items():
        for s in (1, 32, 33, 4096):
            for d in (16, 64, 128):
                assert flash_tiles(dtype, s, s, d) in [t for *_, t in rows]


@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 512), (2048, 8192),
                                 (8192, 2048), (2048, 128256), (200, 72),
                                 (64, 24)])
def test_tile_table_decode_rows_depend_on_k_and_n_only(k, n):
    """Every M the decode kernel takes gets the same schedule, so a row
    sums its K chunks in the same order alone (M = 1) as in the engine's
    batch (M = 8): the same bits."""
    tiles = {gemm_tiles(torch.bfloat16, m, k, n) for m in range(1, 17)}
    assert len(tiles) == 1
    (tile,) = tiles
    assert tile.kernel == "decode"
    chunk = tile.k_chunk(k)
    assert chunk % tile.bk == 0 and chunk > 0
    splits = -(-k // chunk)
    assert 1 <= splits <= tile.split_k
    assert (splits - 1) * chunk < k          # no empty split


def test_decode_split_count_fills_the_card():
    # ~2 blocks an SM; never more splits than bk steps
    assert gemm_tiles(torch.bfloat16, 8, 2048, 2048).split_k == 8
    assert gemm_tiles(torch.bfloat16, 8, 2048, 512).split_k == 16
    assert gemm_tiles(torch.bfloat16, 8, 2048, 8192).split_k == 2
    assert gemm_tiles(torch.bfloat16, 8, 8192, 2048).split_k == 8
    assert gemm_tiles(torch.bfloat16, 8, 2048, 128256).split_k == 1
    assert gemm_tiles(torch.bfloat16, 8, 64, 64).split_k == 1


def test_gemm_wrapper_sends_unaligned_operands_to_wmma():
    """The decode / wgmma kernels need 16-byte aligned bases and row strides
    (cp.async and TMA); the wrapper decides from the strides, before any
    launch, and the CPU tensors here show the same strides."""
    from repro_torch.kernels.gemm import _aligned

    def fits(kernel, a, b, k, n):
        kmajor = int(b.stride(1) != 1 and b.stride(0) == 1)
        return _aligned(kernel, a.data_ptr(), a.stride(0), b.data_ptr(),
                        b.stride(0), b.stride(1), kmajor, k, n)

    a = torch.zeros(8, 2048, dtype=torch.bfloat16)
    w = torch.zeros(2048, 512, dtype=torch.bfloat16)
    emb = torch.zeros(1000, 2048, dtype=torch.bfloat16)
    assert fits("decode", a, w, 2048, 512)
    assert fits("wgmma", a, w, 2048, 512)
    assert fits("decode", a, emb.t(), 2048, 1000)              # tied unembed
    ragged = torch.zeros(37, 100, dtype=torch.bfloat16)
    assert not fits("wgmma", ragged, torch.zeros(100, 77, dtype=torch.bfloat16),
                    100, 77)
    assert not fits("decode", a[:, 1:2041], w[1:2041], 2040, 512)
    assert not fits("decode", a, w[:, :100], 2048, 100)         # N % 8
    assert fits("wgmma", a, w[:, :104], 2048, 104)


def test_simt_schedules_parse_and_every_f32_row_names_one():
    """The ``simt`` kernel's ``dispatch_simt`` lines are read as its
    schedules; every f32 row of the hand table, and of its unaligned rows,
    names a schedule of the kernel it runs on: ``fma`` up to M = 16,
    ``simt`` beyond, ``fma`` for operands no vector path takes."""
    from repro_torch.core.tile_config import gemm_kernel_for
    from repro_torch.kernels.gemm import KERNEL_CODES, instantiated_schedules
    inst = instantiated_schedules()
    assert (128, 16, 128, 1) in inst["simt"] and (128, 8, 64, 1) in inst["simt"]
    assert all(bm % 32 == 0 and bn % 64 == 0 and bk % 4 == 0
               for bm, bk, bn, _ in inst["simt"])
    assert KERNEL_CODES["simt"] not in [v for k, v in KERNEL_CODES.items()
                                        if k != "simt"]
    for max_m, _n, tile in H100_GEMM_TILES[torch.float32]:
        assert (tile.bm, tile.bk, tile.bn, tile.stages) in inst[tile.kernel]
        assert tile.kernel == gemm_kernel_for(torch.float32, max_m or 17)
    for _m, tile in H100_UNALIGNED_TILES[torch.float32]:
        assert tile.kernel == "fma"
        assert (tile.bm, tile.bk, tile.bn, tile.stages) in inst["fma"]
    for m in (17, 300, 2048, 4096):
        for k, n in ((128256, 2048), (4096, 128256), (51866, 1280),
                     (4096, 51866), (50280, 768), (32000, 2560)):
            assert gemm_tiles(torch.float32, m, k, n).kernel == "simt"


def _simt_route(a, b):
    """(kernel, vector bytes) the wrapper picks for f32 operands ``a @ b``
    of the shapes and strides these CPU tensors have."""
    from repro_torch.kernels.gemm import simt_vector_bytes
    m, k = a.shape
    n = b.shape[1]
    kmajor = int(b.stride(1) != 1 and b.stride(0) == 1)
    vec = simt_vector_bytes(a.data_ptr(), a.stride(0), b.data_ptr(),
                            b.stride(0), b.stride(1), kmajor)
    tile = gemm_tiles(torch.float32, m, k, n, aligned=bool(vec))
    return tile.kernel, vec if tile.kernel == "simt" else 0


def test_simt_route_and_vector_width_from_bases_and_strides():
    """The unembed's f32 backward at each train phase's vocab: 16-byte
    loads where the rows allow them; whisper-large-v3's 51866-wide
    cotangent rows (8 bytes, not 16) take the 8-byte path in dX (A = dZ)
    and dW (B = dZ); a 4-byte-only stride or base goes to ``fma``; M <= 16
    stays on ``fma`` whatever the strides."""
    f32 = torch.float32
    for v, d in ((128256, 64), (32000, 64), (50280, 48)):
        dz = torch.zeros(32, v, dtype=f32)
        w = torch.zeros(v, d, dtype=f32)
        assert _simt_route(dz, w) == ("simt", 16)                # dX, tied
        assert _simt_route(dz, torch.zeros(d, v, dtype=f32).t()) == (
            "simt", 16)                                          # dX, untied
        assert _simt_route(torch.zeros(d, 32, dtype=f32), dz) == ("simt", 16)
    dz = torch.zeros(32, 51866, dtype=f32)
    head = torch.zeros(51866, 40, dtype=f32)       # W.T of a K-major head
    assert _simt_route(dz, head) == ("simt", 8)                  # dX
    assert _simt_route(torch.zeros(40, 32, dtype=f32), dz) == ("simt", 8)
    assert _simt_route(dz, torch.zeros(40, 51866, dtype=f32).t()) == (
        "simt", 8)                                               # K-major B
    odd = torch.zeros(32, 2049, dtype=f32)                       # 4-byte rows
    assert _simt_route(odd, torch.zeros(2049, 64, dtype=f32)) == ("fma", 0)
    assert _simt_route(torch.zeros(32, 64, dtype=f32),
                       torch.zeros(64, 2049, dtype=f32)) == ("fma", 0)
    base = torch.zeros(32 * 66, dtype=f32)[1:1 + 32 * 64].view(32, 64)
    assert base.data_ptr() % 8 == 4
    assert _simt_route(base, torch.zeros(64, 64, dtype=f32)) == ("fma", 0)
    two = torch.zeros(32 * 66, dtype=f32)[2:2 + 32 * 64].view(32, 64)
    assert _simt_route(two, torch.zeros(64, 64, dtype=f32)) == ("simt", 8)
    assert _simt_route(torch.zeros(16, 64, dtype=f32),
                       torch.zeros(64, 64, dtype=f32)) == ("fma", 0)


def test_launch_counts_by_path_reset_together():
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gemm import gemm_cuda
    gemm_cuda.launches_by_path["decode"] += 3
    assert kernels.gemm_launches_by_path()["decode"] >= 3
    assert kernels.launch_counts()["gemm"] >= 3
    flash_attention_cuda.launches_by_path["wgmma"] += 2
    assert kernels.flash_launches_by_path()["wgmma"] >= 2
    assert kernels.launch_counts()["flash_attention"] >= 2
    kernels.reset_launch_counts()
    assert set(kernels.gemm_launches_by_path().values()) == {0}
    assert set(kernels.flash_launches_by_path().values()) == {0}
    assert set(kernels.flash_launches_by_path()) == {"wgmma", "fma"}
    assert kernels.launch_counts() == {"gemm": 0, "flash_attention": 0}


def test_gemm_cuda_takes_cuda_tensors_only():
    """No plain-version fallback inside the kernel wrapper: CPU tensors go
    through ``ops.gemm`` instead."""
    from repro_torch.kernels.gemm import gemm_cuda
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gemm_cuda(a, torch.zeros(8, 8), config=gemm_tiles(torch.float32, 4, 8, 8))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, S, Skv, H, KV, d, kv_start)
    (2, 64, 64, 4, 4, 16, None),              # MHA, block multiples
    (2, 64, 64, 8, 2, 16, None),              # GQA
    (2, 24, 64, 4, 2, 16, None),              # causal with S != S_kv
    (3, 40, 40, 4, 2, 16, [0, 5, 17]),        # ragged kv_start
    (2, 37, 37, 4, 1, 32, [3, 0]),            # non-divisible lengths
    (3, 16, 16, 4, 2, 16, [0, 16, 9]),        # a fully masked row
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[
    "mha", "gqa", "s_ne_skv", "ragged", "non_divisible", "fully_masked"])
def test_flash_ref_matches_pallas_interpret(case):
    b, s, skv, h, kvh, d, ks = case
    rng = np.random.default_rng(s * 100 + skv)
    jq, tq = _both(rng.standard_normal((b, s, h, d)), jnp.float32)
    jk, tk = _both(rng.standard_normal((b, skv, kvh, d)), jnp.float32)
    jv, tv = _both(rng.standard_normal((b, skv, kvh, d)), jnp.float32)
    jks = None if ks is None else jnp.asarray(ks, jnp.int32)
    tks = None if ks is None else torch.tensor(ks, dtype=torch.int32)
    got = ref.flash_attention_ref(tq, tk, tv, causal=True, kv_start=tks)
    want = jax_flash(jq, jk, jv, causal=True, bq=16, bk=16, interpret=True,
                     kv_start=jks)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert np.isfinite(_np(got)).all()
    if ks is not None and max(ks) >= skv:      # l == 0 divides by 1: zeros
        assert not _np(got)[int(np.argmax(ks))].any()
    # the GQA front end takes the plain version for CPU tensors
    front = flash_attention(tq, tk, tv, config=flash_tiles(torch.float32, s, skv, d),
                            kv_start=tks)
    assert torch.equal(front, got)


def test_flash_ref_without_kv_start_is_softmax_attention():
    rng = np.random.default_rng(5)
    jq, tq = _both(rng.standard_normal((2, 12, 4, 8)), jnp.bfloat16)
    jk, tk = _both(rng.standard_normal((2, 20, 2, 8)), jnp.bfloat16)
    jv, tv = _both(rng.standard_normal((2, 20, 2, 8)), jnp.bfloat16)
    got = ref.flash_attention_ref(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(got), _np(jax_ref.attention_ref(jq, jk, jv)),
                               **BF16)
    np.testing.assert_allclose(_np(ref.attention_ref(tq, tk, tv)), _np(got),
                               **BF16)


# the wgmma kernel's shapes (bf16 inputs, head dims 64 / 128, GQA groups of
# 1, 4 and 8 heads, S not a block multiple, kv_start not a multiple of bk)
WGMMA_SHAPES = [
    # (B, S, Skv, H, KV, d, kv_start)
    (2, 37, 37, 4, 4, 64, [0, 5]),
    (2, 37, 50, 8, 2, 64, [3, 50]),
    (1, 20, 20, 8, 1, 128, [7]),
]


@pytest.mark.parametrize("case", WGMMA_SHAPES, ids=["g1_d64", "g4_d64_s_lt_skv",
                                                    "g8_d128"])
def test_flash_ref_matches_pallas_at_wgmma_shapes(case):
    b, s, skv, h, kvh, d, ks = case
    rng = np.random.default_rng(b * 1000 + s + d)
    jq, tq = _both(rng.standard_normal((b, s, h, d)), jnp.bfloat16)
    jk, tk = _both(rng.standard_normal((b, skv, kvh, d)), jnp.bfloat16)
    jv, tv = _both(rng.standard_normal((b, skv, kvh, d)), jnp.bfloat16)
    jks, tks = jnp.asarray(ks, jnp.int32), torch.tensor(ks, dtype=torch.int32)
    got = ref.flash_attention_ref(tq, tk, tv, causal=True, kv_start=tks)
    want = jax_flash(jq, jk, jv, causal=True, bq=16, bk=16, interpret=True,
                     kv_start=jks)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    front = flash_attention(tq, tk, tv, config=flash_tiles(torch.bfloat16, s, skv, d),
                            kv_start=tks)
    assert torch.equal(front, got)


def test_flash_table_names_instantiated_schedules():
    """Every row of the flash tile table names a schedule that
    ``csrc/flash_attention.cu``'s ``dispatch_*`` lines instantiate."""
    from repro_torch.kernels.flash_attention import instantiated_schedules
    inst = instantiated_schedules()
    assert set(inst) == {"fma", "wgmma"}
    assert all(inst.values())
    for dtype, rows in H100_FLASH_TILES.items():
        for *_, tile in rows:
            assert (tile.bq, tile.bk, tile.stages) in inst[tile.kernel], tile.schedule
            assert tile.kernel == ("wgmma" if dtype == torch.bfloat16 else "fma")
    for _, bk, stages in inst["wgmma"]:
        assert bk in (64, 128) and stages >= 2


# (dtype, d, H, KV, operand change, scale, the wgmma kernel takes it)
FLASH_PATHS = [
    (torch.bfloat16, 64, 32, 8, None, None, True),        # llama3.2-1b
    (torch.bfloat16, 128, 8, 1, None, None, True),        # H / KV = 8, d 128
    (torch.bfloat16, 64, 4, 4, "cache view", None, True),  # k[:, :s] of a cache
    (torch.float32, 64, 32, 8, None, None, False),
    (torch.bfloat16, 32, 4, 2, None, None, False),        # head dim 32
    (torch.bfloat16, 64, 12, 1, None, None, False),       # H / KV = 12
    (torch.bfloat16, 64, 4, 2, "misaligned base", None, False),
    (torch.bfloat16, 64, 4, 2, "odd batch stride", None, False),
    (torch.bfloat16, 64, 4, 2, None, -1.0, False),
]


@pytest.mark.parametrize("case", FLASH_PATHS, ids=[
    "llama", "d128_g8", "cache_view", "f32", "d32", "g12", "misaligned",
    "odd_stride", "negative_scale"])
def test_flash_wrapper_path_rule(case):
    """The wrapper sends operands to the wgmma kernel only where TMA and the
    packed-head tile take them; it decides from shapes and strides before
    any launch, and CPU tensors show the same strides."""
    from repro_torch.kernels.flash_attention import _inner_contiguous, wgmma_takes
    dtype, d, h, kvh, change, scale, takes = case
    b, s = 2, 40
    q = torch.zeros(b, s, h, d, dtype=dtype)
    k = torch.zeros(b, s, kvh, d, dtype=dtype)
    if change == "cache view":
        k = torch.zeros(b, 1024, kvh, d, dtype=dtype)[:, :s]
    elif change == "misaligned base":
        k = torch.zeros(b * s * kvh * d + 1, dtype=dtype)[1:].view(b, s, kvh, d)
    elif change == "odd batch stride":
        k = torch.zeros(b, s * kvh * d + 1, dtype=dtype)[:, :-1].view(b, s, kvh, d)
    q, k = _inner_contiguous(q), _inner_contiguous(k)
    assert wgmma_takes(q, k, k, d ** -0.5 if scale is None else scale) is takes


def test_flash_cuda_takes_cuda_tensors_only():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, k, config=flash_tiles(torch.bfloat16, 8, 8, 64))


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header changes the library's name, so a stale
    build is never loaded."""
    import shutil

    from repro_torch.kernels import _build
    assert _build.includes("gemm") == ["hopper.cuh"]
    assert _build.includes("flash_attention") == ["hopper.cuh"]
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n) for n in _build.SOURCES}
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)


# every catalog arch with attention (all but mamba2-130m): its (d, H, KV) at
# full width
_ADMITTED = sorted(name for name, cfg in PORT_ARCHS.items() if cfg.num_heads)


@pytest.mark.parametrize("arch", _ADMITTED)
def test_flash_schedule_is_instantiated_at_every_admitted_head_dim(arch):
    """The bf16 schedule ``flash_tiles`` picks for the arch's prefill is
    instantiated at its head dim in ``dispatch_wgmma``'s lines, and the
    wrapper's path rule sends its (H, KV) group there; the f32 schedule
    (the exactness passes) is instantiated at its head dim in
    ``dispatch_fma``'s.  Before head dims 80 and 160 were instantiated,
    stablelm-12b (d 160) had neither and its flash prefill raised."""
    from repro_torch.kernels.flash_attention import (
        _inner_contiguous, instantiated_head_dims, wgmma_takes)
    cfg = PORT_ARCHS[arch]
    d, h, kvh = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    dims = instantiated_head_dims()
    for s in (8, 256, 1024, 1500, 4096):
        tile = flash_tiles(torch.bfloat16, s, s, d)
        assert tile.kernel == "wgmma"
        assert d in dims["wgmma"][(tile.bq, tile.bk, tile.stages)], tile.schedule
        f32 = flash_tiles(torch.float32, s, s, d)
        assert d in dims["fma"][(f32.bq, f32.bk, f32.stages)], f32.schedule
    q = _inner_contiguous(torch.zeros(2, 40, h, d, dtype=torch.bfloat16))
    k = _inner_contiguous(torch.zeros(2, 40, kvh, d, dtype=torch.bfloat16))
    assert wgmma_takes(q, k, k, d ** -0.5)


def test_whisper_unembed_takes_decode_and_wgmma():
    """whisper-large-v3's untied head (1280 x 51866, 51866 % 8 = 2) is
    stored K-major, which ``_aligned`` takes for ``decode`` at M = 8 and
    for ``wgmma`` at a prefill M; the row-major layout of the same weight
    would fall to WMMA for both."""
    from repro_torch.kernels.gemm import _aligned
    from repro_torch.models import build_model
    spec = build_model(PORT_ARCHS["whisper-large-v3"]).template["lm_head"]
    d, vocab = spec.shape
    assert spec.kmajor and vocab % 8
    head = torch.empty((vocab, d), dtype=torch.bfloat16).t()     # the layout
    row_major = torch.empty((d, vocab), dtype=torch.bfloat16)
    for m in (8, 8 * 300):
        tile = gemm_tiles(torch.bfloat16, m, d, vocab)
        assert tile.kernel == ("decode" if m == 8 else "wgmma")
        a = torch.empty((m, d), dtype=torch.bfloat16)
        assert _aligned(tile.kernel, a.data_ptr(), d, head.data_ptr(),
                        head.stride(0), head.stride(1), 1, d, vocab)
        assert not _aligned(tile.kernel, a.data_ptr(), d, row_major.data_ptr(),
                            row_major.stride(0), row_major.stride(1), 0, d,
                            vocab)
