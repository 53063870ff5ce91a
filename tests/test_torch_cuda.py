"""On the card: each CUDA kernel against its plain PyTorch version, and the
engine's kernels on the serving path.  Needs no JAX, so it runs on the GPU
machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips (decided at run time, in a fixture).
Tolerances: float32 GEMM atol=rtol=1e-4 (summation order over K up to 2048),
float32 flash 1e-5; bfloat16 outputs 2e-2 (one bf16 ulp).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.tile_config import flash_tiles, gemm_tiles  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ACTIVATIONS = [None, "relu", "gelu", "silu", "tanh"]
BF16 = dict(atol=2e-2, rtol=2e-2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,transposed", [
    (8, 2048, 512, False), (37, 100, 77, True), (300, 256, 192, False)])
def test_cuda_gemm_matches_plain_version(cuda, dtype, m, k, n, transposed):
    from repro_torch.kernels.gemm import gemm_cuda
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    b = torch.randn(n, k, generator=gen, device=cuda).to(dtype) * k ** -0.5
    b = b.t() if transposed else b.t().contiguous()
    c = torch.randn(m, n, generator=gen, device=cuda)
    bias = torch.randn(n, generator=gen, device=cuda)
    for act in ACTIVATIONS:
        kw = dict(alpha=0.5, beta=2.0, bias=bias, activation=act)
        before = gemm_cuda.launches
        got = gemm_cuda(a, b, c, config=gemm_tiles(dtype, m, k, n), **kw)
        assert gemm_cuda.launches == before + 1
        want = ref.gemm_ref(a, b, c, **kw)
        torch.cuda.synchronize()
        tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else BF16
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_plain_version(cuda, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, s, h, kvh, d = 4, 200, 32, 8, 64
    q = torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, s, kvh, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, s, kvh, d, generator=gen, device=cuda).to(dtype)
    ks = torch.tensor([0, 13, 199, 200], dtype=torch.int32, device=cuda)
    tile = flash_tiles(s, s, d)
    got = flash_attention_cuda(q, k, v, bq=tile.bq, bk=tile.bk, kv_start=ks)
    want = ref.flash_attention_ref(q, k, v, kv_start=ks)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)


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
