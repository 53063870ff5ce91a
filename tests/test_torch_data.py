"""The port's token pipeline against the JAX package's: the same batches,
token for token, for several (seed, step) pairs, from the synthetic and
the file source; each batch a pure function of (seed, step)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402

PAIRS = [(0, 0), (0, 1), (0, 17), (3, 0), (3, 5), (12345, 99)]


def _both(**kw):
    return (JTokenPipeline(JDataConfig(**kw)),
            TokenPipeline(DataConfig(**kw), device="cpu"))


def _equal(tb, jb):
    for k in ("tokens", "labels"):
        assert tb[k].dtype == torch.int32 and tb[k].is_contiguous()
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("seed,step", PAIRS)
def test_synthetic_batches_match_jax(seed, step):
    jp, tp = _both(vocab_size=1000, seq_len=24, global_batch=4, seed=seed)
    _equal(tp(step), jp(step))


@pytest.mark.parametrize("seed,step", PAIRS)
def test_file_batches_match_jax(tmp_path, seed, step):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(7).integers(0, 50000, 4096).astype(
        np.int32).tofile(path)
    jp, tp = _both(vocab_size=300, seq_len=16, global_batch=3, seed=seed,
                   source="file", path=str(path))
    _equal(tp(step), jp(step))


def test_batches_are_a_pure_function_of_seed_and_step():
    _, tp = _both(vocab_size=500, seq_len=8, global_batch=2, seed=1)
    _, again = _both(vocab_size=500, seq_len=8, global_batch=2, seed=1)
    a, b = tp(4), again(4)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(tp(5)["tokens"], a["tokens"])
    it = tp.iterate(3)
    assert torch.equal(next(it)["tokens"], tp(3)["tokens"])
    assert torch.equal(next(it)["tokens"], a["tokens"])
    # labels are the next tokens
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_file_source_needs_a_path_and_default_device_is_the_card():
    with pytest.raises(ValueError, match="path"):
        TokenPipeline(DataConfig(vocab_size=8, seq_len=4, global_batch=1,
                                 source="file"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TokenPipeline(DataConfig(vocab_size=8, seq_len=4, global_batch=1))
