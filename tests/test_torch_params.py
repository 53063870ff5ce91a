"""The JAX -> torch weight bridge copies every leaf bit for bit, and the
port's own templates and seeded init follow the reference's shapes and
scales."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.models.params import ParamSpec, map_tree, tree_leaves  # noqa: E402


def _flat(tree):
    out = {}
    map_tree(lambda p, x: out.__setitem__(p, x), tree)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_copies_every_leaf_bit_exactly(dtype):
    cfg = dataclasses.replace(ARCHITECTURES["llama3.2-1b"].reduced(),
                              dtype=dtype)
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(1))
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = _flat(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    assert set(jflat) == set(tflat)
    for path, ref in jflat.items():
        got = tflat[path]
        assert got.dtype == getattr(torch, dtype), path
        assert tuple(got.shape) == ref.shape, path
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          ref.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)


def test_bridge_takes_uint16_views_of_bf16():
    x = np.array([1.0, -2.5, 3.140625], np.float32)
    bits = (x.view(np.uint32) >> 16).astype(np.uint16)   # exact in bf16
    t = params_from_numpy({"w": bits}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "chatglm3-6b",
                                  "stablelm-12b", "yi-9b"])
def test_template_matches_the_reference(arch):
    """Dense configs: same tree, shapes, init rules and scales as JAX."""
    jt = jax_build_model(ARCHITECTURES[arch].reduced()).template
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): spec
             for path, spec in jax.tree_util.tree_flatten_with_path(
                 jt, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    tflat = _flat(build_model(PORT_ARCHS[arch].reduced()).template)
    assert set(jflat) == set(tflat)
    for path, spec in tflat.items():
        ref = jflat[path]
        assert (spec.shape, spec.axes, spec.init, spec.scale) == \
            (ref.shape, ref.axes, ref.init, ref.scale), path


def test_init_is_seeded_and_at_reference_scales():
    model = build_model(PORT_ARCHS["llama3.2-1b"].reduced())
    a, b = model.init(3, device="cpu"), model.init(3, device="cpu")
    c = model.init(4, device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert not torch.equal(a["blocks"]["attn"]["wq"], c["blocks"]["attn"]["wq"])
    specs = _flat(model.template)
    for path, x in _flat(a).items():
        spec: ParamSpec = specs[path]
        if spec.init == "ones":
            assert torch.all(x == 1), path
            continue
        want = spec.scale or 1.0 / math.sqrt(spec.shape[-2])
        assert abs(x.float().std().item() / want - 1) < 0.1, path
    assert model.param_count() == sum(x.numel() for x in tree_leaves(a))


def test_build_model_refuses_unported_families():
    for arch in ("mamba2-130m", "olmoe-1b-7b", "whisper-large-v3",
                 "llama-3.2-vision-11b", "zamba2-2.7b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(PORT_ARCHS[arch].reduced())
