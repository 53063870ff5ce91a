"""The port's checkpointer against the JAX package's on-disk format, both
ways: a state saved by either package restores in the other leaf for leaf
and bit for bit (bfloat16 included), and the two write the same manifest
for the same state.  Then the format's guards (crc32 corruption raises, a
``.tmp`` directory stays invisible, ``keep`` bounds the steps kept) and a
restart at step 3 that replays steps 4-6 bit for bit on the CPU."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import _flatten_with_paths  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import build_model, train_state_from_numpy  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig,  # noqa: E402
                               abstract_train_state, init_train_state,
                               make_train_step)

DTYPES = ["float32", "bfloat16"]


def _jax_state(dtype, compression=True):
    cfg = dataclasses.replace(ARCHITECTURES["llama3.2-1b"].reduced(),
                              dtype=dtype)
    return jax_init_train_state(jax_build_model(cfg), JAdamW(),
                                jax.random.PRNGKey(0),
                                use_compression=compression)


def _port_model(dtype):
    return build_model(dataclasses.replace(
        PORT_ARCHS["llama3.2-1b"].reduced(), dtype=dtype))


def _bits(x):
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.itemsize == 2 else arr


def _torch_bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_named(state):
    from repro.checkpoint.checkpointer import _flatten_with_paths as jflat
    return dict(jflat(state)[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_checkpoint_restores_into_the_port(tmp_path, dtype):
    js = _jax_state(dtype)
    JCheckpointer(str(tmp_path)).save(7, js)
    target = abstract_train_state(_port_model(dtype), AdamW(),
                                  use_compression=True)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 7
    ts = ck.restore(7, target, device="cpu")
    assert ts.params["embedding"].dtype == getattr(torch, dtype)
    assert ts.opt.m["embedding"].dtype == torch.float32
    want = _jax_named(js)
    got = dict(_flatten_with_paths(ts))
    assert set(got) == set(want) and len(got) == len(want)
    for name, t in got.items():
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(_torch_bits(t), _bits(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_checkpoint_restores_into_jax(tmp_path, dtype):
    js = _jax_state(dtype)
    ts = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                device="cpu")
    Checkpointer(str(tmp_path / "port")).save(3, ts)
    JCheckpointer(str(tmp_path / "jax")).save(3, js)
    with open(tmp_path / "port" / "step_00000003" / "manifest.json") as f:
        port_manifest = json.load(f)
    with open(tmp_path / "jax" / "step_00000003" / "manifest.json") as f:
        assert json.load(f) == port_manifest
    template = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), js)
    back = JCheckpointer(str(tmp_path / "port")).restore(3, template)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_state_without_compression_round_trips(tmp_path):
    model = _port_model("bfloat16")
    ts = init_train_state(model, AdamW(), 0, device="cpu")
    ck = Checkpointer(str(tmp_path))
    ck.save(1, ts)
    back = ck.restore(1, abstract_train_state(model, AdamW()), device="cpu")
    assert back.compression is None
    for (n, a), (_, b) in zip(_flatten_with_paths(back),
                              _flatten_with_paths(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_corrupted_leaf_raises(tmp_path):
    model = _port_model("float32")
    ts = init_train_state(model, AdamW(), 0, device="cpu")
    ck = Checkpointer(str(tmp_path))
    path = ck.save(2, ts)
    leaf = os.path.join(path, ".params__embedding.npy")
    arr = np.load(leaf)
    arr.flat[5] += 1.0
    np.save(leaf, arr)
    with pytest.raises(IOError, match="corruption"):
        ck.restore(2, abstract_train_state(model, AdamW()), device="cpu")


def test_tmp_directory_is_invisible_and_keep_bounds_the_steps(tmp_path):
    model = _port_model("float32")
    ts = init_train_state(model, AdamW(), 0, device="cpu")
    ck = Checkpointer(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "step_00000099.tmp")    # a save cut short
    assert ck.latest_step() is None
    for step in (1, 2, 3):
        ck.save(step, ts)
    assert ck.latest_step() == 3
    kept = sorted(d for d in os.listdir(tmp_path) if not d.endswith(".tmp"))
    assert kept == ["step_00000002", "step_00000003"]
    assert not any(d.startswith("step_00000003.") for d in
                   os.listdir(tmp_path))


def test_restart_at_step_3_replays_steps_4_to_6_bit_for_bit(tmp_path):
    model = _port_model("float32")
    opt = AdamW(learning_rate=3e-3)
    pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len=16,
                                    global_batch=4), device="cpu")
    cfg = TrainerConfig(total_steps=6, log_every=1, checkpoint_every=3)
    ck = Checkpointer(str(tmp_path))
    state, history = Trainer(model, opt, pipe, cfg, checkpointer=ck).run(
        init_train_state(model, opt, 0, device="cpu"))
    assert ck.latest_step() == 6
    restored = ck.restore(3, abstract_train_state(model, opt), device="cpu")
    assert int(restored.step) == 3
    again, replay = Trainer(model, opt, pipe, cfg).run(restored, start_step=3)
    assert replay == history[3:]
    for (n, a), (_, b) in zip(_flatten_with_paths(again),
                              _flatten_with_paths(state)):
        assert torch.equal(a, b), n
    # and one step by hand from the restored state equals step 4
    step = make_train_step(model, opt)
    s4, m4 = step(ck.restore(3, abstract_train_state(model, opt),
                             device="cpu"), pipe(3))
    assert float(m4["loss"]) == history[3][1]
