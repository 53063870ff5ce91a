"""Shared pieces of the benchmark's CPU tests: the import path and a tiny
cell of each family that drives a whole run on the CPU."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODELS = {
    "moe": dict(name="tiny-moe", family="moe", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=4, d_ff=32, vocab_size=256,
                rope_theta=10000.0, norm="rmsnorm", norm_eps=1e-5,
                num_experts=8, experts_per_token=2, moe_capacity_factor=1.25,
                attention_impl="flash"),
    "dense": dict(name="tiny-dense", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                  d_ff=96, vocab_size=256, rope_theta=10000.0,
                  rope_fraction=0.25, norm="layernorm", norm_eps=1e-5,
                  attention_impl="flash"),
}

TINY_TRAFFIC = {
    "loop": "closed", "clients": 6, "slots": 4, "max_len": 160,
    "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.6, "min": 8,
               "max": 64},
    "output": {"dist": "lognormal", "median": 24, "sigma": 0.6, "min": 8,
               "max": 64},
    "deck": 64, "trace": {"after_s": 0.3, "boundaries": 3},
    # every finished request is judged; in float32 the port and the
    # reference agree to rounding, the float8 control does not
    "check": {"sample": 1000, "min_tokens": 20, "mean_logit_gap": 0.001,
              "worst_request_gap": 0.001},
}

E2E = ["output_tok_s", "tpot_p95_ms", "ttft_p95_s", "prompt_tok_s",
       "setup_s"]


def tiny_cell(family: str, dtype: str = "float32"):
    from harness import catalog
    model = dict(TINY_MODELS[family], dtype=dtype)
    return catalog.Cell(
        name=f"tiny.{family}",
        config={"model": model,
                "engine": {"scheduler": "continuous", "decode_chunk": 8,
                           "prefix_cache": True}},
        traffic=copy.deepcopy(TINY_TRAFFIC), chips=1,
        end_to_end=[{"name": n, "unit": "u"} for n in E2E],
        per_layer=[{"name": "mfu.decode", "unit": "%"}])


def run_tiny(family: str, seconds: float = 2.0, **kw):
    import time

    import run as bench_run
    return bench_run.run_cell(tiny_cell(family), 2 ** 33 + 7, seconds,
                              kw.pop("trace", False), "cpu",
                              time.perf_counter(), **kw)


def serve_tiny(family: str, clients: int, slots: int, finished: int,
               outputs=None, seed: int = 2 ** 32 + 5):
    """A closed loop of ``clients`` over a tiny float32 cell on the CPU,
    run until ``finished`` requests are done: ``(loop, cfg, params)``."""
    import time

    import torch

    from harness import weights
    from harness.loop import ClosedLoop
    from harness.traffic import Traffic
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.server import Server

    t = dict(TINY_TRAFFIC, clients=clients, slots=slots)
    if outputs is not None:
        t["output"] = dict(t["output"], min=outputs[0], max=outputs[1],
                           median=(outputs[0] + outputs[1]) // 2)
    cfg = dict(TINY_MODELS[family], dtype="float32")
    model = build_model(ModelConfig(**cfg))
    params = weights.make(model.template, seed, torch.float32,
                          torch.device("cpu"))
    engine = Engine(model, params, ServeConfig(
        max_batch=slots, max_len=t["max_len"], scheduler="continuous",
        decode_chunk=8, prefix_cache=True, device="cpu"))
    traffic = Traffic(t, cfg["vocab_size"], seed)
    traffic.prepare(8)
    loop = ClosedLoop(Server, engine, traffic, slots, 8)
    loop.start(clients, min(clients, slots), timeout_s=120.0)
    deadline = time.perf_counter() + 120.0
    while (sum(q.t_done is not None for q in loop.recs) < finished
           and time.perf_counter() < deadline):
        time.sleep(0.01)
    loop.close()
    return loop, cfg, params


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the benchmark runs on the card")
    return torch.device("cuda")
