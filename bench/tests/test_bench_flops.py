"""FLOP and byte counts worked by hand for one token of each
configuration."""
from __future__ import annotations

import json

import pytest

from conftest import BENCH
from harness import flops, peaks
from reference import moe


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]


def test_olmoe_one_token():
    cfg = _cfg("olmoe-widths-capdrop")
    # attention 4 x 2048 x 2048, router 2048 x 64, 8 experts x 3 x 2048 x
    # 1024, over 16 layers, and the head 2048 x 50304
    per_layer = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024
    assert per_layer == 67_239_936
    assert flops.matmul_params_per_token(cfg) == 16 * per_layer + 103_022_592
    assert flops.matmul_params_per_token(cfg) == 1_178_861_568
    # 4 x layers x heads x head_dim = 131,072 FLOP a key of context
    assert flops.decode_token_flops(cfg, 1000) == \
        2 * 1_178_861_568 + 131_072 * 1000
    # a decoded token is a routing group of one: 8 slots, nothing dropped
    assert moe.capacity(cfg, 1) == 8
    assert moe.capacity(cfg, 1024) == 160


def test_stablelm_one_token():
    cfg = _cfg("stablelm2-widths-seqres")
    # q, o 5120 x 5120; k, v 5120 x 1280; MLP 3 x 5120 x 13824
    per_layer = 2 * 5120 * 5120 + 2 * 5120 * 1280 + 3 * 5120 * 13824
    assert per_layer == 277_872_640
    n = 40 * per_layer + 5120 * 100352
    assert flops.matmul_params_per_token(cfg) == n == 11_628_707_840
    assert flops.decode_token_flops(cfg, 10) == 2 * n + 819_200 * 10
    # a prompt: every token through the stack, causal pairs, one logit row
    assert flops.prompt_flops(cfg, 3) == \
        2 * 40 * per_layer * 3 + 2 * 5120 * 100352 + 819_200 * 6


def test_bounds():
    cfg = _cfg("stablelm2-widths-seqres")
    # one decode step at one row is bound by reading the weights
    t = flops.decode_step_gemm_bound_s(cfg, [1])
    weights = flops.matmul_params_per_token(cfg) * 2
    assert weights / peaks.HBM_BYTES_S <= t <= 1.01 * weights / peaks.HBM_BYTES_S
    # a long prefill is bound by compute
    n = 4096
    t = flops.prefill_gemm_bound_s(cfg, [n])
    fl = 2 * 40 * 277_872_640 * n
    # the head's one row of logits is bound by reading its weight
    head = (5120 * 100352 * 2 + 5120 * 2 + 100352 * 4) / peaks.HBM_BYTES_S
    assert t == pytest.approx(fl / peaks.BF16_FLOPS + head, rel=1e-6)
    a = flops.prefill_attention_bound_s(cfg, [n])
    assert a == pytest.approx(40 * 4 * 32 * 160 * n * (n + 1) / 2
                              / peaks.BF16_FLOPS, rel=1e-9)
    moe = _cfg("olmoe-widths-capdrop")
    assert flops.touched_experts(moe, 32 * 8) == pytest.approx(
        64 * (1 - (56 / 64) ** 32))
