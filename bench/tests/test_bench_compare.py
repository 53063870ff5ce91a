"""The comparison that decides ``correct``, driven through whole runs of
tiny cells on the CPU (the look for a card skipped): the port against
the reference, the float8 control, and the faults a served model can
have, each planted in the timed path, which have to read as not
correct."""
from __future__ import annotations

import pytest
import torch

from conftest import TINY_TRAFFIC, run_tiny, serve_tiny

FAMILIES = ["moe", "dense"]


@pytest.mark.parametrize("family", FAMILIES)
def test_port_agrees_with_the_reference_and_the_control_does_not(family):
    res = run_tiny(family, control=True)
    c = res["checks"]
    assert res["correct"], c
    assert c["judged_tokens"]["value"] >= 20
    assert c["mean_logit_gap"]["value"] <= 1e-5
    assert c["worst_request_gap"]["value"] <= 1e-5
    # the reference in float8 in the program's place, judged by the same
    # limits, is not correct
    ctl = res["info"]["control"]
    assert ctl["correct"] is False
    assert ctl["checks"]["mean_logit_gap"]["value"] > \
        c["mean_logit_gap"]["limit"]
    assert res["failed"] == 0 and res["info"]["restarts"] == 0
    assert set(res["metrics"]) == {"output_tok_s", "tpot_p95_ms",
                                   "ttft_p95_s", "prompt_tok_s", "setup_s"}
    assert list(res)[-1] == "checks"


def _altered_token(monkeypatch):
    from repro_torch.serve import engine
    sample = engine.Engine._sample

    def bad(self, logits):
        out = sample(self, logits)
        out[0] = (out[0] + 1) % logits.shape[-1]
        return out
    monkeypatch.setattr(engine.Engine, "_sample", bad)


def _state_unchanged(monkeypatch):
    # a decode step that leaves the KV cache as it found it
    from repro_torch.models import layers
    write = layers._write_columns

    def bad(cache, off, new):
        if new.shape[1] > 1:
            write(cache, off, new)
    monkeypatch.setattr(layers, "_write_columns", bad)


def _half_the_batch(monkeypatch):
    # the decode step computes the first half of the rows; the rest
    # take the first half's logits
    from repro_torch.models import transformer
    step = transformer.decode_step

    def bad(cfg, params, tokens, cache, offset, kv_start=None):
        logits, cache = step(cfg, params, tokens, cache, offset, kv_start)
        h = logits.shape[0] // 2
        logits = torch.cat([logits[:h], logits[:logits.shape[0] - h]])
        return logits, cache
    monkeypatch.setattr(transformer, "decode_step", bad)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_the_batch])
@pytest.mark.parametrize("family", FAMILIES)
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, family,
                                                  fault):
    fault(monkeypatch)
    res = run_tiny(family)
    c = res["checks"]
    assert not res["correct"], c
    assert c["worst_request_gap"]["value"] > c["worst_request_gap"]["limit"]
    assert c["worst_request_gap"]["value"] >= c["mean_logit_gap"]["value"]


def test_one_request_altered_now_and_then_shows_in_its_own_mean():
    # a served token altered one step in eight, in one request alone: the
    # mean over every position moves little, that request's own mean more
    from harness import check, weights
    loop, cfg, params = serve_tiny("moe", 6, 4, 12)
    lim = dict(TINY_TRAFFIC["check"])
    w = weights.flat(params)

    def judge():
        return check.judge(cfg, lim, w, loop.recs, 0.0, float("inf"), 3,
                           0)[0]
    assert check.passed(judge())
    done = [q for q in loop.recs if q.t_done is not None]
    assert len(done) >= 12
    q = max(done, key=lambda q: len(q.tokens))
    q.tokens = [(t + 1) % cfg["vocab_size"] if j % 8 == 7 else t
                for j, t in enumerate(q.tokens)]
    bad = judge()
    assert not check.passed(bad)
    assert bad["worst_request_gap"]["value"] > lim["worst_request_gap"]
    assert bad["mean_logit_gap"]["value"] < \
        bad["worst_request_gap"]["value"] / 2


def test_traced_run_reads_no_device_metric_on_the_cpu():
    res = run_tiny("dense", trace=True)
    # a CPU trace has no device events: no device metric is written
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert res["correct"]
