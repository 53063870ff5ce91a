"""The boundaries the loop reads from the stream events alone agree with
the engine's own admissions and chunks (watched here from outside)."""
from __future__ import annotations

import pytest

from conftest import serve_tiny


def _watch(monkeypatch):
    """Count the engine's chunks and note the chunk after which each
    admitted request's first token comes."""
    from repro_torch.serve import engine
    seen = {"chunks": 0, "admitted": {}}
    admit, chunk = engine.Engine._admit_batch, engine.Engine._run_chunk

    def admit_batch(self, active, extra_inputs=None):
        before = {id(r) for r in active.values()}
        admit(self, active, extra_inputs)
        for r in active.values():
            if id(r) not in before:
                seen["admitted"][r.rid] = seen["chunks"] + 1

    def run_chunk(self):
        seen["chunks"] += 1
        return chunk(self)
    monkeypatch.setattr(engine.Engine, "_admit_batch", admit_batch)
    monkeypatch.setattr(engine.Engine, "_run_chunk", run_chunk)
    return seen


@pytest.mark.parametrize("clients,slots,outputs", [
    (6, 4, (8, 64)),        # a backlog, answers of one to eight chunks
    (3, 2, (4, 12)),        # passes in which every row ends
    (4, 4, (8, 40)),        # a client a slot
])
def test_stream_boundaries_are_the_engines(monkeypatch, clients, slots,
                                           outputs):
    seen = _watch(monkeypatch)
    loop, _, _ = serve_tiny("moe", clients, slots, 40, outputs)
    done = [q for q in loop.recs if q.t_done is not None]
    assert len(done) >= 40
    for q in done:
        assert q.first_boundary == seen["admitted"][q.handle.request_id]
        assert len(q.tokens) == q.spec.max_new
        # one delivery a pass, in consecutive passes
        ks = [d[2] for d in q.deliveries]
        assert ks == list(range(ks[0], ks[0] + len(ks)))
        assert sum(d[1] for d in q.deliveries) == len(q.tokens)
    assert loop.boundary <= seen["chunks"]
    assert loop.traffic.drawn_late == len(loop.recs) - 8


def _passes(times, t0, seconds=20.0):
    """Two requests, one 8-token block a pass each, passes at ``times``."""
    from harness import measure
    from harness.loop import Rec
    from harness.traffic import Spec
    recs = []
    for c in range(2):
        q = Rec(spec=Spec(index=c, client=c, prompt=(1, 2),
                         max_new=8 * len(times)),
                t_submit=0.0)
        q.deliveries = [[t, 8, k] for k, t in enumerate(times, 1)]
        recs.append(q)
    return measure.Record(cell="c", cfg={}, traffic={}, seconds=seconds,
                          t0=t0, t1=t0 + seconds, setup_s=0.0, recs=recs,
                          boundary_times=list(times), decode_chunk=8)


@pytest.mark.parametrize("t0", [1.0, 1.25, 1.6, 1.999])
def test_the_rate_counts_whole_passes_wherever_the_window_falls(t0):
    from harness import measure
    # a pass every 0.8 s
    r = _passes([0.8 * k for k in range(1, 40)], t0)
    assert measure.whole_pass_rate(r) == pytest.approx(16 / 0.8)
    # the window's tokens jump by a pass with where its ends fall
    assert measure.window_tokens(r) in (16 * 24, 16 * 25)


@pytest.mark.parametrize("at", ["opening", "close"])
def test_a_stall_at_either_end_of_the_window_counts(at):
    from harness import measure
    times = [0.8 * k for k in range(1, 40)]
    # 4 s more in the pass in flight at the window's opening or close
    k = 1 if at == "opening" else 26
    times = times[:k] + [t + 4.0 for t in times[k:]]
    r = _passes(times, 1.0)
    assert r.boundary_times[k - 1] <= r.t0 if at == "opening" else \
        r.boundary_times[k - 1] < r.t1 <= r.boundary_times[k]
    n_passes = 21 if at == "opening" else 26
    assert measure.whole_pass_rate(r) == pytest.approx(
        16 * n_passes / (0.8 * n_passes + 4.0))
    assert measure.whole_pass_rate(r) < 0.9 * 16 / 0.8


def test_the_rate_waits_for_the_pass_after_the_close():
    from harness import measure
    times = [0.8 * k for k in range(1, 28)]   # one boundary past t1 = 21
    assert measure.whole_pass_rate(_passes(times, 1.0)) is None
    assert measure.whole_pass_rate(_passes(times + [22.4], 1.0)) \
        == pytest.approx(16 / 0.8)
