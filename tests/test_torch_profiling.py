"""The port's profiling layer, case by case as ``tests/test_profiling.py``
holds the reference's: the strict no-op when off, a real capture on the
CPU that parses into a schema-valid breakdown, the family classifier on
torch kernel and aten names, the summary of synthetic events in the
layout ``torch.profiler`` writes (device events on the card, nested
``cpu_op`` events without one), the PROFILE schema gate, and the serve
engine's one host transfer per wave and per chunk with its markers
traced.  Against the JAX package: a blob the port builds passes the
reference's ``validate_profile``, and both validators give the same
verdict on the same broken blobs.  ``scripts/torch_profile.py train`` /
``serve`` / ``diff`` run as subprocesses at reduced size on the CPU.
"""
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import profiling as jax_profiling  # noqa: E402
from repro_torch.configs.catalog import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.profiling import (FAMILIES, PROFILE_SCHEMA_VERSION,  # noqa: E402
                                   annotate, build_profile,
                                   classify_event_name, load_trace_events,
                                   summarize_events, trace, validate_profile)
from repro_torch.profiling import tracer  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "torch_profile.py"


# ---------------------------------------------------------------------------
# trace(...) capture
# ---------------------------------------------------------------------------

def test_trace_disabled_is_strict_noop(tmp_path, monkeypatch):
    """Off = OFF: no directory, no environment change, no profiler
    started, an inert session."""
    target = tmp_path / "never-created"
    env_before = dict(os.environ)
    started = []
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda *a, **k: started.append(1))
    with trace(str(target), enabled=False) as s:
        torch.square(torch.arange(4.0))
    assert not s.enabled and s.dir is None
    assert s.trace_files() == [] and s.events() == []
    assert not target.exists()
    with trace(None) as s:            # a falsy dir disables too
        pass
    assert not s.enabled
    assert started == []
    assert dict(os.environ) == env_before


def test_trace_captures_parseable_breakdown(tmp_path):
    """A real (tiny) capture on the CPU round-trips: a Chrome trace lands
    in a capture directory under the session dir, parses with the stdlib
    loader and rolls up into a schema-valid blob (host op time,
    ``timeline: host``) with the annotated span present."""
    target = tmp_path / "cap"
    x = torch.ones((64, 64))
    x @ x                                   # warm outside the trace
    with trace(str(target)) as s:
        with annotate("serve.unit_test_span"):
            (x @ x).relu().sum().item()
    files = s.trace_files()
    assert s.enabled and len(files) == 1
    assert files[0].endswith(".pt.trace.json")
    assert Path(files[0]).parent.parent == target
    events = load_trace_events(str(target))
    assert events and s.events() == events
    blob = build_profile("serving", events=events, hardware="cpu")
    validate_profile(blob)
    assert blob["schema_version"] == PROFILE_SCHEMA_VERSION
    assert set(blob["families"]) == set(FAMILIES)
    assert blob["timeline"] == "host"
    assert blob["totals"]["op_us"] > 0
    assert blob["families"]["gemm"]["count"] >= 1          # aten::mm
    assert blob["annotations"]["serve.unit_test_span"]["count"] == 1
    json.dumps(blob)


def test_each_trace_is_a_capture_of_its_own(tmp_path):
    """Two traces into one dir: two captures, the newest one read."""
    for name in ("serve.first", "serve.second"):
        with trace(str(tmp_path)):
            with annotate(name):
                torch.ones(4).sum()
    s = tracer.TraceSession(dir=str(tmp_path), enabled=True)
    assert len(s.trace_files()) == 2
    assert list(summarize_events(s.events())["annotations"]) == [
        "serve.second"]


def test_load_trace_events_reads_a_gzipped_capture(tmp_path):
    """A capture the profiler's handler wrote with ``use_gzip=True``."""
    import gzip
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
               "dur": 5.0}]
    with gzip.open(tmp_path / "h_1.2.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    assert load_trace_events(str(tmp_path)) == events


def test_load_trace_events_raises_on_empty_dir(tmp_path):
    """An empty trace dir is an error, not an empty breakdown."""
    with pytest.raises(FileNotFoundError):
        load_trace_events(str(tmp_path))


def test_a_capture_with_card_activity_but_no_device_event_raises(
        tmp_path, monkeypatch):
    """On a machine with a card, ``trace`` asks for CUDA activity; a
    capture that comes back without a device event (here: this CPU build,
    which cannot trace a card) raises instead of passing host op time off
    as the card's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(RuntimeError, match="no device event"):
        with trace(str(tmp_path)):
            torch.ones(8).sum()


# ---------------------------------------------------------------------------
# classifier + summarizer on synthetic events
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,family", [
    ("void gemm_wgmma_kernel<128, 256, 3, 2>(CUtensorMap, CUtensorMap)",
     "gemm"),
    ("void gemm_decode_kernel<64, 4>(__nv_bfloat16 const*, long long)",
     "gemm"),
    ("void gemm_f32_kernel<64, 64, 16>(float const*, long long)", "gemm"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64>(Params)",
     "gemm"),
    ("void gemv2T_kernel_val<int, int, float, 128, 16>(float const*)", "gemm"),
    ("void flash_fwd_wgmma_kernel<2, 128, 64, 2>(CUtensorMap)", "attention"),
    ("void flash_fwd_kernel<float, 64, 64>(float const*)", "attention"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, 9>()",
     "attention"),
    ("void cunn_SoftMaxForward<4, float, float>(float*, float const*)",
     "attention"),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage)",
     "collective"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)",
     "collective"),
    ("c10d::allreduce_", "collective"),
    ("_c10d_functional::all_gather_into_tensor", "collective"),
    ("_c10d_functional::wait_tensor", "collective"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>(int)", "other"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float>()",
     "other"),
    ("aten::mm", "gemm"), ("aten::bmm", "gemm"), ("aten::addmm", "gemm"),
    ("aten::einsum", "gemm"), ("aten::_softmax", "attention"),
    ("aten::mul", "other"), ("aten::copy_", "other"),
    ("aten::index_select", "other"),
])
def test_classify_event_name_families(name, family):
    assert classify_event_name(name) == family


def _ev(name, dur, ts, cat, **args):
    return {"ph": "X", "cat": cat, "name": name, "dur": dur, "ts": ts,
            "pid": 1, "tid": 1, "args": args}


def _device_events():
    """One train-like step as ``torch.profiler`` lays it out on the card:
    host ops and ranges with their External ids, runtime launches and
    device events carrying the launching op's External id and a
    correlation."""
    k1 = "void gemm_wgmma_kernel<128, 256, {}>(CUtensorMap, CUtensorMap)"
    return [
        _ev("PyTorch Profiler (0)", 10_000.0, 0, "Trace"),
        _ev("train.step", 900.0, 100, "user_annotation", **{"External id": 1}),
        _ev("train.step", 800.0, 150, "gpu_user_annotation",
            **{"External id": 1}),
        _ev("matmul.forward", 100.0, 110, "user_annotation",
            **{"External id": 2}),
        _ev("repro_torch::gemm", 90.0, 115, "cpu_op", **{"External id": 3}),
        _ev("cudaLaunchKernel", 5.0, 120, "cuda_runtime", correlation=11,
            **{"External id": 3}),
        _ev(k1.format(3), 300.0, 200, "kernel", correlation=11,
            **{"External id": 3}),
        _ev("GemmBackward", 50.0, 300, "cpu_op", **{"External id": 4}),
        _ev("matmul.dX", 40.0, 305, "user_annotation", **{"External id": 8}),
        _ev("cudaLaunchKernel", 5.0, 310, "cuda_runtime", correlation=12,
            **{"External id": 4}),
        _ev(k1.format(4), 200.0, 500, "kernel", correlation=12,
            **{"External id": 4}),
        _ev("aten::bmm", 20.0, 400, "cpu_op", **{"External id": 5}),
        _ev("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", 150.0, 700,
            "kernel", correlation=13, **{"External id": 5}),
        _ev("aten::_softmax", 10.0, 420, "cpu_op", **{"External id": 6}),
        _ev("void cunn_SoftMaxForward<4, float, float>()", 40.0, 850,
            "kernel", correlation=14, **{"External id": 6}),
        _ev("aten::copy_", 10.0, 440, "cpu_op", **{"External id": 7}),
        _ev("Memcpy HtoD (Pageable -> Device)", 3.0, 890, "gpu_memcpy",
            correlation=15, **{"External id": 7}),
        _ev("Memcpy DtoH (Device -> Pageable)", 7.0, 895, "gpu_memcpy",
            correlation=16, **{"External id": 7}),
        _ev("Memcpy DtoD (Device -> Device)", 5.0, 902, "gpu_memcpy",
            correlation=17, **{"External id": 7}),
        _ev("Memset (Device)", 1.0, 907, "gpu_memset", correlation=18),
        {"ph": "M", "name": "process_name", "pid": 1},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 11, "ts": 200},
    ]


def test_summarize_events_synthetic_device():
    s = summarize_events(_device_events())
    fams = s["families"]
    assert s["timeline"] == "device"
    assert fams["gemm"] == {"us": 650.0, "count": 3,
                            "fraction": pytest.approx(650 / 706, abs=1e-6)}
    assert fams["attention"]["us"] == 40.0
    assert fams["host_transfer"] == {"us": 10.0, "count": 2,
                                     "fraction": pytest.approx(10 / 706,
                                                               abs=1e-6)}
    assert fams["other"]["us"] == 6.0 and fams["other"]["count"] == 2
    assert s["host_syncs"] == 1                 # the DtoH copy alone
    assert s["totals"]["op_us"] == 696.0        # device events, no transfers
    assert s["totals"]["family_us"] == 706.0
    # the template instantiations fold into one kernel
    assert s["top_ops"][0] == {"name": "gemm_wgmma_kernel", "us": 500.0,
                               "count": 2}
    # launching op: the cpu_op, never a range; an event launched under no
    # op is named by itself
    assert s["device_us_by_launching_op"] == {
        "repro_torch::gemm": 300.0, "GemmBackward": 200.0, "aten::bmm": 150.0,
        "aten::_softmax": 40.0, "aten::copy_": 15.0, "Memset": 1.0}
    assert s["annotations"] == {"train.step": {"us": 900.0, "count": 1}}
    assert s["totals"]["wall_us"] == 900.0      # 100 .. 1000, Trace excluded


def test_summarize_events_synthetic_host():
    """Without a device event, each cpu_op counts by its self time: a
    nested op's time is not counted twice."""
    events = [
        _ev("aten::einsum", 100.0, 0, "cpu_op"),
        _ev("aten::bmm", 80.0, 10, "cpu_op"),
        _ev("aten::resolve_conj", 5.0, 12, "cpu_op"),
        _ev("aten::mul", 30.0, 100, "cpu_op"),
        _ev("aten::mul", 10.0, 0, "cpu_op", **{}) | {"tid": 2},
        _ev("serve.decode_chunk", 140.0, 0, "user_annotation"),
    ]
    s = summarize_events(events)
    assert s["timeline"] == "host"
    assert s["families"]["gemm"]["us"] == 95.0     # einsum 20 + bmm 75
    assert s["families"]["other"]["us"] == 45.0    # resolve_conj 5 + mul 40
    assert s["totals"]["op_us"] == 140.0
    assert s["device_us_by_launching_op"]["aten::bmm"] == 75.0
    assert s["annotations"]["serve.decode_chunk"]["count"] == 1


def test_a_card_trace_without_device_events_fails_the_schema():
    """CUDA runtime events but no device event: the card was traced and
    its time is missing, so the totals are 0 and the blob is refused
    (the host ops are not counted in its place)."""
    events = [e for e in _device_events()
              if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset")]
    blob = build_profile("training", events=events)
    assert blob["timeline"] == "device"
    with pytest.raises(ValueError, match="op_us"):
        validate_profile(blob)


def test_summarize_fractions_sum_to_one():
    s = summarize_events([_ev("aten::mm", 75.0, 0, "cpu_op"),
                          _ev("aten::add", 25.0, 100, "cpu_op")])
    assert sum(e["fraction"] for e in s["families"].values()) == \
        pytest.approx(1.0)
    assert s["families"]["gemm"]["fraction"] == pytest.approx(0.75)


# ---------------------------------------------------------------------------
# PROFILE schema validation, against the reference's too
# ---------------------------------------------------------------------------

def _valid_blob():
    return build_profile("serving", events=_device_events(), hardware="h100")


def test_validate_profile_accepts_and_returns_blob():
    blob = _valid_blob()
    assert validate_profile(blob) is blob


def test_validate_profile_lists_every_violation():
    blob = _valid_blob()
    blob["schema_version"] = 99
    del blob["families"]["gemm"]
    blob["host_syncs"] = -1
    with pytest.raises(ValueError) as e:
        validate_profile(blob)
    msg = str(e.value)
    assert "schema_version" in msg
    assert "families['gemm'] missing" in msg
    assert "host_syncs" in msg


def test_validate_profile_rejects_empty_capture():
    blob = build_profile("serving", events=[])
    with pytest.raises(ValueError) as e:
        validate_profile(blob)
    assert "op_us" in str(e.value) and "wall_us" in str(e.value)


def test_port_blob_passes_the_reference_validator(tmp_path):
    """The port's blobs, from the card's layout and from a real CPU
    capture, are valid PROFILE files for the reference's gate."""
    with trace(str(tmp_path)):
        torch.ones((32, 32)) @ torch.ones((32, 32))
    for blob in (_valid_blob(), build_profile("training",
                                              trace_dir=str(tmp_path))):
        validate_profile(blob)
        assert jax_profiling.validate_profile(
            json.loads(json.dumps(blob))) is not None


def _break(blob, how):
    blob = copy.deepcopy(blob)
    if how == "version":
        blob["schema_version"] = 2
    elif how == "kind":
        blob["kind"] = ""
    elif how == "family":
        del blob["families"]["attention"]
    elif how == "negative":
        blob["families"]["other"]["us"] = -1.0
    elif how == "zero_op":
        blob["totals"]["op_us"] = 0.0
    elif how == "wall":
        del blob["totals"]["wall_us"]
    elif how == "syncs":
        blob["host_syncs"] = 1.5
    elif how == "annotations":
        blob["annotations"] = []
    elif how == "top_ops":
        del blob["top_ops"]
    return blob


@pytest.mark.parametrize("how", [None, "version", "kind", "family",
                                 "negative", "zero_op", "wall", "syncs",
                                 "annotations", "top_ops"])
def test_both_validators_give_the_same_verdict(how):
    blob = _break(_valid_blob(), how)

    def verdict(validate):
        try:
            validate(blob)
        except ValueError as e:
            return str(e)
        return None
    port, ref = verdict(validate_profile), verdict(
        jax_profiling.validate_profile)
    assert port == ref
    assert (port is None) == (how is None)


# ---------------------------------------------------------------------------
# the engine, trainer and oracle under tracing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_llama():
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg)
    return model, model.init(1, device="cpu")


PROMPTS = [[5, 9, 2], [1, 3, 3], [2, 4, 6]]       # 3 prompts, 2 slots


def _fetches(monkeypatch):
    """Counts the engine's device-to-host fetches (``Tensor.cpu``)."""
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: (
        calls.append(1), real(t, *a, **k))[1])
    return calls


def _traced_drain(tmp_path, monkeypatch, eng, unit):
    eng.generate(PROMPTS, 4)                           # warm, not counted
    eng.clear_prefix_cache()
    before = eng.stats()
    calls = _fetches(monkeypatch)
    with trace(str(tmp_path / "cap")) as s:
        eng.generate(PROMPTS, 4)
    st = eng.stats()
    units = st[unit] - before[unit]
    assert st["device_transfers"] - before["device_transfers"] == units
    assert len(calls) == units                        # one fetch a unit
    return units, st, before, summarize_events(s.events())["annotations"]


def test_wave_scheduler_one_transfer_per_wave_under_tracing(
        tmp_path, monkeypatch, reduced_llama):
    """The markers do not change the execution model: with a trace
    active the wave scheduler still fetches once a wave, and the capture
    holds one ``serve.prefill_wave`` and one ``serve.decode_wave`` a
    wave."""
    eng = Engine(*reduced_llama, ServeConfig(max_batch=2, max_len=64,
                                             scheduler="wave", device="cpu"))
    waves, _, _, ann = _traced_drain(tmp_path, monkeypatch, eng, "waves")
    assert waves == 2
    assert ann["serve.prefill_wave"]["count"] == waves
    assert ann["serve.decode_wave"]["count"] == waves


def test_continuous_scheduler_one_transfer_per_chunk_under_tracing(
        tmp_path, monkeypatch, reduced_llama):
    """The same for the continuous scheduler: one fetch a chunk, one
    ``serve.decode_chunk`` a chunk, one ``serve.prefill_admit`` an
    admission prefill."""
    eng = Engine(*reduced_llama, ServeConfig(max_batch=2, max_len=64,
                                             decode_chunk=2, device="cpu"))
    chunks, st, before, ann = _traced_drain(tmp_path, monkeypatch, eng,
                                            "chunks")
    assert chunks >= 2
    assert ann["serve.decode_chunk"]["count"] == chunks
    assert ann["serve.prefill_admit"]["count"] == (
        st["admission_prefills"] - before["admission_prefills"])


def test_prefix_hits_restore_under_their_marker(tmp_path, reduced_llama):
    """A warm drain of repeated prompts restores full prefix hits under
    ``serve.prefix_restore``, without a prefill."""
    eng = Engine(*reduced_llama, ServeConfig(max_batch=4, max_len=64,
                                             device="cpu"))
    eng.generate(PROMPTS, 4)
    with trace(str(tmp_path)) as s:
        eng.generate(PROMPTS, 4)
    ann = summarize_events(s.events())["annotations"]
    assert ann["serve.prefix_restore"]["count"] >= 1
    assert "serve.prefill_admit" not in ann


def test_trainer_and_oracle_markers(tmp_path, reduced_llama):
    """``Trainer.run`` marks each step ``train.step``; the per-prompt
    oracle marks each prefill and decode step, as the reference's."""
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.optim import AdamW
    from repro_torch.serve.reference import generate_per_prompt
    from repro_torch.train import Trainer, TrainerConfig, init_train_state

    model, params = reduced_llama
    opt = AdamW(learning_rate=1e-3)
    pipe = TokenPipeline(DataConfig(vocab_size=model.cfg.vocab_size,
                                    seq_len=8, global_batch=2), device="cpu")
    trainer = Trainer(model, opt, pipe, TrainerConfig(total_steps=2))
    with trace(str(tmp_path / "train")) as s:
        trainer.run(init_train_state(model, opt, 0, device="cpu"))
    assert summarize_events(s.events())["annotations"]["train.step"][
        "count"] == 2
    with trace(str(tmp_path / "oracle")) as s:
        generate_per_prompt(model, params, PROMPTS[:2], 3, max_len=32)
    names = [e["name"] for e in s.events()
             if e.get("cat") == "user_annotation"]
    assert names.count("reference.prefill") == 2
    assert names.count("reference.decode") == 2 * 2


# ---------------------------------------------------------------------------
# scripts/torch_profile.py
# ---------------------------------------------------------------------------

def _script(*args, cwd):
    proc = subprocess.run(
        [sys.executable, str(SCRIPT), *args], cwd=cwd, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_profile_script_train_serve_and_diff(tmp_path):
    """``train --steps 1`` and ``serve`` on reduced llama on the CPU write
    PROFILE files both validators accept, with the steps and chunks
    annotated and the roofline of the step profiled beside the breakdown
    (a train step of 2 x 16, a decode step of 2 rows over the 256-token
    cache, on the ``cpu`` profile), printed; ``diff`` reads the port's and
    the reference's files."""
    out = _script("train", "--device", "cpu", "--steps", "1", "--batch", "2",
                  "--seq-len", "16", "--out", "t.json", cwd=tmp_path)
    assert "[roofline] analytic bounds on cpu (1 chip(s))" in out
    out = _script("serve", "--device", "cpu", "--batch", "2", "--plen", "5",
                  "--max-new", "4", "--out", "s.json", cwd=tmp_path)
    assert "serve.decode_chunk" in out
    assert "[roofline] analytic bounds on cpu (1 chip(s))" in out
    train = json.loads((tmp_path / "t.json").read_text())
    serve = json.loads((tmp_path / "s.json").read_text())
    for blob, kind, model_flops in (
            (train, "train", 6 * 2 * 16), (serve, "decode", 2 * 2)):
        validate_profile(blob)
        jax_profiling.validate_profile(blob)
        assert blob["mesh"] is None
        assert blob["timeline"] == "host"
        roof = blob["roofline"]
        assert roof["hardware"] == "cpu" and roof["kind"] == kind
        assert roof["chips"] == 1 and roof["collective_s"] == 0
        assert roof["est_step_s"] == max(roof["compute_s"], roof["memory_s"])
        assert roof["est_step_s"] > 0
        # MODEL_FLOPS = 6 N D (train) or 2 N B (decode), N the parameters
        assert roof["model_flops"] % model_flops == 0
    assert train["steps_traced"] == 1
    assert train["annotations"]["train.step"]["count"] == 1
    assert serve["annotations"]["serve.decode_chunk"]["count"] == \
        serve["engine"]["chunks"] == serve["engine"]["device_transfers"]
    ref = jax_profiling.build_profile("serving", events=[
        {"ph": "X", "name": "x", "dur": 10.0, "ts": 0,
         "args": {"hlo_op": "dot.1"}}])
    (tmp_path / "ref.json").write_text(json.dumps(ref))
    out = _script("diff", "ref.json", "s.json", cwd=tmp_path)
    assert "host syncs: 0 -> 0" in out
    for fam in FAMILIES:
        assert fam in out


def test_profile_script_has_the_reference_defaults():
    """``--arch``, ``--full``, ``--batch``, ``--plen``, ``--max-new``,
    ``--max-len``, ``--steps`` and ``--seq-len`` default as in
    ``scripts/profile.py``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_profile", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    serve = vars(mod.build_parser().parse_args(["serve"]))
    train = vars(mod.build_parser().parse_args(["train"]))
    assert {k: serve[k] for k in ("arch", "full", "batch", "plen", "max_new",
                                  "max_len")} == dict(
        arch="llama3.2-1b", full=False, batch=8, plen=16, max_new=16,
        max_len=256)
    assert {k: train[k] for k in ("steps", "seq_len", "batch")} == dict(
        steps=2, seq_len=32, batch=8)


def test_profile_script_on_a_mesh_labels_it_and_counts_collectives(
        tmp_path):
    """``serve --mesh data=2,model=2`` under ``torchrun`` (4 gloo ranks on
    the CPU): rank 0 writes one PROFILE file, valid for both validators,
    whose ``mesh`` is the mesh's label and whose ``collective`` family
    holds the c10d ops; the other ranks print nothing."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", str(SCRIPT), "serve", "--device", "cpu",
           "--batch", "4", "--plen", "5", "--max-new", "4", "--mesh",
           "data=2,model=2", "--out", "m.json"]
    proc = subprocess.Popen(cmd, cwd=tmp_path, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                                     OMP_NUM_THREADS="1"))
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
    assert proc.returncode == 0, (out + err)[-3000:]
    assert out.count("[profile] wrote m.json") == 1
    blob = json.loads((tmp_path / "m.json").read_text())
    validate_profile(blob)
    jax_profiling.validate_profile(blob)
    assert blob["mesh"] == "data2xmodel2"
    assert blob["families"]["collective"]["count"] > 0
    assert blob["engine"]["chunks"] == blob["engine"]["device_transfers"]
