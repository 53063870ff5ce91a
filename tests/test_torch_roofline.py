"""The port's roofline (``repro_torch.launch.roofline``), its shape cells
(``configs.base``), ``models.model.active_param_count`` and the ``h100``
profile's link rate, against the reference's; and the two CLIs.

``roofline_row`` is held against the reference's on the same counts and
peaks (the reference's profile built with the ``h100`` numbers), exactly:
where every flop is bf16 every key of the reference's row is equal; where
some are f32 the port's compute term sums each dtype over its own peak and
keeps the reference's bf16-peak term beside it.  ``markdown_table`` and
``perf_compare`` render the same rows the same way, character for
character.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.catalog import ARCHITECTURES as REF_ARCHS  # noqa: E402
from repro.core import hardware as ref_hw  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.catalog import get_config  # noqa: E402
from repro_torch.core.hardware import H100, get_profile  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.dryrun import cell_record  # noqa: E402
from repro_torch.models import model  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

#: the reference's profile with the h100 profile's peaks and rates
REF_H100 = ref_hw.HardwareProfile(
    name="h100", platform="gpu", peak_flops=dict(H100.peak_flops),
    hbm_bandwidth=H100.hbm_bandwidth, vmem_bytes=H100.smem_bytes,
    ici_link_bandwidth=H100.link_bandwidth, hbm_bytes=H100.hbm_bytes)


def test_shape_cells_equal_the_references():
    assert list(base.SHAPES) == list(ref_base.SHAPES)
    for name, ref in ref_base.SHAPES.items():
        got = base.SHAPES[name]
        assert (got.name, got.seq_len, got.global_batch, got.kind,
                got.tokens) == (ref.name, ref.seq_len, ref.global_batch,
                                ref.kind, ref.tokens)
    assert base.TRAIN_4K == base.SHAPES["train_4k"]
    assert base.LONG_500K.seq_len == 524_288


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_applicable_shapes_and_active_params_equal_the_references(arch):
    """long_500k only for the sub-quadratic families; N_active counts a
    MoE's top-k experts only (full configs: templates, nothing drawn)."""
    ref_cfg, cfg = REF_ARCHS[arch], get_config(arch)
    assert [s.name for s in base.applicable_shapes(cfg)] == [
        s.name for s in ref_base.applicable_shapes(ref_cfg)]
    want = ref_model.active_param_count(ref_model.build_model(ref_cfg))
    got = model.active_param_count(model.build_model(cfg))
    assert got == want
    if cfg.num_experts:
        assert got < model.build_model(cfg).param_count()


def test_h100_link_rate_is_one_nvlink4_link():
    """NVLink 4 on the H100 SXM: 900 GB/s over 18 links."""
    assert H100.link_bandwidth == 900e9 / 18 == 50e9
    assert get_profile("cpu").link_bandwidth > 0


def _ref_record(rec):
    """The same counts as the reference's dry-run record (``hlo_stats``)."""
    ss = rec["step_stats"]
    out = {k: v for k, v in rec.items() if k != "step_stats"}
    out["hlo_stats"] = {k: ss[k] for k in (
        "flops", "traffic_bytes", "collective_link_bytes",
        "collective_count")}
    return out


def _bf16_only(rec):
    """``rec`` with every product counted at bf16 (the reference's one
    peak), the other counts as they are."""
    rec = json.loads(json.dumps(rec))
    rec["step_stats"]["flops_by_dtype"] = {
        "bfloat16": rec["step_stats"]["flops"]}
    return rec


@pytest.fixture(scope="module")
def records():
    """Real records of reduced bf16 llama: a train step (bf16 and f32
    products, the f32 ones the attention scores and the unembed's
    backward) and a decode step."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              dtype="bfloat16")
    train = cell_record(cfg, base.ShapeSpec("train_4k", 16, 8, "train"),
                        arch="llama3.2-1b", mesh_name="device")
    decode = cell_record(cfg, base.ShapeSpec("decode_32k", 64, 8, "decode"),
                         arch="llama3.2-1b", mesh_name="device")
    return train, decode


def test_roofline_row_equals_the_references_on_bf16_counts(records):
    for rec in records:
        rec = _bf16_only(rec)
        want = ref_roofline.roofline_row(_ref_record(rec), REF_H100)
        got = roofline.roofline_row(rec, H100)
        assert {k: got[k] for k in want} == want
        assert got["compute_bf16_peak_s"] == got["compute_s"]


def test_roofline_compute_term_sums_each_dtype_over_its_peak(records):
    train, _ = records
    ss = train["step_stats"]
    assert set(ss["flops_by_dtype"]) == {"bfloat16", "float32"}
    assert sum(ss["flops_by_dtype"].values()) == ss["flops"]
    want = ref_roofline.roofline_row(_ref_record(train), REF_H100)
    got = roofline.roofline_row(train, H100)
    assert got["compute_bf16_peak_s"] == want["compute_s"]
    assert got["compute_s"] == pytest.approx(
        ss["flops_by_dtype"]["bfloat16"] / 989e12
        + ss["flops_by_dtype"]["float32"] / 67e12, rel=1e-12)
    assert got["compute_s"] > want["compute_s"]
    for k in ("memory_s", "collective_s", "model_flops", "model_hlo_ratio",
              "collective_count", "chips", "arch", "shape", "mesh", "kind"):
        assert got[k] == want[k], k
    assert got["est_step_s"] == max(got["compute_s"], got["memory_s"],
                                    got["collective_s"])
    assert got["peak_bytes"] == train["memory"]["peak_bytes"]
    assert roofline.roofline_row(dict(train, status="FAIL")) is None


def _results(records, ref: bool):
    """A results file: two cells, a tagged run of one, a SKIP."""
    train, decode = (_bf16_only(r) for r in records)
    conv = _ref_record if ref else (lambda r: r)
    skip = {"arch": "yi-9b", "shape": "long_500k", "mesh": "device",
            "status": "SKIP", "reason": "pure full-attention arch"}
    return {
        "llama3.2-1b/train_4k/device": conv(train),
        "llama3.2-1b/decode_32k/device": conv(decode),
        "llama3.2-1b/decode_32k/device#bigger": conv(dict(
            train, shape="decode_32k", tag="bigger")),
        "yi-9b/long_500k/device": skip,
    }


def test_tables_render_as_the_references(records, tmp_path):
    ours, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    ours.write_text(json.dumps(_results(records, ref=False)))
    theirs.write_text(json.dumps(_results(records, ref=True)))
    rows, skips = roofline.load_rows(str(ours), "device", H100)
    ref_rows, ref_skips = ref_roofline.load_rows(str(theirs), "device",
                                                 REF_H100)
    assert len(rows) == 2 and len(skips) == 1
    assert roofline.markdown_table(rows, skips) == \
        ref_roofline.markdown_table(ref_rows, ref_skips)
    perf = roofline.perf_compare(str(ours), H100)
    assert perf == ref_roofline.perf_compare(str(theirs), REF_H100)
    assert "bigger" in perf and "[step x" in perf
    assert [roofline.fmt_s(x) for x in (2.5, 0.0123, 4.2e-5)] == [
        ref_roofline.fmt_s(x) for x in (2.5, 0.0123, 4.2e-5)]


def test_advice_speaks_of_the_h100():
    for dominant, text in roofline._ADVICE.items():
        assert "MXU" not in text and "ICI" not in text, dominant
        assert roofline.advice({"dominant": dominant}) == text
    assert "tensor cores" in roofline._ADVICE["compute"]
    assert "HBM" in roofline._ADVICE["memory"]
    assert "NVLink" in roofline._ADVICE["collective"]


_BF16_PARTIALS = """
import dataclasses, json, logging
logging.disable(logging.WARNING)
from repro_torch.configs.base import SHAPES
from repro_torch.configs.catalog import get_config
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import end_fake_world, make_host_mesh
mesh = make_host_mesh(4, 2)
cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                          dtype="bfloat16")
out = []
for flag in (False, True):
    st, _ = lower_cell(cfg, SHAPES["prefill_32k"], mesh, bf16_partials=flag,
                       program=True)
    rec = st.record()
    rec["collective_records"] = st.program.collectives
    out.append(rec)
end_fake_world()
print("RESULT " + json.dumps(out))
"""


def test_dryrun_and_roofline_clis(tmp_path, capsys):
    """``dryrun --reduced`` traces a cell on both production meshes (in a
    process of its own: the fake process group is process-wide) and on
    one device, SKIPs long_500k on a full-attention arch, takes
    ``--bf16-partials``; ``roofline`` renders the OK cells on h100.
    ``bf16_partials`` on a reduced bf16 prefill cell on the fake
    data=4,model=2 mesh halves the bytes of the K-split products'
    all-reduces (f32 -> bf16 partial sums) and changes no other count."""
    from repro_torch.launch import dryrun
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    partials = subprocess.Popen(
        [sys.executable, "-c", _BF16_PARTIALS], cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    dryrun.main(["--bf16-partials", "--list", "--arch", "yi-9b"])
    assert capsys.readouterr().out.split("\n")[:4] == [
        f"yi-9b x {s}" for s in base.SHAPES]
    res = tmp_path / "dry.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced",
         "--arch", "llama3.2-1b", "--shape", "train_4k", "--mesh", "both",
         "--out", str(res)], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    stdout, stderr = partials.communicate(timeout=300)
    assert partials.returncode == 0, stderr[-2000:]
    off, on = json.loads([ln for ln in stdout.splitlines()
                          if ln.startswith("RESULT ")][-1][7:])
    halved = [(a, b) for a, b in zip(off.pop("collective_records"),
                                     on.pop("collective_records")) if a != b]
    assert len(halved) == 4                  # wo and w_down, 2 layers
    for a, b in halved:
        assert a["op"] == b["op"] == "all-reduce"
        assert (a["numel"], a["dims"]) == (b["numel"], b["dims"])
        assert a["bytes"] == 2 * b["bytes"] == 4 * a["numel"]
    cut = sum(a["bytes"] - b["bytes"] for a, b in halved)
    assert on["collective_result_bytes"]["all-reduce"] == \
        off["collective_result_bytes"]["all-reduce"] - cut
    for key in ("flops", "flops_by_dtype", "dot_count", "collective_count",
                "flash_flops", "flash_calls", "argument_bytes"):
        assert on[key] == off[key], key
    for op, nbytes in off["collective_result_bytes"].items():
        if op != "all-reduce":
            assert on["collective_result_bytes"][op] == nbytes, op
    for argv in (["--arch", "llama3.2-1b", "--shape", "long_500k",
                  "--mesh", "single"],
                 ["--arch", "mamba2-130m", "--shape", "long_500k",
                  "--mesh", "device"]):
        dryrun.main(["--reduced", "--out", str(res), *argv])
    recs = json.loads(res.read_text())
    assert {k: r["status"] for k, r in recs.items()} == {
        "llama3.2-1b/train_4k/single": "OK",
        "llama3.2-1b/train_4k/multi": "OK",
        "llama3.2-1b/long_500k/single": "SKIP",
        "mamba2-130m/long_500k/device": "OK"}
    assert recs["llama3.2-1b/train_4k/multi"]["chips"] == 512
    assert recs["mamba2-130m/long_500k/device"]["chips"] == 1
    capsys.readouterr()
    roofline.main(["--results", str(res), "--emit", "markdown"])
    out = capsys.readouterr().out
    assert "| llama3.2-1b | train_4k | single | train |" in out
    assert "| llama3.2-1b | long_500k | single | — | SKIP |" in out
    roofline.main(["--results", str(res), "--mesh", "device", "--emit",
                   "json"])
    rows = json.loads(capsys.readouterr().out)
    assert [(r["arch"], r["hardware"]) for r in rows] == [
        ("mamba2-130m", "h100")]
    roofline.main(["--results", str(res), "--mesh", "multi"])
    out = capsys.readouterr().out
    assert "-> " in out
    assert any(roofline._ADVICE[d] in out for d in roofline._ADVICE)
