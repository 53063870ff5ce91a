"""The port's launcher CLI, as ``tests/test_launch_args.py`` holds the
reference's: one declaration of the shared flags (the reference's, plus
``--device``), the serving argument group with the reference's defaults,
warn-and-forward semantics for retired flags (train's ``--mesh-data`` /
``--mesh-model`` onto ``--mesh``), ``--trace-dir`` on both launchers (a
capture of the run, on the CPU here) and ``--mesh`` under ``torchrun``.
"""
import argparse

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch import common as jax_common  # noqa: E402
from repro_torch.launch.common import (add_common_args,  # noqa: E402
                                       add_serving_args, deprecated_flag,
                                       forward_deprecated)
from repro_torch.profiling import load_trace_events, summarize_events  # noqa: E402

COMMON_FLAGS = ["--hardware", "--mesh", "--stats", "--tuned-dir",
                "--trace-dir", "--device"]
SERVING_FLAGS = ["--scheduler", "--page-size", "--capacity-tokens",
                 "--decode-chunk", "--no-prefix-cache"]


def _option_strings(ap):
    return {s for a in ap._actions for s in a.option_strings}


def _defaults(add):
    ap = argparse.ArgumentParser()
    add(ap)
    return vars(ap.parse_args([]))


def test_common_args_are_the_references_less_mesh_plus_device():
    """The shared surface is the reference's, ``--mesh`` included, plus the
    port's ``--device``."""
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    ref = argparse.ArgumentParser()
    jax_common.add_common_args(ref)
    assert _option_strings(ap) == _option_strings(ref) | {"--device"}
    args = ap.parse_args(["--stats", "--trace-dir", "t", "--device", "cpu",
                          "--mesh", "data=2,model=2"])
    assert args.stats and args.trace_dir == "t" and args.device == "cpu"
    assert args.mesh == "data=2,model=2"
    assert args.hardware is None and args.tuned_dir is None


def test_serving_args_group_and_defaults_match_the_reference():
    ap = argparse.ArgumentParser()
    add_serving_args(ap)
    assert set(SERVING_FLAGS) <= _option_strings(ap)
    assert any(g.title == "serving" for g in ap._action_groups)
    assert _defaults(add_serving_args) == _defaults(jax_common.add_serving_args)
    with pytest.raises(SystemExit):
        ap.parse_args(["--scheduler", "bogus"])


def test_both_launchers_take_the_shared_declaration():
    """serve.py and train.py import the one declaration, not a copy, and
    expose every common flag."""
    from repro_torch.launch import serve, train
    for mod in (serve, train):
        assert mod.add_common_args is add_common_args
    assert serve.add_serving_args is add_serving_args
    for main in (serve.main, train.main):
        with pytest.raises(SystemExit):
            main(["--help"])


def test_deprecated_flag_warns_and_forwards(capsys):
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    deprecated_flag(ap, "--trace", "--trace-dir")
    with pytest.warns(DeprecationWarning, match="--trace is deprecated"):
        args = ap.parse_args(["--trace", "d"])
    assert "[deprecated] --trace -> --trace-dir" in capsys.readouterr().out
    assert args._deprecated_used == {"trace"}
    forward_deprecated(args, {"trace": ("trace_dir", str)})
    assert args.trace_dir == "d"


def test_deprecated_flag_loses_to_the_modern_flag():
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    deprecated_flag(ap, "--trace", "--trace-dir")
    with pytest.warns(DeprecationWarning):
        args = ap.parse_args(["--trace", "old", "--trace-dir", "new"])
    forward_deprecated(args, {"trace": ("trace_dir", str)})
    assert args.trace_dir == "new"


def test_deprecated_flag_hidden_and_inert_when_unused():
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    deprecated_flag(ap, "--trace", "--trace-dir")
    args = ap.parse_args([])
    assert getattr(args, "_deprecated_used", set()) == set()
    forward_deprecated(args, {"trace": ("trace_dir", str)})
    assert args.trace_dir is None
    assert "--trace " not in ap.format_help()


def test_serve_launcher_traces_into_trace_dir(tmp_path, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
          "--prompts", "1,2,3;4,5", "--max-new", "4", "--trace-dir",
          str(tmp_path)])
    assert "[trace] captured 1 trace file(s)" in capsys.readouterr().out
    ann = summarize_events(load_trace_events(str(tmp_path)))["annotations"]
    assert ann["serve.decode_chunk"]["count"] >= 1


def test_train_launcher_traces_into_trace_dir(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
          "--steps", "2", "--seq-len", "8", "--batch", "2", "--trace-dir",
          str(tmp_path)])
    assert "[trace] captured 1 trace file(s)" in capsys.readouterr().out
    ann = summarize_events(load_trace_events(str(tmp_path)))["annotations"]
    assert ann["train.step"]["count"] == 2


def test_launchers_without_trace_dir_write_no_capture(tmp_path, capsys,
                                                      monkeypatch):
    from repro_torch.launch.train import main
    monkeypatch.chdir(tmp_path)
    main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
          "--steps", "1", "--seq-len", "8", "--batch", "2"])
    assert "[trace]" not in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []


def test_mesh_is_in_the_shared_surface_of_both_launchers():
    from repro_torch.launch import train
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    assert set(COMMON_FLAGS) <= _option_strings(ap)
    assert train.parse_args(["--arch", "x", "--mesh", "auto"]).mesh == "auto"


def test_train_mesh_data_and_model_forward_onto_mesh(capsys):
    from repro_torch.launch import train
    with pytest.warns(DeprecationWarning, match="--mesh-data is deprecated"):
        args = train.parse_args(["--arch", "x", "--mesh-data", "2",
                                 "--mesh-model", "2"])
    assert args.mesh == "data=2,model=2"
    assert "[deprecated] --mesh-model -> --mesh" in capsys.readouterr().out
    with pytest.warns(DeprecationWarning):
        args = train.parse_args(["--arch", "x", "--mesh", "data=4",
                                 "--mesh-data", "2"])
    assert args.mesh == "data=4"           # the modern flag wins
    assert train.parse_args(["--arch", "x"]).mesh is None


@pytest.mark.parametrize("server", [False, True])
def test_serve_launcher_on_a_2x2_mesh_prints_once_and_serves_the_same(
        tmp_path, server):
    """``torchrun --standalone --nproc_per_node 4`` of the serve launcher
    on a data=2,model=2 mesh (gloo on the CPU): the mesh line once, from
    rank 0, and the tokens of the run without a mesh; with ``--server``,
    rank 0's Server with the other ranks following it."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    base = ["-m", "repro_torch.launch.serve", "--arch", "llama3.2-1b",
            "--device", "cpu", "--reduced", "--prompts", "1,2,3;7,8,9;4,4",
            "--max-new", "6", "--stats"] + (["--server"] if server else [])

    def run(cmd):
        proc = subprocess.Popen([sys.executable] + cmd, env=env, cwd=tmp_path,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            out, err = proc.communicate()
        assert proc.returncode == 0, (out + err)[-3000:]
        return out
    meshed = run(["-m", "torch.distributed.run", "--standalone",
                  "--nproc_per_node", "4"] + base
                 + ["--mesh", "data=2,model=2"])
    plain = run(base)
    mesh_lines = [ln for ln in meshed.splitlines() if ln.startswith("[mesh]")]
    assert mesh_lines == ["[mesh] {'devices': 4, 'axes': {'data': 2, "
                          "'model': 2}, 'label': 'data2xmodel2'}"]
    tokens = [ln for ln in meshed.splitlines() if ln.startswith("prompt=")]
    assert len(tokens) == 3
    assert tokens == [ln for ln in plain.splitlines()
                      if ln.startswith("prompt=")]
    assert meshed.count("[hw] profile=") == 1
