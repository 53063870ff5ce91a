"""The port's launcher CLI, as ``tests/test_launch_args.py`` holds the
reference's: one declaration of the shared flags (the reference's less
``--mesh``, plus ``--device``), the serving argument group with the
reference's defaults, warn-and-forward semantics for retired flags, and
``--trace-dir`` on both launchers (a capture of the run, on the CPU here).
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

COMMON_FLAGS = ["--hardware", "--stats", "--tuned-dir", "--trace-dir",
                "--device"]
SERVING_FLAGS = ["--scheduler", "--page-size", "--capacity-tokens",
                 "--decode-chunk", "--no-prefix-cache"]


def _option_strings(ap):
    return {s for a in ap._actions for s in a.option_strings}


def _defaults(add):
    ap = argparse.ArgumentParser()
    add(ap)
    return vars(ap.parse_args([]))


def test_common_args_are_the_references_less_mesh_plus_device():
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    ref = argparse.ArgumentParser()
    jax_common.add_common_args(ref)
    assert _option_strings(ap) == (_option_strings(ref) - {"--mesh"}) | {
        "--device"}
    args = ap.parse_args(["--stats", "--trace-dir", "t", "--device", "cpu"])
    assert args.stats and args.trace_dir == "t" and args.device == "cpu"
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
