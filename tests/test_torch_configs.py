"""The port's architecture catalog against the reference's: the same ten
ids, each its own ``configs/<id>.py`` module whose docstring names the
reference's source, and every field of the reference's ``ModelConfig``
equal."""
import dataclasses
import importlib
import re

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs.catalog import ARCHITECTURES as REF_ARCHS  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES  # noqa: E402


def test_catalog_ids_equal_the_references():
    assert list(ARCHITECTURES) == list(REF_ARCHS)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_config_equals_the_references_on_every_field(arch):
    ref = dataclasses.asdict(REF_ARCHS[arch])
    got = dataclasses.asdict(ARCHITECTURES[arch])
    assert {k: got.get(k, "<missing>") for k in ref} == ref


def _source(doc: str) -> str:
    """The bracketed source a config module's docstring ends with."""
    return re.findall(r"\[[^\]]+\]", doc)[-1]


#: the reference's config modules, one an architecture
MODULES = ("llama_3_2_vision_11b", "olmoe_1b_7b", "moonshot_v1_16b_a3b",
           "llama3_2_1b", "chatglm3_6b", "stablelm_12b", "yi_9b",
           "mamba2_130m", "whisper_large_v3", "zamba2_2_7b")


@pytest.mark.parametrize("module", MODULES)
def test_config_module_and_source_like_the_references(module):
    ref = importlib.import_module(f"repro.configs.{module}")
    port = importlib.import_module(f"repro_torch.configs.{module}")
    assert port.CONFIG is ARCHITECTURES[ref.CONFIG.name]
    assert _source(port.__doc__) == _source(ref.__doc__)
    assert sorted(ARCHITECTURES) == sorted(
        importlib.import_module(f"repro.configs.{m}").CONFIG.name
        for m in MODULES)
