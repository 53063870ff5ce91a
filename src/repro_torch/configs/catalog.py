"""Architecture catalog: ``--arch <id>`` resolves here.

The same ten configurations as the JAX package's catalog; every family
(dense, moe, vlm, audio, ssm, hybrid) has a model path in the port.
"""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _vlm
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.llama3_2_1b import CONFIG as _llama1b
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.mamba2_130m import CONFIG as _mamba
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba

ARCHITECTURES = {c.name: c for c in (
    _vlm, _olmoe, _moonshot, _llama1b, _chatglm, _stablelm, _yi,
    _mamba, _whisper, _zamba,
)}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHITECTURES)}")
