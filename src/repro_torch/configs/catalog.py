"""Architecture catalog: ``--arch <id>`` resolves here.

The same ten configurations as the JAX package's catalog; every family
(dense, moe, vlm, audio, ssm, hybrid) has a model path in the port.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3_2_1b import CONFIG as _llama1b
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _vlm
from repro_torch.configs.mamba2_130m import CONFIG as _mamba
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba

_moonshot = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, rope_theta=50000.0,
    num_experts=64, experts_per_token=6,
)
_chatglm = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024, rope_theta=10000.0, rope_fraction=0.5,
)
_stablelm = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352, rope_theta=10000.0, rope_fraction=0.25,
    norm="layernorm",
)
_yi = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, rope_theta=5000000.0,
)

ARCHITECTURES = {c.name: c for c in (
    _vlm, _olmoe, _moonshot, _llama1b, _chatglm, _stablelm, _yi,
    _mamba, _whisper, _zamba,
)}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHITECTURES)}")
