"""Architecture catalog: ``--arch <id>`` resolves here.

The same ten configurations as the JAX package's catalog.  Only the
``dense`` family has a model path in the port so far; ``build_model``
refuses the others (see ``repro_torch.models.model``).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama3_2_1b import CONFIG as _llama1b

_vlm = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
    cross_attn_period=5, num_image_tokens=1601,
)
_olmoe = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, rope_theta=10000.0,
    num_experts=64, experts_per_token=8,
)
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
_mamba = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=50280, use_rope=False,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    tie_embeddings=True,
)
_whisper = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, encoder_layers=32, encoder_len=1500,
    d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, norm="layernorm",
    use_rope=False, learned_positions=32768,
)
_zamba = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, rope_theta=10000.0,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    attn_period=6,
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
