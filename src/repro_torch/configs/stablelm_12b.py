"""stablelm-12b [dense] — 40L GQA kv=8, LayerNorm, partial RoPE (25%).
[hf:stabilityai/stablelm-2-12b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=13824, vocab_size=100352, rope_theta=10000.0, rope_fraction=0.25,
    norm="layernorm",
)
