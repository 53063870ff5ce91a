"""chatglm3-6b [dense] — 28L, GQA kv=2, RoPE on half the head dim ("2d RoPE"),
QKV bias.  [arXiv:2406.12793]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024, rope_theta=10000.0, rope_fraction=0.5,
)
