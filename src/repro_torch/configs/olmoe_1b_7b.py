"""olmoe-1b-7b [moe] — 16L, 64 experts top-8, d_ff=1024/expert.
[arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, rope_theta=10000.0,
    num_experts=64, experts_per_token=8,
)
