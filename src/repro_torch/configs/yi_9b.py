"""yi-9b [dense] — 48L llama-arch GQA kv=4.  [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, rope_theta=5000000.0,
)
