"""zamba2-2.7b [hybrid] — 54 Mamba2 layers in 9 units of 6 (d 2560, d_inner
5120 in 80 SSM heads of 64, state 64), with ONE shared attention block (32 /
32 heads at head dim 80, SwiGLU d_ff 10240) applied at the start of every
unit, and an untied head over 32000 tokens.  [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, rope_theta=10000.0,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    attn_period=6,
)
