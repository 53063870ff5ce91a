"""mamba2-130m [ssm] — 24 attention-free Mamba2 (SSD) layers, d 768,
d_inner 1536 in 24 SSM heads of 64, state 128, chunk 128, conv 4, tied
head over 50280 tokens.  [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0, d_ff=0,
    vocab_size=50280, use_rope=False,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    tie_embeddings=True,
)
