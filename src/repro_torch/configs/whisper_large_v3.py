"""whisper-large-v3 [audio] — encoder-decoder, 32 encoder + 32 decoder
layers, MHA (20 heads at head dim 64), untied head over 51866 tokens.  The
conv/mel frontend is a stub (``Model.extra_inputs`` supplies (B, 1500,
1280) frame embeddings); the learned decoder positions are extended to
32768, as in the JAX package.  [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, encoder_layers=32, encoder_len=1500,
    d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, norm="layernorm",
    use_rope=False, learned_positions=32768,
)
