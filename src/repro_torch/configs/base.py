"""Model configuration dataclass (a copy of the JAX package's ``ModelConfig``).

``reduced()`` derives the CPU test variant: same family and topology, tiny
dims.  The port keeps its own copy so it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0              # 0 => attention-free
    num_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0               # 0 -> d_model // num_heads
    # norm / positions
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    use_rope: bool = True
    rope_theta: float = 500000.0
    rope_fraction: float = 1.0      # chatglm applies RoPE to half the head dim
    learned_positions: int = 0      # >0 => learned pos-emb table (whisper dec)
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # hybrid (Zamba2): one SHARED attention block applied every N ssm layers
    attn_period: int = 0
    # VLM: layer unit = (cross_attn_period - 1) self layers + 1 cross layer
    cross_attn_period: int = 0
    num_image_tokens: int = 0
    # enc-dec (Whisper): encoder stack + frontend stub length
    encoder_layers: int = 0
    encoder_len: int = 0
    # numerics / memory
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: bool = True
    remat_policy: str = "full"      # full | dots (save matmul outputs in bwd)
    logit_chunk: int = 0            # >0 => chunked loss over tokens
    attn_p_dtype: str = "float32"   # attention probabilities for the PV matmul
                                    # ("bfloat16" halves the dominant f32 buffer)
    attention_impl: str = "chunked"  # chunked (torch ops) | flash (CUDA
                                     # kernel for causal self-attention with
                                     # >1 query: forwards AND serving
                                     # prefill, ragged rows included; decode/
                                     # cross-attn fall back, logged once)
    kv_quant: bool = False           # int8 KV cache (per-token-head scales):
                                     # halves the decode memory term

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling => may run long_500k."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-topology variant for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            d_model=64,
            vocab_size=256,
            d_ff=128 if self.d_ff else 0,
            head_dim=16 if self.num_heads else 0,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            rope_theta=10000.0,
            dtype="float32",
            remat=False,
        )
        if self.family == "vlm":
            kw.update(num_layers=2 * self.cross_attn_period,
                      num_image_tokens=8)
        elif self.family == "hybrid":
            kw.update(num_layers=2 * self.attn_period)
        elif self.family == "audio":
            kw.update(num_layers=2, encoder_layers=2, encoder_len=16,
                      learned_positions=128 if self.learned_positions else 0)
        else:
            kw.update(num_layers=2)
        if self.num_experts:
            kw.update(num_experts=8, experts_per_token=2)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
        return dataclasses.replace(self, **kw)
