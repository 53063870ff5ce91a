from repro_torch.core.attention_api import flash_attention  # noqa: F401
from repro_torch.core.device import resolve_device  # noqa: F401
from repro_torch.core.gemm_api import (  # noqa: F401
    ExecutionContext, capture_gemm_shapes, einsum, execution_context, matmul,
)
from repro_torch.core.tile_config import (  # noqa: F401
    FlashAttentionConfig, TileConfig, flash_tiles, gemm_tiles,
)
