from repro_torch.core.attention_api import (  # noqa: F401
    flash_attention, flash_tile_lookup,
)
from repro_torch.core.device import resolve_device  # noqa: F401
from repro_torch.core.gemm_api import (  # noqa: F401
    ExecutionContext, capture_gemm_shapes,
    current_hardware, einsum, execution_context, matmul,
)
from repro_torch.core.hardware import (  # noqa: F401
    H100, HardwareProfile, detect_hardware, find_profile, get_profile,
    register_profile, resolve_hardware, resolve_profile,
)
from repro_torch.core.registry import (  # noqa: F401
    GLOBAL_REGISTRY, LookupResult, TileRegistry,
)
from repro_torch.core.tile_config import (  # noqa: F401
    FlashAttentionConfig, PagedAttentionConfig, TileConfig, flash_tiles,
    gemm_tiles,
)
