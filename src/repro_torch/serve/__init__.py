from repro_torch.serve.api import (  # noqa: F401
    PREFIX_HIT_FULL, PREFIX_HIT_PARTIAL, GenerationResult, Request,
    RequestHandle, StreamEvent,
)
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
from repro_torch.serve.reference import (  # noqa: F401
    PerTokenSyncEngine, generate_per_prompt, generate_per_token_sync,
)
from repro_torch.serve.server import Server  # noqa: F401
