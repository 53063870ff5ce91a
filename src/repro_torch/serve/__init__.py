from repro_torch.serve.api import (  # noqa: F401
    PREFIX_HIT_FULL, PREFIX_HIT_PARTIAL, GenerationResult, Request,
    RequestHandle, StreamEvent,
)
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
from repro_torch.serve.reference import generate_per_prompt  # noqa: F401
from repro_torch.serve.server import Server  # noqa: F401
