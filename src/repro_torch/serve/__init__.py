from repro_torch.serve.api import (  # noqa: F401
    GenerationResult, Request, RequestHandle,
)
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
from repro_torch.serve.reference import generate_per_prompt  # noqa: F401
