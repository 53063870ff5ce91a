from repro_torch.models.model import Model, build_model  # noqa: F401
from repro_torch.models.params import (  # noqa: F401
    params_from_numpy, train_state_from_numpy,
)
