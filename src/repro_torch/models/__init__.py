from repro_torch.models.model import Model, build_model  # noqa: F401
from repro_torch.models.params import params_from_numpy  # noqa: F401
