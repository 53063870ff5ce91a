from repro_torch.optim.adamw import AdamW, AdamWState, global_norm  # noqa: F401
from repro_torch.optim.schedules import constant, warmup_cosine  # noqa: F401
