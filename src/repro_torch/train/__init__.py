from repro_torch.train.loss import chunked_ce, lm_loss  # noqa: F401
from repro_torch.train.trainer import (  # noqa: F401
    Trainer, TrainerConfig, TrainState, abstract_train_state, init_train_state,
    make_decode_step, make_prefill_step, make_train_step,
)
