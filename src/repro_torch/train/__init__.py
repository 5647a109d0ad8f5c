"""Training for the port: AdamW with float32 master weights
(:mod:`.optim`) and the step functions (:mod:`.step`)."""
from .optim import OptState, adamw_update, init_opt_state, lr_schedule  # noqa: F401
from .step import (TrainState, build_decode_step, build_prefill_step,  # noqa: F401
                   build_train_step, cross_entropy, fused_cross_entropy,
                   init_train_state, make_loss_fn)
