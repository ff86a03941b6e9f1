"""Train and serve steps of the LM stack, and AdamW."""
from .optim import AdamWConfig, adamw_init, adamw_update, cosine_lr
from .steps import (init_optimizer, make_prefill_step, make_serve_step,
                    make_train_step)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "make_train_step", "make_serve_step", "make_prefill_step",
           "init_optimizer"]
