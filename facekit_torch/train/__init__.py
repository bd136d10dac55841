"""Training: margin heads, the SGD step, the folder loader, checkpoints."""

from facekit_torch.train.arcface_head import (  # noqa: F401
    arc_margin_logits,
    combined_margin_logits,
    head_init,
)
from facekit_torch.train.step import (  # noqa: F401
    TrainState,
    make_optimizer,
    make_train_step,
    train_state_init,
    warmup_cosine_decay_schedule,
)
