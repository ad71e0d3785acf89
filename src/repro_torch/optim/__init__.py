from .optimizers import (  # noqa: F401
    adamw, sgd, make_optimizer, clip_by_global_norm,
    clip_by_global_norm_, warmup_cosine,
    partition_optimizer, apply_updates,
)
