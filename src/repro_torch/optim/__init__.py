from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          apply_updates, clip_by_global_norm,
                                          momentum, sgd)
from repro_torch.optim.schedule import (constant, cosine, exponential_decay,
                                        warmup_cosine)

__all__ = ["Optimizer", "sgd", "momentum", "adam", "adamw",
           "clip_by_global_norm", "apply_updates", "constant", "cosine",
           "exponential_decay", "warmup_cosine"]
