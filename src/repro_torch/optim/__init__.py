"""Optimizers (port of ``repro.optim``: AdamW)."""
from repro_torch.optim.adamw import (
    OptConfig,
    OptState,
    apply_updates,
    global_norm,
    init_opt_state,
    lr_at,
)

__all__ = ["OptConfig", "OptState", "init_opt_state", "apply_updates", "global_norm", "lr_at"]
