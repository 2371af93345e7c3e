"""Checkpoints (port of ``repro.checkpoint``): the atomic keep-k manager
with its corrupt-step fallback and preemption guard, and :mod:`.codec`, the
scheduled-form codec of paper §3.6 for sparse tensors."""
from repro_torch.checkpoint.manager import (
    PreemptionGuard,
    all_steps,
    latest_step,
    restore,
    restore_latest,
    save,
)

__all__ = ["save", "restore", "restore_latest", "latest_step", "all_steps", "PreemptionGuard"]
