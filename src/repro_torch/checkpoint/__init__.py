"""Checkpoints (port of ``repro.checkpoint``): the atomic keep-k manager
with its corrupt-step fallback and preemption guard.  ``codec.py`` (the
scheduled-form codec of paper §3.6) waits for ROADMAP queue 1, item 17."""
from repro_torch.checkpoint.manager import (
    PreemptionGuard,
    all_steps,
    latest_step,
    restore,
    restore_latest,
    save,
)

__all__ = ["save", "restore", "restore_latest", "latest_step", "all_steps", "PreemptionGuard"]
