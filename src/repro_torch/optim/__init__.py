"""Optimizers (port of ``repro.optim``: AdamW, and the int8 error-feedback
gradient sum of :mod:`.compress`)."""
from repro_torch.optim.adamw import (
    OptConfig,
    OptState,
    apply_updates,
    global_norm,
    init_opt_state,
    lr_at,
)
from repro_torch.optim.compress import dequantize, ef_compress_grads, init_residuals, quantize

__all__ = ["OptConfig", "OptState", "init_opt_state", "apply_updates", "global_norm", "lr_at",
           "quantize", "dequantize", "init_residuals", "ef_compress_grads"]
