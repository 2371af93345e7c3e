"""Power-gating policy for models with little sparsity (paper §3.5; a copy
of ``repro/core/powergate.py``).

The paper: "a counter per tensor at the output of each layer can measure
the fraction of zeros that were generated … used to automatically decide
whether enabling TensorDash for the next layer would be of benefit."
Reproduces the GCN result: a no-sparsity model costs −0.5 % energy without
gating (scheduler/mux idle power) and ≥ baseline with gating.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.energy import FP32, EnergyModel, TechConfig

__all__ = ["GatePolicy", "gated_layer_outcome"]


@dataclasses.dataclass(frozen=True)
class GatePolicy:
    """Enable TensorDash for a layer iff the *previous* epoch/batch measured
    at least ``min_sparsity`` zeros in the operand stream feeding it."""

    min_sparsity: float = 0.05

    def enabled(self, measured_sparsity: float) -> bool:
        return measured_sparsity >= self.min_sparsity


def gated_layer_outcome(
    measured_sparsity: float,
    speedup_if_enabled: float,
    *,
    policy: GatePolicy = GatePolicy(),
    tech: TechConfig = FP32,
) -> dict:
    """(speedup, relative power) for one layer under the gating decision.

    Disabled => staging buffers bypassed and TensorDash logic power-gated:
    exactly baseline performance and power.  Enabled => the speedup plus the
    ~1.8 % scheduler/mux power adder of the paper's Table 3.
    """
    on = policy.enabled(measured_sparsity)
    power_ratio = (tech.core_power_mw + tech.td_extra_power_mw) / tech.core_power_mw
    if not on:
        return {"enabled": False, "speedup": 1.0, "power_ratio": 1.0, "energy_ratio": 1.0}
    speedup = max(speedup_if_enabled, 1.0)
    return {
        "enabled": True,
        "speedup": speedup,
        "power_ratio": power_ratio,
        "energy_ratio": power_ratio / speedup,  # < 1 iff worth enabling
    }
