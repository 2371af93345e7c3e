"""Analytical area / power / energy model, calibrated to the paper's Table 3
(a copy of ``repro/core/energy.py``: pure Python, no framework).

The paper synthesises Verilog at 65 nm (Design Compiler + Innovus) and uses
CACTI/Micron models for SRAM/DRAM.  Those tools are not part of this
reproduction, so this
module is an *analytical* model with constants calibrated so the baseline
configuration reproduces the paper's published numbers exactly:

* Compute cores (4096 FP32 MACs @ 500 MHz): 30.41 mm^2, 13 910 mW.
* TensorDash additions: transposers 0.38 mm^2 / 47.3 mW, schedulers +
  B-side muxes 0.91 mm^2 / 102.8 mW, A-side muxes 1.73 mm^2 / 145.3 mW.
* On-chip AM/BM/CM: 192 mm^2 each; scratchpads 17 mm^2 total.
* bfloat16 variant: compute overhead 1.13x area / 1.05x power (Table in §4.4).

Energy-per-access constants for the memory hierarchy are representative
published figures for 65 nm-class SRAM and LPDDR4 and are clearly modelled,
not measured.  All downstream numbers (Fig. 15/16 reproductions) therefore
track the paper's *methodology* and are modelled, not measured.
"""
from __future__ import annotations

import dataclasses

__all__ = ["TechConfig", "EnergyModel", "EnergyBreakdown", "FP32", "BF16"]


@dataclasses.dataclass(frozen=True)
class TechConfig:
    name: str
    core_area_mm2: float
    core_power_mw: float
    td_extra_area_mm2: float
    td_extra_power_mw: float
    # per-access energies (nJ) for a 64 B row
    sram_nj: float = 0.35  # 256 KB AM/BM/CM bank, 65 nm-class
    spad_nj: float = 0.06  # 1 KB scratchpad
    dram_nj: float = 2.0  # LPDDR4-3200, ~4 pJ/bit


FP32 = TechConfig(
    name="fp32",
    core_area_mm2=30.41,
    core_power_mw=13910.0,
    td_extra_area_mm2=0.38 + 0.91 + 1.73,
    td_extra_power_mw=47.3 + 102.8 + 145.3,
)

# bfloat16: paper reports 1.13x area, 1.05x power overheads for compute.
# Multiplier cores scale ~quadratically with mantissa width; calibrate the
# baseline so the overhead ratios match the paper.
BF16 = TechConfig(
    name="bf16",
    core_area_mm2=30.41 * 0.26,  # ~quadratic mantissa scaling 24b->8b
    core_power_mw=13910.0 * 0.26,
    td_extra_area_mm2=30.41 * 0.26 * 0.13,
    td_extra_power_mw=13910.0 * 0.26 * 0.05,
    sram_nj=0.35 * 0.55,
    spad_nj=0.06 * 0.55,
    dram_nj=2.0 * 0.55,
)


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    core_j: float
    sram_j: float
    spad_j: float
    dram_j: float

    @property
    def total_j(self) -> float:
        return self.core_j + self.sram_j + self.spad_j + self.dram_j


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    tech: TechConfig = FP32
    frequency_hz: float = 500e6
    onchip_area_mm2: float = 3 * 192.0 + 17.0  # AM+BM+CM + scratchpads

    # -- area ---------------------------------------------------------------
    def compute_area_overhead(self) -> float:
        t = self.tech
        return (t.core_area_mm2 + t.td_extra_area_mm2) / t.core_area_mm2

    def chip_area_overhead(self) -> float:
        t = self.tech
        base = t.core_area_mm2 + self.onchip_area_mm2
        return (base + t.td_extra_area_mm2) / base

    # -- energy -------------------------------------------------------------
    def run_energy(
        self,
        cycles: float,
        sram_accesses: float,
        spad_accesses: float,
        dram_accesses: float,
        tensordash: bool,
    ) -> EnergyBreakdown:
        """Energy (J) for a run of ``cycles`` with the given 64 B access
        counts.  TensorDash adds scheduler/mux power while it runs."""
        t = self.tech
        power_w = (t.core_power_mw + (t.td_extra_power_mw if tensordash else 0.0)) / 1e3
        return EnergyBreakdown(
            core_j=power_w * cycles / self.frequency_hz,
            sram_j=sram_accesses * t.sram_nj * 1e-9,
            spad_j=spad_accesses * t.spad_nj * 1e-9,
            dram_j=dram_accesses * t.dram_nj * 1e-9,
        )

    def efficiency(
        self,
        speedup: float,
        *,
        sram_compression: float = 1.0,
        dram_compression: float = 1.0,
        macs: float = 1e12,
        bytes_per_mac_sram: float = 0.25,
        bytes_per_mac_dram: float = 0.02,
    ) -> dict[str, float]:
        """Baseline-vs-TensorDash energy efficiency, compute-only and whole
        chip.  ``*_compression`` are the scheduled-form access-reduction
        ratios (>= 1) from :mod:`repro_torch.core.compress`."""
        cycles_base = macs / 4096.0
        cycles_td = cycles_base / max(speedup, 1e-9)
        sram_base = macs * bytes_per_mac_sram / 64.0
        dram_base = macs * bytes_per_mac_dram / 64.0
        spad = macs / 16.0 / 4.0  # one 64 B row feeds 16 MACs; amortised x4 reuse
        base = self.run_energy(cycles_base, sram_base, spad, dram_base, tensordash=False)
        td = self.run_energy(
            cycles_td,
            sram_base / sram_compression,
            spad / sram_compression,
            dram_base / dram_compression,
            tensordash=True,
        )
        return {
            "compute_efficiency": base.core_j / td.core_j,
            "chip_efficiency": base.total_j / td.total_j,
            "baseline_j": base.total_j,
            "tensordash_j": td.total_j,
            "base_core_j": base.core_j,
            "td_core_j": td.core_j,
            "base_sram_j": base.sram_j + base.spad_j,
            "td_sram_j": td.sram_j + td.spad_j,
            "base_dram_j": base.dram_j,
            "td_dram_j": td.dram_j,
        }
