"""TensorDash core: the paper's contribution (port of ``repro.core``): the
scheduler step in host numpy, the PE and accelerator performance model
(cycles on the card unless asked for the CPU), the scheduled-form codec on
the tensor's device, sparsity measurement in torch, and the energy and
power-gating models in pure Python."""
from repro_torch.core.compress import Scheduled, compress, decompress, simulate_macs
from repro_torch.core.energy import BF16, FP32, EnergyBreakdown, EnergyModel
from repro_torch.core.pe import dense_cycles, effectual_mask, simulate_stream, simulate_tile
from repro_torch.core.perf_model import (
    BWD_INPUT,
    BWD_WEIGHT,
    FWD,
    AcceleratorConfig,
    ConvLayer,
    ConvResult,
    TileConfig,
    make_clustered_masks,
    model_speedup,
    simulate_conv,
)
from repro_torch.core.scheduler import connectivity, drain_count, levels, make_schedule_step
from repro_torch.core.sparsity import (
    SparsityStats,
    apply_probes,
    block_density,
    block_mask,
    grad_sparsity,
    lane_streams,
    measure,
    merge_stats,
)

__all__ = [
    "connectivity",
    "levels",
    "make_schedule_step",
    "drain_count",
    "simulate_stream",
    "simulate_tile",
    "effectual_mask",
    "dense_cycles",
    "Scheduled",
    "compress",
    "decompress",
    "simulate_macs",
    "TileConfig",
    "AcceleratorConfig",
    "ConvLayer",
    "ConvResult",
    "simulate_conv",
    "model_speedup",
    "make_clustered_masks",
    "FWD",
    "BWD_INPUT",
    "BWD_WEIGHT",
    "SparsityStats",
    "measure",
    "merge_stats",
    "block_mask",
    "block_density",
    "lane_streams",
    "apply_probes",
    "grad_sparsity",
    "EnergyModel",
    "EnergyBreakdown",
    "FP32",
    "BF16",
]
