"""TensorDash core: the paper's scheduler, PE and accelerator performance
model (port of ``repro.core``, the part ``tune`` needs), in host numpy."""
from repro_torch.core.pe import dense_cycles, simulate_stream, simulate_tile
from repro_torch.core.perf_model import (
    BWD_INPUT,
    BWD_WEIGHT,
    FWD,
    ConvLayer,
    ConvResult,
    TileConfig,
    make_clustered_masks,
    model_speedup,
    simulate_conv,
)
from repro_torch.core.scheduler import connectivity, drain_count, levels, make_schedule_step

__all__ = [
    "connectivity",
    "levels",
    "make_schedule_step",
    "drain_count",
    "simulate_stream",
    "simulate_tile",
    "dense_cycles",
    "TileConfig",
    "ConvLayer",
    "ConvResult",
    "make_clustered_masks",
    "simulate_conv",
    "model_speedup",
    "FWD",
    "BWD_INPUT",
    "BWD_WEIGHT",
]
