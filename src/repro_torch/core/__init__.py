"""TensorDash core: the paper's scheduler, PE and accelerator performance
model (port of ``repro.core``, the parts ``tune`` and the train step's
taps need), in host numpy; :mod:`.sparsity` measures tensors in torch."""
from repro_torch.core.pe import dense_cycles, simulate_stream, simulate_tile
from repro_torch.core.perf_model import (
    BWD_INPUT,
    BWD_WEIGHT,
    FWD,
    ConvLayer,
    ConvResult,
    TileConfig,
    ffn_layers_from_config,
    make_clustered_masks,
    model_speedup,
    simulate_conv,
    speedup_from_densities,
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
    "ffn_layers_from_config",
    "speedup_from_densities",
    "FWD",
    "BWD_INPUT",
    "BWD_WEIGHT",
]
