"""TensorDash accelerator performance model (port of
``repro/core/perf_model.py``: the accelerator, layer and tile types, the clustered-mask
generator, :func:`simulate_conv`, :func:`model_speedup` and the training
taps' :func:`ffn_layers_from_config` / :func:`speedup_from_densities`).

Maps DNN layer workloads onto the tile/PE simulators of :mod:`repro_torch.core.pe`
to estimate cycles for the dense baseline accelerator and for TensorDash,
reproducing the paper's evaluation methodology: the three training
convolutions (Eq. 1-3) of every layer are simulated with the sparse operand's
zero mask driving the per-row schedulers.

The paper traces one random batch per epoch of real GPU training; here masks
come from calibrated synthetic distributions drawn with numpy on the host, so
the same seed gives the JAX model's masks and cycle counts exactly; the cycles
are counted on the card (the tile kernel) unless the caller asks for the CPU.
The ``clustering`` parameter models the 2-D feature-map clustering of
non-zeros the paper identifies as the cause of inter-row imbalance (section
4.4): per-stream densities are drawn from a Beta distribution whose variance
grows with ``clustering`` while the mean stays at the target density.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.pe import simulate_tiles

__all__ = [
    "TileConfig",
    "AcceleratorConfig",
    "ConvLayer",
    "make_clustered_masks",
    "simulate_conv",
    "ConvResult",
    "model_speedup",
    "ffn_layers_from_config",
    "speedup_from_densities",
    "FWD",
    "BWD_INPUT",
    "BWD_WEIGHT",
]

FWD = "A*W"  # Eq. (1): sparse operand = activations A
BWD_INPUT = "W*G"  # Eq. (2): sparse operand = output gradients G_O
BWD_WEIGHT = "A*G"  # Eq. (3): sparse operand = max-sparsity of (A, G_O)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    rows: int = 4
    cols: int = 4
    n_lanes: int = 16
    lookahead: int = 2  # 3-deep staging buffers


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """Paper Table 2 defaults."""

    n_tiles: int = 16
    tile: TileConfig = dataclasses.field(default_factory=TileConfig)
    frequency_hz: float = 500e6

    @property
    def macs_per_cycle(self) -> int:
        t = self.tile
        return self.n_tiles * t.rows * t.cols * t.n_lanes


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One convolutional (or FC, with kx=ky=1, ox=oy=1) layer."""

    name: str
    c_in: int
    kx: int
    ky: int
    c_out: int
    ox: int
    oy: int
    stride: int = 1

    @property
    def reduction(self) -> int:  # MACs per output value
        return self.c_in * self.kx * self.ky

    @property
    def outputs(self) -> int:  # output values per sample
        return self.c_out * self.ox * self.oy

    @property
    def macs(self) -> int:
        return self.reduction * self.outputs


def make_clustered_masks(
    rng: np.random.Generator,
    n_streams: int,
    t: int,
    n_lanes: int,
    density: float,
    clustering: float = 0.0,
) -> np.ndarray:
    """Non-zero masks ``[n_streams, t, n_lanes]`` with inter-stream imbalance.

    ``clustering=0`` gives iid Bernoulli(density).  Larger values draw each
    stream's density from Beta with the same mean but higher variance,
    reproducing the paper's observation that non-zeros cluster per 2-D
    feature map (some rows dense, others nearly empty).
    """
    density = float(np.clip(density, 0.0, 1.0))
    if clustering <= 0 or density in (0.0, 1.0):
        p = np.full((n_streams, 1, 1), density)
    else:
        # Beta(a, b) with mean=density; concentration k shrinks with clustering
        k = max(1e-3, (1.0 - clustering) * 50.0 + 0.5)
        a, b = density * k, (1.0 - density) * k
        p = rng.beta(a, b, size=(n_streams, 1, 1))
    return rng.random((n_streams, t, n_lanes)) < p


@dataclasses.dataclass(frozen=True)
class ConvResult:
    td_cycles: float
    dense_cycles: float

    @property
    def speedup(self) -> float:
        return self.dense_cycles / max(self.td_cycles, 1.0)


def _conv_masks(layer: ConvLayer, sparsity: float, tile: TileConfig, clustering: float, sample_groups: int,
                max_t: int, seed: int):
    """The sampled groups' masks ``[g, rows, t, n_lanes]`` of one
    convolution and the factors that scale their mean cycles (and the
    dense cycles) to the full workload."""
    rng = np.random.default_rng(seed)
    t_full = math.ceil(layer.reduction / tile.n_lanes)
    t = min(t_full, max_t)
    groups = math.ceil(layer.outputs / (tile.rows * tile.cols))
    g = min(sample_groups, groups)
    masks = make_clustered_masks(rng, g * tile.rows, t, tile.n_lanes, 1.0 - sparsity, clustering)
    return masks.reshape(g, tile.rows, t, tile.n_lanes), (t_full / t) * groups, float(t_full) * groups


def _conv_result(td: np.ndarray, scale: float, dense: float) -> ConvResult:
    return ConvResult(td_cycles=float(np.mean(td)) * scale, dense_cycles=dense)


def simulate_conv(
    layer: ConvLayer,
    *,
    sparsity: float,
    tile: TileConfig = TileConfig(),
    clustering: float = 0.4,
    sample_groups: int = 2,
    max_t: int = 512,
    seed: int = 0,
    device=None,
) -> ConvResult:
    """Estimate cycles for one of the three convolutions of ``layer``.

    The tile maps the sparse operand onto ``rows`` independent streams
    (different output rows / filters) sharing the drain in lockstep; ``cols``
    PEs share each row's schedule (different windows), so the cycle count is
    set by the rows and the column count only changes how many groups exist.
    ``sample_groups`` groups are simulated and scaled to the full workload:
    the masks drawn on the host, their cycles counted on ``device`` (the
    card unless the caller asks for the CPU), one transfer and one launch.
    """
    masks, scale, dense = _conv_masks(layer, sparsity, tile, clustering, sample_groups, max_t, seed)
    (td,) = simulate_tiles([masks], n_lanes=tile.n_lanes, lookahead=tile.lookahead, device=device)
    return _conv_result(td, scale, dense)


def model_speedup(
    layers: Sequence[ConvLayer],
    sparsity_per_conv: dict[str, float] | Sequence[dict[str, float]],
    *,
    tile: TileConfig = TileConfig(),
    clustering: float = 0.4,
    sample_groups: int = 2,
    max_t: int = 256,
    seed: int = 0,
    device=None,
) -> dict[str, float]:
    """Whole-model speedup, per training convolution and overall.

    ``sparsity_per_conv`` maps each of FWD/BWD_INPUT/BWD_WEIGHT to the sparse
    operand's zero fraction — either one dict for the whole model or one per
    layer.  Cycles are aggregated across layers (the three convolutions
    perform the same number of MACs, so the overall number weights them
    equally, as the paper does).  Every convolution's masks are drawn first
    (layer ``i`` from ``seed + 7919 * i``), then all their tiles go to
    ``device`` (the card unless the caller asks for the CPU) in one transfer
    and one launch.
    """
    per_layer = (
        list(sparsity_per_conv)
        if not isinstance(sparsity_per_conv, dict)
        else [sparsity_per_conv] * len(layers)
    )
    convs = [
        (conv, *_conv_masks(layer, spars[conv], tile, clustering, sample_groups, max_t, seed + 7919 * i))
        for i, (layer, spars) in enumerate(zip(layers, per_layer))
        for conv in (FWD, BWD_INPUT, BWD_WEIGHT)
    ]
    tds = simulate_tiles([m for _, m, _, _ in convs], n_lanes=tile.n_lanes, lookahead=tile.lookahead,
                         device=device) if convs else []
    totals: dict[str, list[float]] = {k: [0.0, 0.0] for k in (FWD, BWD_INPUT, BWD_WEIGHT)}
    for (conv, _, scale, dense), td in zip(convs, tds):
        r = _conv_result(td, scale, dense)
        totals[conv][0] += r.td_cycles
        totals[conv][1] += r.dense_cycles
    out = {conv: d / max(td, 1.0) for conv, (td, d) in totals.items()}
    td_all = sum(td for td, _ in totals.values())
    dense_all = sum(d for _, d in totals.values())
    out["overall"] = dense_all / max(td_all, 1.0)
    return out


def ffn_layers_from_config(cfg, n_layers: int | None = None) -> list[ConvLayer]:
    """Each layer's FFN contraction ``h @ w_down`` as an FC layer (``kx = ky
    = ox = oy = 1``, reduction over ``d_ff``, one output per ``d_model``
    unit): the layer set the training taps feed into :func:`model_speedup`."""
    n = n_layers if n_layers is not None else cfg.num_layers
    d_ff = cfg.d_ff or cfg.d_model * 4
    return [
        ConvLayer(name=f"ffn{i}", c_in=d_ff, kx=1, ky=1, c_out=cfg.d_model, ox=1, oy=1)
        for i in range(n)
    ]


def speedup_from_densities(
    a_density: Sequence[float],
    g_density: Sequence[float],
    layers: Sequence[ConvLayer],
    **kw,
) -> dict[str, float]:
    """Measured per-layer A and G densities -> modeled TensorDash speedup
    (the live Fig. 14 estimator): FWD is sparse in A, BWD_INPUT in G_O,
    BWD_WEIGHT in the sparser of the two (paper Eq. 1-3).  ``kw`` goes to
    :func:`model_speedup` (``device=`` among them: the card by default)."""
    if len(a_density) != len(layers) or len(g_density) != len(layers):
        raise ValueError(
            f"{len(layers)} layers but {len(a_density)} A / {len(g_density)} G densities"
        )
    spars = [
        {
            FWD: 1.0 - float(ad),
            BWD_INPUT: 1.0 - float(gd),
            BWD_WEIGHT: max(1.0 - float(ad), 1.0 - float(gd)),
        }
        for ad, gd in zip(a_density, g_density)
    ]
    return model_speedup(list(layers), spars, **kw)
