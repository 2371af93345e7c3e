"""``repro_torch.core``'s sparsity instrumentation, energy and power-gating
models against JAX's, on the CPU.

The energy and power-gating models are pure Python copies: their floats
must equal JAX's exactly (``==``).  The sparsity statistics are counts, so
they are exact too; ``block_density`` and the fractions are fp32 ratios of
exact counts.  ``grad_sparsity`` takes ``torch.autograd.grad`` of the loss
with respect to the probes where JAX takes ``jax.grad``: on a small ReLU
MLP like ``examples/train_cnn_sparsity.py``'s (two hidden layers, a probe
at each ReLU's input, where the cotangent is as sparse as the ReLU's
inactive units) the gradients' zero counts are equal, so the statistics
are.  JAX's own cases
(``tests/test_sparsity_energy.py``) run through the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.core import powergate as jpowergate
from repro.core import sparsity as jsparsity
from repro_torch.core import energy as tenergy
from repro_torch.core import powergate as tpowergate
from repro_torch.core import sparsity as tsparsity


def _stats(s):
    return [float(f) for f in s]


# ---------------------------------------------------------------------------
# JAX's tests/test_sparsity_energy.py through the port
# ---------------------------------------------------------------------------


def test_measure_counts():
    x = torch.tensor([[0.0, 1.0, 0.0, 2.0]] * 4)
    s = tsparsity.measure(x, block=4)
    assert (float(s.zeros), float(s.total), float(s.fraction)) == (8, 16, 0.5)


def test_block_mask_detects_zero_blocks():
    x = torch.zeros((2, 32))
    x[0, 16:] = 1.0
    assert tsparsity.block_mask(x, block=16).tolist() == [[True, False], [True, True]]


def test_block_mask_pads_partial_blocks():
    bm = tsparsity.block_mask(torch.ones((1, 20)), block=16)
    assert bm.shape == (1, 2) and not bool(bm.any())


def test_grad_probe_recovers_relu_mask():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32))

    def loss(params, probes):
        h = torch.relu(x @ params)
        h = tsparsity.apply_probes(h, probes, "post_relu")
        return torch.sum(h * h)

    probes = {"post_relu": torch.zeros((4, 8))}
    stats = tsparsity.grad_sparsity(loss, w, probes)
    relu_inactive = (x @ w) <= 0
    assert abs(float(stats["post_relu"].fraction) - float(relu_inactive.float().mean())) < 1e-6
    assert not probes["post_relu"].requires_grad  # the caller's probes are left alone


def test_energy_calibration_matches_paper():
    em = tenergy.EnergyModel(tenergy.FP32)
    assert abs(em.compute_area_overhead() - 1.09) < 0.02  # paper 1.09x
    assert abs(tenergy.EnergyModel(tenergy.BF16).compute_area_overhead() - 1.13) < 0.005
    eff = em.efficiency(1.95, sram_compression=1.4)
    assert 1.7 < eff["compute_efficiency"] < 2.1  # paper 1.89x
    assert 1.4 < eff["chip_efficiency"] < 1.9  # paper 1.6x


def test_powergate_no_sparsity_costs_nothing():
    out = tpowergate.gated_layer_outcome(0.0, 1.01)
    assert not out["enabled"] and out["speedup"] == 1.0 and out["energy_ratio"] == 1.0


def test_powergate_enables_on_sparsity():
    out = tpowergate.gated_layer_outcome(0.6, 1.9)
    assert out["enabled"] and out["energy_ratio"] < 0.6


# ---------------------------------------------------------------------------
# energy and power gating: the same floats as JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tech", ["FP32", "BF16"])
def test_tech_constants_equal_jax(tech):
    assert dataclasses.asdict(getattr(tenergy, tech)) == dataclasses.asdict(getattr(jenergy, tech))


@pytest.mark.parametrize("tech", ["FP32", "BF16"])
@pytest.mark.parametrize("speedup", [0.5, 1.0, 1.37, 1.95, 2.99])
@pytest.mark.parametrize("sram_compression,dram_compression", [(1.0, 1.0), (1.4, 1.1), (2.5, 3.0)])
def test_energy_model_equals_jax(tech, speedup, sram_compression, dram_compression):
    tm = tenergy.EnergyModel(getattr(tenergy, tech))
    jm = jenergy.EnergyModel(getattr(jenergy, tech))
    kw = dict(sram_compression=sram_compression, dram_compression=dram_compression, macs=3.3e11)
    assert tm.efficiency(speedup, **kw) == jm.efficiency(speedup, **kw)
    assert tm.compute_area_overhead() == jm.compute_area_overhead()
    assert tm.chip_area_overhead() == jm.chip_area_overhead()
    for td in (True, False):
        t = tm.run_energy(1e6 * speedup, 2e5, 3e5, 4e4, tensordash=td)
        j = jm.run_energy(1e6 * speedup, 2e5, 3e5, 4e4, tensordash=td)
        assert dataclasses.asdict(t) == dataclasses.asdict(j) and t.total_j == j.total_j


@pytest.mark.parametrize("sparsity", [0.0, 0.049, 0.05, 0.3, 0.9])
@pytest.mark.parametrize("speedup", [0.8, 1.0, 1.6, 2.7])
@pytest.mark.parametrize("tech", ["FP32", "BF16"])
def test_gated_layer_outcome_equals_jax(sparsity, speedup, tech):
    for min_sparsity in (0.05, 0.2):
        t = tpowergate.gated_layer_outcome(sparsity, speedup, tech=getattr(tenergy, tech),
                                           policy=tpowergate.GatePolicy(min_sparsity))
        j = jpowergate.gated_layer_outcome(sparsity, speedup, tech=getattr(jenergy, tech),
                                           policy=jpowergate.GatePolicy(min_sparsity))
        assert t == j


# ---------------------------------------------------------------------------
# the rest of sparsity.py against JAX's
# ---------------------------------------------------------------------------


def _sparse(seed, shape, density):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return np.where(rng.random(shape) < density, x, np.float32(0))


@pytest.mark.parametrize("block,axis", [(4, -1), (16, -1), (3, 0), (5, 1)])
def test_block_density_equals_jax(block, axis):
    x = _sparse(block, (12, 40), 0.1)
    t = tsparsity.block_density(torch.from_numpy(x), block=block, axis=axis)
    j = jsparsity.block_density(jnp.asarray(x), block=block, axis=axis)
    assert t.dtype == torch.float32 and float(t) == pytest.approx(float(j), rel=1e-6)
    np.testing.assert_array_equal(
        tsparsity.block_mask(torch.from_numpy(x), block=block, axis=axis).numpy(),
        np.asarray(jsparsity.block_mask(jnp.asarray(x), block=block, axis=axis)))


def test_merge_stats_equals_jax():
    xs = [_sparse(i, (6, 20), 0.3 + 0.2 * i) for i in range(3)]
    t = tsparsity.merge_stats([tsparsity.measure(torch.from_numpy(x)) for x in xs])
    j = jsparsity.merge_stats([jsparsity.measure(jnp.asarray(x)) for x in xs])
    assert _stats(t) == _stats(j)
    assert float(t.block_fraction) == pytest.approx(float(j.block_fraction), rel=1e-6)


@pytest.mark.parametrize("shape,n_lanes", [((3, 5, 32), 16), ((7, 20), 16), ((2, 9), 4)])
def test_lane_streams_equals_jax(shape, n_lanes):
    x = _sparse(1, shape, 0.5)
    t = tsparsity.lane_streams(torch.from_numpy(x), n_lanes)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jsparsity.lane_streams(jnp.asarray(x), n_lanes)))


def test_apply_probes_equals_jax():
    x = _sparse(2, (4, 8), 0.5)
    probe = np.zeros((4, 8), np.float32)
    for probes in (None, {"other": probe}, {"tap": probe}):
        t = tsparsity.apply_probes(torch.from_numpy(x), probes and {k: torch.from_numpy(v) for k, v in probes.items()}, "tap")
        j = jsparsity.apply_probes(jnp.asarray(x), probes and {k: jnp.asarray(v) for k, v in probes.items()}, "tap")
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _mlp_weights(seed):
    rng = np.random.default_rng(seed)
    w = {"w0": rng.standard_normal((12, 16)) / np.sqrt(12),
         "w1": rng.standard_normal((16, 16)) / np.sqrt(16),
         "head": rng.standard_normal((16, 4)) * 0.05}
    return {k: v.astype(np.float32) for k, v in w.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grad_sparsity_equals_jax_on_a_relu_mlp(seed):
    rng = np.random.default_rng(100 + seed)
    x = rng.standard_normal((8, 12)).astype(np.float32)
    y = rng.integers(0, 4, 8)
    w = _mlp_weights(seed)

    def jloss(params, probes, x, y):
        h = x
        for i in range(2):
            h = jnp.maximum(jsparsity.apply_probes(h @ params[f"w{i}"], probes, f"g{i}"), 0.0)
        ll = jax.nn.log_softmax(h @ params["head"])
        return -jnp.mean(jnp.take_along_axis(ll, y[:, None], 1))

    def tloss(params, probes, x, y):
        h = x
        for i in range(2):
            h = torch.relu(tsparsity.apply_probes(h @ params[f"w{i}"], probes, f"g{i}"))
        return torch.nn.functional.cross_entropy(h @ params["head"], y)

    jprobes = {f"g{i}": jnp.zeros((8, 16), jnp.float32) for i in range(2)}
    tprobes = {f"g{i}": torch.zeros((8, 16)) for i in range(2)}
    j = jsparsity.grad_sparsity(jloss, {k: jnp.asarray(v) for k, v in w.items()}, jprobes,
                                jnp.asarray(x), jnp.asarray(y))
    t = tsparsity.grad_sparsity(tloss, {k: torch.from_numpy(v) for k, v in w.items()}, tprobes,
                                torch.from_numpy(x), torch.from_numpy(y))
    assert sorted(t) == sorted(j) == ["g0", "g1"]
    for k in j:
        assert _stats(t[k]) == _stats(j[k])
        assert 0.0 < float(t[k].fraction) < 1.0  # the ReLUs make these cotangents sparse
