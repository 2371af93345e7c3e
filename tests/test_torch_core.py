"""repro_torch.core (the paper's scheduler, PE and performance model)
against repro.core, on the CPU (``device="cpu"``: the cycle model runs on
the card by default).  Everything here is integer
schedules and cycle counts, so every comparison is exact: the mux tables
and levels, one scheduler step (selections, remaining bits, drain count)
over random staging windows, stream and tile cycle counts, the clustered
masks and ``model_speedup``, the tuner's analytic prior."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import pe as jpe
from repro.core import perf_model as jpm
from repro.core import scheduler as jsched
from repro_torch.core import pe as tpe
from repro_torch.core import perf_model as tpm
from repro_torch.core import scheduler as tsched

LANES = [(16, 2), (16, 1), (8, 2), (4, 2)]


@pytest.mark.parametrize("n_lanes,lookahead", LANES)
def test_mux_tables_and_levels_equal_jax(n_lanes, lookahead):
    for j, t in zip(jsched.connectivity(n_lanes, lookahead), tsched.connectivity(n_lanes, lookahead)):
        np.testing.assert_array_equal(j, t)
    assert tsched.levels(n_lanes, lookahead) == jsched.levels(n_lanes, lookahead)
    step = tsched.make_schedule_step(n_lanes, lookahead)
    assert step.n_options == jsched.make_schedule_step(n_lanes, lookahead).n_options


@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("n_lanes,lookahead", LANES)
def test_schedule_step_equals_jax(n_lanes, lookahead, density):
    rng = np.random.default_rng(int(density * 10) + n_lanes)
    z = rng.random((24, lookahead + 1, n_lanes)) < density
    got = tsched.make_schedule_step(n_lanes, lookahead)(z)  # one batched call
    jstep = jsched.make_schedule_step(n_lanes, lookahead)
    for i in range(z.shape[0]):
        want = jstep(jnp.asarray(z[i]))
        np.testing.assert_array_equal(got.sel[i], np.asarray(want.sel))
        np.testing.assert_array_equal(got.z_out[i], np.asarray(want.z_out))
        assert int(got.advance[i]) == int(want.advance)
    # every effectual pair of row 0 is consumed: the dense option drains it
    assert not got.z_out[:, 0].any()


@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_stream_and_tile_cycles_equal_jax(density):
    rng = np.random.default_rng(5)
    tiles = rng.random((3, 4, 37, 16)) < density
    got = tpe.simulate_tile(tiles, device="cpu").cycles
    for g in range(3):
        assert int(got[g]) == int(jpe.simulate_tile(jnp.asarray(tiles[g])).cycles)
        s = tpe.simulate_stream(tiles[g, 0], device="cpu")
        assert int(s.cycles) == int(jpe.simulate_stream(jnp.asarray(tiles[g, 0])).cycles)
        assert int(s.dense) == 37


def test_clustered_masks_and_model_speedup_equal_jax():
    for clustering in (0.0, 0.4, 0.9):
        np.testing.assert_array_equal(
            tpm.make_clustered_masks(np.random.default_rng(1), 8, 20, 16, 0.3, clustering),
            jpm.make_clustered_masks(np.random.default_rng(1), 8, 20, 16, 0.3, clustering))
    jl = [jpm.ConvLayer(name=f"l{i}", c_in=c, kx=k, ky=k, c_out=o, ox=4, oy=4)
          for i, (c, k, o) in enumerate([(64, 3, 32), (128, 1, 64)])]
    tl = [tpm.ConvLayer(name=f"l{i}", c_in=c, kx=k, ky=k, c_out=o, ox=4, oy=4)
          for i, (c, k, o) in enumerate([(64, 3, 32), (128, 1, 64)])]
    spars = {jpm.FWD: 0.6, jpm.BWD_INPUT: 0.3, jpm.BWD_WEIGHT: 0.7}
    assert tpm.model_speedup(tl, spars, max_t=64, device="cpu") == jpm.model_speedup(jl, spars, max_t=64)
    per_layer = [spars, {jpm.FWD: 0.1, jpm.BWD_INPUT: 0.9, jpm.BWD_WEIGHT: 0.9}]
    assert (tpm.model_speedup(tl, per_layer, max_t=64, device="cpu")
            == jpm.model_speedup(jl, per_layer, max_t=64))


def test_tuner_prior_speedup_equals_jax():
    """The autotuner's accelerator-model ceiling at one of its cells."""
    from repro.tune import search as jsearch
    from repro_torch.tune import search as tsearch

    assert tsearch._modeled_speedup(256, 128, 0.25, "cpu") == jsearch._modeled_speedup(256, 128, 0.25)
