"""repro_torch.checkpoint against repro.checkpoint on the CPU.

* Format parity both ways: a flat tree of fp32, bf16 and int32 arrays
  saved by one package and read back by the other, bit for bit (bf16 as
  its ``uint16`` bit pattern with the ``dtypes`` sidecar; the port writes
  and reads it through ``Tensor.view``, never ``ml_dtypes``).
* The port's own trees: its per-layer parameter list and ``OptState`` (a
  named tuple with a Python-int step) round-trip exactly, keep-k prunes to
  the newest steps, ``latest_step``/``all_steps`` follow, restore places
  tensors on the ``like`` tree's device and dtype, and ``shardings=``
  raises.
* A model tree both ways: reduced deepseek-v2-236b (a ``dense_layers``
  stack, MLA leaves, ``[E, d, f]`` expert stacks and the fp32 router), its
  per-layer layout saved by one package and restored by the other bit for
  bit, keys and dtypes as the other writes them; the same for reduced
  mamba2-780m (its SSM layers) and reduced zamba2-2.7b (its groups, stacked
  twice in JAX, as lists of lists, and the shared block).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import manager as jman
from repro.models import model as JM
from repro.models.common import init_params as jinit_params
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM
from repro_torch.models.common import init_params
from repro_torch.optim.adamw import OptState, init_opt_state, tree_leaves


def _flat_arrays(seed=0):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((5, 7)).astype(np.float32)
    bf16 = torch.from_numpy(rng.standard_normal((3, 4, 6)).astype(np.float32)).to(torch.bfloat16)
    i32 = rng.integers(-2**31, 2**31 - 1, size=(9,), dtype=np.int64).astype(np.int32)
    return f32, bf16, i32


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def test_port_save_reads_in_jax(tmp_path):
    f32, bf16, i32 = _flat_arrays(1)
    tree = {"w": torch.from_numpy(f32), "h": bf16, "n": torch.from_numpy(i32)}
    base = str(tmp_path)
    d = tman.save(base, 3, tree)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"step": 3, "keys": ["h", "n", "w"], "dtypes": {"h": "bfloat16"}}
    with np.load(os.path.join(d, "arrays.npz")) as z:
        assert z["h"].dtype == np.uint16  # the JAX package's stored type
    like = {"w": jnp.zeros((5, 7), jnp.float32), "h": jnp.zeros((3, 4, 6), jnp.bfloat16),
            "n": jnp.zeros((9,), jnp.int32)}
    got = jman.restore(base, 3, like)
    np.testing.assert_array_equal(np.asarray(got["w"]), f32)
    np.testing.assert_array_equal(np.asarray(got["n"]), i32)
    assert got["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["h"]).view(np.uint16), _bits(bf16))


def test_jax_save_reads_in_port(tmp_path):
    f32, bf16, i32 = _flat_arrays(2)
    jbf16 = jnp.asarray(bf16.float().numpy()).astype(jnp.bfloat16)
    base = str(tmp_path)
    jman.save(base, 5, {"w": jnp.asarray(f32), "h": jbf16, "n": jnp.asarray(i32)})
    like = {"w": torch.zeros(5, 7), "h": torch.zeros(3, 4, 6, dtype=torch.bfloat16),
            "n": torch.zeros(9, dtype=torch.int32)}
    assert tman.latest_step(base) == 5
    got = tman.restore(base, 5, like)
    assert got["h"].dtype == torch.bfloat16 and got["n"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].numpy(), f32)
    np.testing.assert_array_equal(got["n"].numpy(), i32)
    np.testing.assert_array_equal(_bits(got["h"]), _bits(bf16))


def test_float8_round_trips_as_uint8(tmp_path):
    x = torch.linspace(-3, 3, 24).reshape(4, 6).to(torch.float8_e4m3fn)
    tman.save(tmp_path, 1, {"q": x})
    with open(tmp_path / "step_000000000001" / "meta.json") as f:
        assert json.load(f)["dtypes"] == {"q": "float8_e4m3fn"}
    got = tman.restore(tmp_path, 1, {"q": torch.zeros(4, 6, dtype=torch.float8_e4m3fn)})
    assert torch.equal(got["q"].view(torch.uint8), x.view(torch.uint8))


def test_params_and_opt_state_round_trip_keep_k(tmp_path):
    cfg = reduce_config(get_config("qwen3-4b"))
    params = init_params(TM.param_specs(cfg), seed=3, device="cpu")
    opt = init_opt_state(params)
    gen = torch.Generator().manual_seed(4)
    for m in tree_leaves(opt.m) + tree_leaves(opt.v):
        m.copy_(torch.randn(m.shape, generator=gen))
    opt = OptState(step=7, m=opt.m, v=opt.v)
    tree = {"params": params, "opt": opt}
    for step in (1, 2, 3, 4):
        tman.save(tmp_path, step, tree, keep=2)
    assert tman.all_steps(tmp_path) == [3, 4] and tman.latest_step(tmp_path) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_000000000003", "step_000000000004"]
    like = {"params": init_params(TM.param_specs(cfg), seed=9, device="cpu"),
            "opt": OptState(step=0, m=init_opt_state(params).m, v=init_opt_state(params).v)}
    step, got = tman.restore_latest(tmp_path, like)
    assert step == 4
    assert isinstance(got["opt"], OptState) and got["opt"].step == 7
    assert isinstance(got["params"]["layers"], list) and len(got["params"]["layers"]) == cfg.num_layers
    want, have = tree_leaves(tree)[1:], tree_leaves(got)[1:]  # [0] is opt.step
    assert len(want) == len(have) == len(tree_leaves(like)) - 1
    for a, b in zip(want, have):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    with np.load(tmp_path / "step_000000000004" / "arrays.npz") as z:
        assert "params/layers/1/attn/wq" in z.files and "opt/step" in z.files
        assert "opt/m/layers/0/mlp/w_down" in z.files


def _deepseek_v2_trees():
    """Reduced deepseek-v2-236b's bf16 parameters: the JAX tree in the
    port's per-layer layout (each stack unstacked into a list) and the
    port's tree converted from it."""
    jcfg = jconfigs.reduce_config(jconfigs.get_config("deepseek-v2-236b"))
    tcfg = reduce_config(get_config("deepseek-v2-236b"))
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(5), dtype=jnp.bfloat16)
    unstacked = {k: ([jax.tree.map(lambda x, i=i: x[i], v) for i in range(jax.tree.leaves(v)[0].shape[0])]
                     if k in ("layers", "dense_layers") else v) for k, v in jp.items()}
    return tcfg, unstacked, params_from_jax(jax.tree.map(np.asarray, jp), tcfg)


def _same_bits(tparams, jtree):
    for t, j in zip(tree_leaves(tparams), jax.tree.leaves(jtree)):
        assert t.dtype == {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[j.dtype.type]
        assert tuple(t.shape) == tuple(j.shape)
        want = np.asarray(j).view(np.uint16) if t.dtype == torch.bfloat16 else np.asarray(j)
        np.testing.assert_array_equal(_bits(t), want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_deepseek_v2_tree_round_trips_both_ways(tmp_path, writer):
    tcfg, jtree, tparams = _deepseek_v2_trees()
    mlp = tparams["layers"][0]["mlp"]
    assert len(tparams["dense_layers"]) == 1 and mlp["router"].dtype == torch.float32
    assert mlp["w_gate"].shape == (tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff)
    assert "wkv_b" in tparams["layers"][1]["attn"]
    if writer == "port":
        tman.save(tmp_path, 2, {"params": tparams})
        like = {"params": jax.tree.map(jnp.zeros_like, jtree)}
        got = jman.restore(str(tmp_path), 2, like)["params"]
        _same_bits(tparams, got)
    else:
        jman.save(str(tmp_path), 2, {"params": jtree})
        like = {"params": init_params(TM.param_specs(tcfg), seed=1, dtype=torch.bfloat16, device="cpu")}
        got = tman.restore(tmp_path, 2, like)["params"]
        _same_bits(got, jtree)
    with np.load(tmp_path / "step_000000000002" / "arrays.npz") as z:
        for key in ("params/dense_layers/0/mlp/w_down", "params/layers/1/mlp/router",
                    "params/layers/0/mlp/shared/w_up", "params/layers/1/attn/kv_norm"):
            assert key in z.files, key
    with open(tmp_path / "step_000000000002" / "meta.json") as f:
        dtypes = json.load(f)["dtypes"]
    assert "params/layers/1/mlp/router" not in dtypes and dtypes["params/layers/1/attn/wq_a"] == "bfloat16"


def _unstack(tree):
    """A stacked JAX tree as a list of its slices along the first axis."""
    return [jax.tree.map(lambda x, i=i: x[i], tree) for i in range(jax.tree.leaves(tree)[0].shape[0])]


def _ssm_trees(arch):
    """Reduced ``arch``'s bf16 parameters: the JAX tree in the port's layout
    (``layers`` unstacked into a list; a hybrid's ``groups``, stacked
    ``[n_groups, attn_every, ...]``, unstacked twice into lists of lists)
    and the port's tree converted from it."""
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    tcfg = reduce_config(get_config(arch))
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(6), dtype=jnp.bfloat16)
    layout = {"layers": _unstack, "groups": lambda g: [_unstack(x) for x in _unstack(g)]}
    unstacked = {k: layout.get(k, lambda v: v)(v) for k, v in jp.items()}
    return tcfg, unstacked, params_from_jax(jax.tree.map(np.asarray, jp), tcfg)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_and_hybrid_trees_round_trip_both_ways(tmp_path, arch, writer):
    tcfg, jtree, tparams = _ssm_trees(arch)
    if writer == "port":
        tman.save(tmp_path, 3, {"params": tparams})
        like = {"params": jax.tree.map(jnp.zeros_like, jtree)}
        got = jman.restore(str(tmp_path), 3, like)["params"]
        _same_bits(tparams, got)
    else:
        jman.save(str(tmp_path), 3, {"params": jtree})
        like = {"params": init_params(TM.param_specs(tcfg), seed=1, dtype=torch.bfloat16, device="cpu")}
        got = tman.restore(tmp_path, 3, like)["params"]
        _same_bits(got, jtree)
    keys = (("params/groups/1/0/ssm/in_z", "params/groups/0/1/ssm/conv_x_w", "params/shared/attn/wq",
             "params/shared/mlp/w_down") if tcfg.family == "hybrid"
            else ("params/layers/1/ssm/out_proj", "params/layers/0/ln"))
    with np.load(tmp_path / "step_000000000003" / "arrays.npz") as z:
        for key in keys:
            assert key in z.files, key
        assert len(z.files) == len(tree_leaves(tparams))


def test_restore_casts_to_like_and_refuses_shardings(tmp_path):
    """Restore casts to the ``like`` leaf; ``shardings=`` needs a mesh (a
    policy without one is refused; the sharded restore onto a mesh is in
    ``tests/test_torch_launch_mesh.py``)."""
    tman.save(tmp_path, 2, {"w": torch.arange(6, dtype=torch.float32)})
    got = tman.restore(tmp_path, 2, {"w": torch.zeros(6, dtype=torch.float64)})
    assert got["w"].dtype == torch.float64 and got["w"].tolist() == list(range(6))
    with pytest.raises(ValueError, match="shape"):
        tman.restore(tmp_path, 2, {"w": torch.zeros(7)})
    with pytest.raises(ValueError, match="mesh"):
        tman.restore(tmp_path, 2, {"w": torch.zeros(6)}, shardings={"w": (None,)})
    with pytest.raises(ValueError, match="mesh"):
        tman.save(tmp_path, 3, {"w": torch.zeros(6)}, shardings={"w": (None,)})


def test_save_is_atomic_over_a_stale_tmp(tmp_path):
    os.makedirs(tmp_path / "tmp.3")
    (tmp_path / "tmp.3" / "junk").write_text("torn write")
    tman.save(tmp_path, 3, {"w": torch.ones(2)})
    assert sorted(os.listdir(tmp_path)) == ["step_000000000003"]
    assert tman.all_steps(tmp_path / "missing") == [] and tman.latest_step(tmp_path / "missing") is None


def test_preemption_guard_sets_flag_and_restores_handler():
    import signal

    before = signal.getsignal(signal.SIGTERM)
    guard = tman.PreemptionGuard()
    assert not guard.should_save
    signal.raise_signal(signal.SIGTERM)
    assert guard.should_save
    guard.close()
    assert signal.getsignal(signal.SIGTERM) == before
