"""The plan layer and the spec tables of the distributed slice against the
JAX package, on the CPU, with no process group.

* ``shard_plan``/``unshard_plan``, ``balanced_row_order``, the per-shard
  queues and ``PlanCache.plan_stats(shards=)`` of ``repro_torch`` equal
  ``repro``'s bit for bit on the power-law operand of JAX's
  ``tests/test_sharded_spmm.py`` (``BM = BK = 8``, 8 shards), over axes M,
  N and K and both deals; the balanced deal stays within 10% where the
  contiguous split is more than 2x off; a dynamic-sparsity edit of the plan
  shards to the same queues in both packages.
* Each case of JAX's ``tests/test_sharding.py``, and the spec tables over
  whole configs: the port's tuples equal JAX's ``PartitionSpec`` entries on
  duck-typed meshes of the same shapes (the port's layers are a list, so
  its layer leaves drop JAX's leading stacked-layer dim).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import SHAPES, get_config as jget_config
from repro.kernels.ref import plan_workqueue_ref
from repro.models import model as JM
from repro.models.common import Spec as JSpec
from repro.parallel import sharding as JS
from repro.sparse_train.plan_edit import PlanDelta as JPlanDelta
from repro.sparse_train.plan_edit import edit_plan as jedit_plan
from repro_torch import runtime as trt
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models.common import Spec
from repro_torch.parallel import sharding as TS
from repro_torch.sparse_train.plan_edit import PlanDelta, edit_plan
from test_torch_sharded_spmm import powerlaw_operand

BM = BK = BN = 8
SHARDS = 8
ARRAYS = ("nnz", "idx", "row_starts", "work_row", "work_kblk")


@pytest.fixture(scope="module")
def plans():
    a = powerlaw_operand(np.random.default_rng(5))
    return (jrt.plan_operand(jnp.asarray(a), bm=BM, bk=BK),
            trt.plan_operand(torch.from_numpy(a), BM, BK), a)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# plan layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", ["M", "N", "K"])
@pytest.mark.parametrize("balance", [True, False])
def test_shard_plan_equals_jax(plans, axis, balance):
    jplan, tplan, _ = plans
    js = jrt.shard_plan(jplan, SHARDS, axis=axis, balance=balance)
    ts = trt.shard_plan(tplan, SHARDS, axis=axis, balance=balance)
    assert (ts.axis, ts.n_shards) == (js.axis, js.n_shards)
    for name in ("order",) + ARRAYS:
        got, want = _np(getattr(ts, name)), _np(getattr(js, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=f"{axis} {name}")
    np.testing.assert_array_equal(ts.shard_work(), js.shard_work())
    assert ts.imbalance() == js.imbalance()
    assert ts.stats() == js.stats()


@pytest.mark.parametrize("axis", ["M", "N", "K"])
@pytest.mark.parametrize("balance", [True, False])
def test_unshard_plan_round_trip_equals_jax(plans, axis, balance):
    jplan, tplan, _ = plans
    back = trt.unshard_plan(trt.shard_plan(tplan, SHARDS, axis=axis, balance=balance))
    jback = jrt.unshard_plan(jrt.shard_plan(jplan, SHARDS, axis=axis, balance=balance))
    for name in ARRAYS:
        np.testing.assert_array_equal(_np(getattr(back, name)), _np(getattr(tplan, name)), err_msg=name)
        np.testing.assert_array_equal(_np(getattr(back, name)), _np(getattr(jback, name)), err_msg=name)
    assert (back.shape, back.bm, back.bk, back.side) == (tplan.shape, tplan.bm, tplan.bk, tplan.side)


@pytest.mark.parametrize("n_shards", [2, 4, 8, 16])
def test_balanced_row_order_equals_jax_on_host_and_tensor(plans, n_shards):
    jplan, tplan, _ = plans
    want = np.asarray(jrt.balanced_row_order(jplan.nnz, n_shards))
    host = trt.balanced_row_order(_np(tplan.nnz), n_shards)
    on_tensor = trt.balanced_row_order(tplan.nnz, n_shards)
    assert isinstance(host, np.ndarray) and isinstance(on_tensor, torch.Tensor)
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(on_tensor.numpy(), want)
    with pytest.raises(ValueError, match="not divisible"):
        trt.balanced_row_order(tplan.nnz, 3)


@pytest.mark.parametrize("axis", ["M", "N", "K"])
def test_per_shard_queues_match_the_oracle(plans, axis):
    _, tplan, _ = plans
    shards = tplan.shard(SHARDS, axis=axis)
    assert tplan.shard(SHARDS, axis=axis) is shards  # memoized on the plan
    for s in range(SHARDS):
        rs, wr, wk = plan_workqueue_ref(shards.nnz[s], shards.idx[s])
        np.testing.assert_array_equal(shards.row_starts[s], rs)
        np.testing.assert_array_equal(shards.work_row[s], wr)
        np.testing.assert_array_equal(shards.work_kblk[s], wk)
    if axis == "M":
        assert int(shards.shard_work().sum()) == tplan.total_work()


def test_balanced_deal_within_10pct_where_contiguous_exceeds_2x(plans):
    _, tplan, _ = plans
    contiguous = tplan.shard(SHARDS, axis="M", balance=False).imbalance()
    balanced = tplan.shard(SHARDS, axis="M", balance=True).imbalance()
    assert contiguous > 2.0 and balanced <= 1.10, (contiguous, balanced)


def test_shard_refuses_bad_axes_and_counts(plans):
    _, tplan, _ = plans
    with pytest.raises(ValueError, match="shard axis"):
        trt.shard_plan(tplan, 2, axis="Q")
    with pytest.raises(ValueError, match="block rows not divisible"):
        trt.shard_plan(tplan, 3, axis="M")
    with pytest.raises(ValueError, match="K blocks not divisible"):
        trt.shard_plan(tplan, 3, axis="K")


@pytest.mark.parametrize("shards", [None, 8, 3])
def test_plan_stats_with_shards_equals_jax(plans, shards):
    _, _, a = plans
    jr = jrt.Runtime(backend="reference", bm=BM, bk=BK, bn=BN)
    tr = trt.Runtime(backend="reference", device="cpu", bm=BM, bk=BK, bn=BN)
    b = np.random.default_rng(1).normal(size=(a.shape[1], 64)).astype(np.float32)
    jr.matmul(jnp.asarray(a), jnp.asarray(b), plan_key="w0")
    tr.matmul(torch.from_numpy(a), torch.from_numpy(b), plan_key="w0")
    want = next(s for s in jr.plan_cache.plan_stats(shards=shards) if s["key"] == "w0")
    got = next(s for s in tr.plan_cache.plan_stats(shards=shards) if s["key"] == "w0")
    assert got == want
    assert ("imbalance" in got) == (shards == 8)
    if shards == 8:
        assert sum(got["shard_work"]) == got["total_work"] and len(got["shard_skipped"]) == 8


def test_dynamic_refresh_edit_shards_as_jax(plans):
    """JAX's refresh edit (prune a live block of the densest row, regrow a
    dead one in the emptiest): the edited plan's per-shard queues equal
    JAX's and the oracle's, and the memo of the unedited plan is not
    reused."""
    jplan, tplan, _ = plans
    shards0 = tplan.shard(SHARDS, axis="M")
    nnz, idx = _np(tplan.nnz), _np(tplan.idx)
    dense_r, sparse_r = int(nnz.argmax()), int(nnz.argmin())
    live = (dense_r, int(idx[dense_r, 0]))
    dead = sorted(set(range(idx.shape[1])) - set(idx[sparse_r, : nnz[sparse_r]]))[0]
    edited = edit_plan(tplan, PlanDelta.make([live], [(sparse_r, dead)]))
    jedited = jedit_plan(jplan, JPlanDelta.make([live], [(sparse_r, dead)]))
    es, jes = edited.shard(SHARDS, axis="M"), jedited.shard(SHARDS, axis="M")
    assert es is not shards0
    for name in ("order",) + ARRAYS:
        np.testing.assert_array_equal(_np(getattr(es, name)), _np(getattr(jes, name)), err_msg=name)
    for s in range(SHARDS):
        rs, wr, wk = plan_workqueue_ref(es.nnz[s], es.idx[s])
        np.testing.assert_array_equal(es.row_starts[s], rs)
        np.testing.assert_array_equal(es.work_row[s], wr)
        np.testing.assert_array_equal(es.work_kblk[s], wk)


# ---------------------------------------------------------------------------
# spec tables
# ---------------------------------------------------------------------------


def fake_mesh(shape: dict):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


MESH = fake_mesh({"data": 16, "model": 16})
MESH3 = fake_mesh({"pod": 2, "data": 16, "model": 16})
MESH4 = fake_mesh({"data": 2, "model": 2})


def _entries(p) -> tuple:
    """A ``PartitionSpec``'s entries."""
    return tuple(p)


def test_tp_fsdp_2d_sharding():
    ps = TS.param_pspecs({"w": Spec((4096, 11008), axes=("embed", "mlp"))}, MESH)
    want = JS.param_pspecs({"w": JSpec((4096, 11008), ("embed", "mlp"))}, MESH)
    assert ps["w"] == ("data", "model") == _entries(want["w"])


def test_non_divisible_falls_back_to_replicated():
    ps = TS.param_pspecs({"w": Spec((50280, 1536), axes=("vocab", "embed"))}, MESH)
    want = JS.param_pspecs({"w": JSpec((50280, 1536), ("vocab", "embed"))}, MESH)
    assert ps["w"] == (None, "data") == _entries(want["w"])


def test_small_kv_heads_flattened_dim_shards():
    ps = TS.param_pspecs(TM.param_specs(get_config("gemma2-2b")), MESH)
    want = JS.param_pspecs(JM.param_specs(jget_config("gemma2-2b")), MESH)
    assert ps["layers"][0]["attn"]["wk"] == ("data", "model") == _entries(want["layers"]["attn"]["wk"])[1:]


def test_truly_non_divisible_dim_replicates():
    ps = TS.param_pspecs({"wk": Spec((128, 24), axes=("embed", "kv_heads"))}, MESH)
    assert ps["wk"] == ("data", None)


def test_moe_expert_sharding_matches_the_expert_parallel_contract():
    ps = TS.param_pspecs(TM.param_specs(get_config("deepseek-v2-236b")), MESH3)
    want = JS.param_pspecs(JM.param_specs(jget_config("deepseek-v2-236b")), MESH3)
    mlp = ps["layers"][0]["mlp"]
    assert mlp["w_gate"] == ("model", None, "data") == _entries(want["layers"]["mlp"]["w_gate"])[1:]
    assert mlp["w_down"] == ("model", "data", None) == _entries(want["layers"]["mlp"]["w_down"])[1:]


def test_batch_pspec_uses_all_dp_axes():
    bp = TS.batch_pspecs(get_config("deepseek-7b"), SHAPES["train_4k"], MESH3)
    want = JS.batch_pspecs(jget_config("deepseek-7b"), SHAPES["train_4k"], MESH3)
    assert bp["tokens"] == (("pod", "data"), None) == _entries(want["tokens"])
    assert bp["labels"] == _entries(want["labels"])


def test_long_decode_batch1_not_batch_sharded():
    bp = TS.batch_pspecs(get_config("mamba2-780m"), SHAPES["long_500k"], MESH)
    assert bp["tokens"] == (None, None) == _entries(JS.batch_pspecs(jget_config("mamba2-780m"),
                                                                    SHAPES["long_500k"], MESH)["tokens"])


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _jax_leaf(tree, path):
    """JAX's spec at the port's ``path``: a list index is JAX's stacked
    leading dim, dropped from the spec."""
    stacked = False
    for key in path:
        if isinstance(key, int):
            stacked = True
            continue
        tree = tree[key]
    return _entries(tree)[1:] if stacked else _entries(tree)


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-4b", "gemma2-2b", "qwen3-moe-235b-a22b",
                                  "deepseek-v2-236b", "mamba2-780m", "starcoder2-3b", "musicgen-large"])
@pytest.mark.parametrize("mesh", [MESH, MESH3, MESH4], ids=["16x16", "2x16x16", "2x2"])
def test_param_pspecs_of_whole_configs_equal_jax(arch, mesh):
    want = JS.param_pspecs(JM.param_specs(jget_config(arch)), mesh)
    got = TS.param_pspecs(TM.param_specs(get_config(arch)), mesh)
    leaves = list(_walk(got))
    assert leaves
    for path, spec in leaves:
        assert spec == _jax_leaf(want, path), path


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-780m", "musicgen-large", "qwen2-vl-72b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "long_500k"])
def test_batch_and_logits_pspecs_equal_jax(arch, shape):
    cfg, jcfg, sh = get_config(arch), jget_config(arch), SHAPES[shape]
    for mesh in (MESH, MESH3, MESH4):
        got, want = TS.batch_pspecs(cfg, sh, mesh), JS.batch_pspecs(jcfg, sh, mesh)
        assert got == {k: _entries(v) for k, v in want.items()}
        assert TS.logits_pspec(cfg, sh, mesh) == _entries(JS.logits_pspec(jcfg, sh, mesh))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_pspecs_equal_jax(shape):
    sh = SHAPES[shape]
    b, s = sh.global_batch, sh.seq_len
    leaves = {"kv": (4, b, s, 8, 128), "latent": (4, b, s, 512), "conv": (4, b, 3, 96),
              "state": (4, b, 48, 64, 128), "pos": (b,), "none": (7, 5)}
    tree = {k: types.SimpleNamespace(shape=v) for k, v in leaves.items()}
    jtree = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in leaves.items()}
    cfg, jcfg = get_config("deepseek-7b"), jget_config("deepseek-7b")
    for mesh in (MESH, MESH3, MESH4):
        got = TS.cache_pspecs(cfg, sh, mesh, tree)
        want = JS.cache_pspecs(jcfg, sh, mesh, jtree)
        assert got == {k: _entries(v) for k, v in want.items()}, mesh


def test_rules_override_and_meshless_policy():
    specs = {"w": Spec((64, 32), axes=("embed", "mlp")), "n": Spec((32,)), "b": [Spec((8, 4))]}
    policy = TS.ShardingPolicy(mesh=MESH4, rules={"mlp": "data", "embed": None})
    jpolicy = JS.ShardingPolicy(mesh=MESH4, rules={"mlp": "data", "embed": None})
    assert policy.rule_table == jpolicy.rule_table
    rules_only = TS.ShardingPolicy(rules={"mlp": "data"})
    assert hash(rules_only) == hash(rules_only.replace()) and rules_only.rules == (("mlp", "data"),)
    assert policy.param_pspecs(specs)["w"] == (None, "data")
    assert policy.param_pspecs(specs)["n"] == (None,)
    one = TS.ShardingPolicy()
    assert one.param_pspecs(specs) == {"w": (None, None), "n": (None,), "b": [(None, None)]}
    assert one.spmm_axes("M") == ((), 1, None) and one.spmm_axes("K") == ((), 1, None)
    assert one.batch_pspecs(get_config("deepseek-7b"), SHAPES["train_4k"]) == {
        "tokens": (None, None), "labels": (None, None)}
    assert one.logits_pspec(get_config("musicgen-large"), SHAPES["train_4k"]) == (None,) * 4
    x = torch.ones(4, 6)
    assert TS.local_shard(x, ("data", "model"), one) is x and one.constrain(x, ("data", None)) is x
    with pytest.raises(ValueError, match="shard axis"):
        one.spmm_axes("Q")
    with pytest.raises(ValueError, match="do not name"):
        Spec((2, 3), axes=("embed",))
