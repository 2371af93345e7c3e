"""The port's initializer against JAX's on the CPU.

``repro_torch.prng.normal`` is ``jax.random.normal(key, shape, float32)``
bit for bit: the uniform on ``[nextafter(-1, 0), 1)``, XLA's float32
``erf_inv`` with the log1p XLA's CPU backend computes for it, every fused
multiply-add rounded once, times float32 ``sqrt(2)``.  The cases below
hold it over 2**20 draws of one key, five seeds and six shapes, and blocks
of a leaf (a layer of a stack, a rank's slice): no draw differs.  Also the
Threefry hash at counters whose high word is not zero, and the counter
layout against ``iota_2x32_shape``.

``init_params(specs, seed=s)`` equals JAX's ``init_params(specs,
PRNGKey(s))`` after ``params_from_jax``, leaf for leaf: every registered
config reduced in bf16, one in fp32 at another seed, a sub-tree
(``moe_specs``), and a TP-4 rank's shards, each the slice of the whole draw.
Measured: 0 elements differ in any of them, in bf16 or fp32, so the bounds
below are equality.  Each leaf's std is JAX's for the stacked shape it
draws (the MoE experts' ``[L, E, d, f]`` fan-in ``E * d``).  The CNN
example's ``init_cnn`` equals JAX's, and chip_smoke.py's literals of JAX's
draws equal JAX's.  The fill kernel's card path is driven with a spy
library that re-enacts the kernel's index walk.  Last, the two serve
launchers on the same greedy command line emit the same tokens, each from
its own package's initializer.
"""
import contextlib
import ctypes
import importlib.util
import io
import math
import re
import types
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models.common import Spec as JSpec
from repro.models.common import _fan_in as jfan_in
from repro.models.common import init_params as jinit_params
from repro_torch import configs as tconfigs
from repro_torch import prng
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.common import Spec, init_params
from repro_torch.parallel import sharding as S

ROOT = Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 42, 2**31 + 7, 2**32 + 3]
SHAPES = [(), (1,), (7,), (3, 4), (2, 3, 5), (257, 129)]
#: bf16 elements that may differ from JAX's (measured: 0) and fp32 ulps
BF16_DIFFS, FP32_ULPS = 0, 0


def _bits(x) -> np.ndarray:
    """The bit patterns of a float32 or bfloat16 array or tensor."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)).numpy().astype(np.int64)
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32).astype(np.int64)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _assert_trees_equal(got, want, *, bf16_diffs=BF16_DIFFS, fp32_ulps=FP32_ULPS):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        diff = np.abs(_bits(g) - _bits(w))
        if g.dtype == torch.bfloat16:
            assert int((diff != 0).sum()) <= bf16_diffs and int(diff.max(initial=0)) <= 1, path
        else:
            assert int(diff.max(initial=0)) <= fp32_ulps, path


# ---------------------------------------------------------------------------
# prng.normal and the hash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_equals_jax(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.normal(key, shape, jnp.float32))
        got = prng.normal(tkey, shape)
        assert got.dtype == torch.float32 and np.array_equal(_bits(got), _bits(want)), shape


def test_normal_equals_jax_over_a_million_draws():
    """2**20 draws: both of erf_inv's branches (w >= 5 on about 0.6% of
    them) and both of log1p's, bit for bit."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1 << 20,), jnp.float32))
    got = prng.normal(prng.prng_key(3), (1 << 20,))
    assert np.array_equal(_bits(got), _bits(want))
    assert (np.abs(want) > 2.9).sum() > 1000  # w >= 5 is |x| > ~0.9966: normals past ~2.93


@pytest.mark.parametrize("full,block,starts", [
    ((6, 5, 7), (1, 5, 7), (4, 0, 0)),  # a layer of a stack
    ((6, 5, 7), (6, 5, 2), (0, 0, 3)),  # a column slice
    ((6, 5, 7), (2, 3, 4), (1, 2, 3)),
    ((4, 3, 8, 6), (1, 3, 8, 3), (2, 0, 0, 3)),  # a layer's experts, half the columns
    ((1001,), (333,), (667,)),
])
def test_normal_blocks_are_slices_of_the_whole_draw(full, block, starts):
    key, tkey = jax.random.PRNGKey(11), prng.prng_key(11)
    whole = np.asarray(jax.random.normal(key, full, jnp.float32))
    want = whole[tuple(slice(s, s + n) for s, n in zip(starts, block))]
    got = prng.normal(tkey, block, full=full, starts=starts)
    assert np.array_equal(_bits(got), _bits(want))
    # the same block as a flat offset into the leaf, where it is one range
    if all(n == f for n, f in zip(block[1:], full[1:])):
        n = math.prod(full[1:])
        flat = prng.normal(tkey, block, offset=starts[0] * n)
        assert np.array_equal(_bits(flat), _bits(want))


def test_threefry_at_high_counter_words_equals_jax():
    """The hash of counters ``(hi, lo)`` with ``hi`` up to ``2**32 - 1``
    (an element past index ``2**32`` of a stacked leaf) equals JAX's
    ``threefry2x32`` primitive, and an element's counter is its flat index
    split as ``iota_2x32_shape`` splits it."""
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    hi = np.array([0, 1, 2, 7, 0xFFFFFFFF, 12345], np.uint32)
    lo = np.array([0, 5, 0xFFFFFFFF, 3, 1, 99], np.uint32)
    want = jprng.threefry2x32_p.bind(*(jnp.broadcast_to(jnp.uint32(w), hi.shape) for w in k), jnp.asarray(hi),
                                     jnp.asarray(lo))
    t = lambda a: torch.from_numpy(a.astype(np.int64))
    got = prng.threefry2x32(t(k[:1]), t(k[1:]), t(hi), t(lo))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    for shape in ((3, 4), (2, 3, 5), (17,)):
        jhi, jlo = jprng.iota_2x32_shape(shape)
        idx = prng.flat_index(shape)
        assert np.array_equal((idx >> 32).numpy(), np.asarray(jhi)) and np.array_equal(
            (idx & 0xFFFFFFFF).numpy(), np.asarray(jlo))
    # layer 7 of qwen3-moe's stacked w_gate starts past 2**32
    first = prng.block_layout((1, 2, 4, 3), 0, (94, 128, 4096, 1536), (7, 5, 100, 0))[2]
    assert first == 7 * 128 * 4096 * 1536 + 5 * 4096 * 1536 + 100 * 1536 and first >> 32 == 1
    assert int(prng.flat_index((1, 2, 4, 3), 0, (94, 128, 4096, 1536), (7, 5, 100, 0))[0, 1, 3, 2]) == \
        first + 4096 * 1536 + 3 * 1536 + 2


# ---------------------------------------------------------------------------
# each leaf's std: JAX's for the stacked shape it draws
# ---------------------------------------------------------------------------


def _jax_std(s: JSpec) -> float | None:
    if s.init in ("ones", "zeros"):
        return None
    if s.init == "embed":
        return 1.0
    if s.scale is not None:
        return s.scale
    return 0.02 if s.init == "scaled" else 1 / math.sqrt(jfan_in(s.shape))


def _jax_specs(arch: str, reduced: bool) -> dict:
    cfg = jconfigs.get_config(arch)
    cfg = jconfigs.reduce_config(cfg) if reduced else cfg
    flat, _ = jax.tree_util.tree_flatten_with_path(JM.param_specs(cfg), is_leaf=lambda x: isinstance(x, JSpec))
    return {tuple(k.key for k in path): s for path, s in flat}


@pytest.mark.parametrize("arch", tconfigs.ALL_ARCHS)
def test_drawn_std_of_every_leaf_is_jax_stacked_std(arch):
    """Each leaf of the reduced config, drawn from seed 0 (all layers of a
    stack pooled), has the std JAX draws its stacked leaf at, within
    sampling error: qwen3-moe's and deepseek-v2's experts at ``1/sqrt(E *
    d)``, not ``1/sqrt(d)``."""
    params = init_params(TM.param_specs(tconfigs.reduce_config(tconfigs.get_config(arch))), seed=0,
                         device="cpu")
    pooled: dict[tuple, list] = {}
    for path, x in _leaves(params):
        pooled.setdefault(tuple(p for p in path.split("/")[1:] if not p.isdigit()), []).append(x.float().flatten())
    jspecs = _jax_specs(arch, reduced=True)
    assert pooled.keys() == jspecs.keys()
    checked = 0
    for path, xs in pooled.items():
        want = _jax_std(jspecs[path])
        if want is None:
            continue
        x = torch.cat(xs)
        tol = max(0.05, 6 / math.sqrt(2 * x.numel()))
        assert abs(float(x.pow(2).mean().sqrt()) / want - 1) < tol, (path, float(x.std()), want)
        checked += 1
    assert checked


@pytest.mark.parametrize("arch", tconfigs.ALL_ARCHS)
def test_leaf_std_rule_at_full_width_is_jax(arch):
    """At the registered widths, with no draws: the stacked leaves in JAX's
    flatten order, each with JAX's init and JAX's std."""
    from repro_torch.models.common import leaf_std, stacked_leaves

    leaves = stacked_leaves(TM.param_specs(tconfigs.get_config(arch)))
    jspecs = _jax_specs(arch, reduced=False)
    assert list(leaves) == list(jspecs)
    for path, (spec, lead) in leaves.items():
        js = jspecs[path]
        assert lead + tuple(spec.shape) == tuple(js.shape) and spec.init == js.init, path
        if js.init not in ("ones", "zeros"):
            assert leaf_std(spec, lead + tuple(spec.shape)) == pytest.approx(_jax_std(js), rel=1e-12), path
    if arch in ("qwen3-moe-235b-a22b", "deepseek-v2-236b"):
        cfg = tconfigs.get_config(arch)
        spec, lead = leaves[("layers", "mlp", "w_gate")]
        assert leaf_std(spec, lead + tuple(spec.shape)) == pytest.approx(
            1 / math.sqrt(cfg.num_experts * cfg.d_model))


def test_stacked_leaves_refuses_layers_that_differ():
    from repro_torch.models.common import stacked_leaves

    with pytest.raises(ValueError, match="same specs"):
        stacked_leaves({"layers": [{"w": Spec((4, 4))}, {"w": Spec((4, 8))}]})
    with pytest.raises(ValueError, match="in a stack"):
        stacked_leaves({"layers": [{"w": Spec((4, 4))}, {"w": Spec((4, 4)), "v": Spec((4,))}]})


# ---------------------------------------------------------------------------
# init_params against JAX's
# ---------------------------------------------------------------------------


def _jax_init(arch: str, seed: int, dtype=jnp.bfloat16):
    cfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    return jax.tree.map(np.asarray, jinit_params(JM.param_specs(cfg), jax.random.PRNGKey(seed), dtype))


@pytest.mark.parametrize("arch", tconfigs.ALL_ARCHS)
def test_init_params_equals_jax_bf16(arch):
    tcfg = tconfigs.reduce_config(tconfigs.get_config(arch))
    got = init_params(TM.param_specs(tcfg), seed=0, dtype=torch.bfloat16, device="cpu")
    _assert_trees_equal(got, params_from_jax(_jax_init(arch, 0), tcfg))


@pytest.mark.parametrize("arch,seed", [("zamba2-2.7b", 2**31 + 7), ("qwen3-moe-235b-a22b", 5)])
def test_init_params_equals_jax_fp32(arch, seed):
    tcfg = tconfigs.reduce_config(tconfigs.get_config(arch))
    got = init_params(TM.param_specs(tcfg), seed=seed, dtype=torch.float32, device="cpu")
    _assert_trees_equal(got, params_from_jax(_jax_init(arch, seed, jnp.float32), tcfg))


def test_sub_tree_equals_jax_on_the_same_tree():
    """``moe_specs`` alone (no layer stack): JAX's init on the same tree,
    each expert leaf ``[E, d, f]`` at fan-in ``d``; the router fp32."""
    jcfg = JMoE.MoEConfig(d_model=64, num_experts=4, top_k=2, d_ff=32, num_shared_experts=1)
    tcfg = TMoE.MoEConfig(d_model=64, num_experts=4, top_k=2, d_ff=32, num_shared_experts=1)
    want = jax.tree.map(np.asarray, jinit_params(JMoE.moe_specs(jcfg), jax.random.PRNGKey(9)))
    got = init_params(TMoE.moe_specs(tcfg), seed=9, device="cpu")
    _assert_trees_equal(got, jax.tree.map(tensor_from_numpy, want))
    assert got["router"].dtype == torch.float32


def _index_of(sizes: dict, coord: dict):
    def index_of(entry):
        axes = S._entry_axes(entry)
        count = math.prod(sizes[a] for a in axes)
        index = 0
        for a in axes:
            index = index * sizes[a] + coord[a]
        return count, index
    return index_of


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-235b-a22b"])
def test_tp4_rank_draws_its_shard_of_the_whole_draw(arch, monkeypatch):
    """Under a (data 1, model 4) mesh each rank draws only its
    ``local_shard`` of every leaf, bit-equal to that slice of the unsharded
    draw; no whole parameter is drawn."""
    cfg = tconfigs.reduce_config(tconfigs.get_config(arch))
    specs = TM.param_specs(cfg)
    sizes = {"data": 1, "model": 4}
    policy = S.ShardingPolicy(mesh=types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes)))
    whole = dict(_leaves(init_params(specs, seed=0, device="cpu")))
    pspecs = dict(_leaves(policy.param_pspecs(specs)))
    cut = 0
    for rank in range(4):
        index_of = _index_of(sizes, {"data": 0, "model": rank})
        monkeypatch.setattr(S, "rank_index", lambda policy, index_of=index_of: index_of)
        got = dict(_leaves(init_params(specs, seed=0, device="cpu", policy=policy)))
        for path, x in got.items():
            want = S.shard_slice(whole[path], pspecs[path], index_of)
            assert x.shape == want.shape and torch.equal(x, want), (rank, path)
            cut += x.shape != whole[path].shape
    assert cut


# ---------------------------------------------------------------------------
# the CNN example and chip_smoke's literals
# ---------------------------------------------------------------------------


def test_init_cnn_equals_jax():
    from repro_torch.examples import train_cnn_sparsity as tcnn

    spec = importlib.util.spec_from_file_location("jax_cnn", ROOT / "examples" / "train_cnn_sparsity.py")
    jcnn = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcnn)
    want = tcnn.cnn_params_from_jax(jax.tree.map(np.asarray, jcnn.init_cnn(jax.random.PRNGKey(0))), "cpu")
    got = tcnn.init_cnn("cpu")
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)


def test_chip_smoke_literals_equal_jax():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    want8 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8,), jnp.float32)).view(np.uint32)
    assert tuple(int(b) for b in want8) == C.JAX_NORMAL_8
    for arch, items in C.JAX_INIT_ANCHORS.items():
        tree = _jax_init(arch, 0)
        for path, idx, bits in items:
            parts = path.split("/")
            if parts[0] == "layers":  # JAX stacks the layers: the layer is the leading index
                leaf = tree["layers"]
                for k in parts[2:]:
                    leaf = leaf[k]
                value = leaf[(int(parts[1]), *idx)]
            else:
                value = tree[parts[0]][idx]
            assert int(np.asarray(value).view(np.uint16)) == bits, (arch, path)


# ---------------------------------------------------------------------------
# the fill kernel's wrapper
# ---------------------------------------------------------------------------


def test_fill_cpu_path_is_the_plain_version():
    from repro_torch.kernels import normal as N

    key = prng.prng_key(4)
    for dtype in (torch.float32, torch.bfloat16):
        out = torch.empty((1, 3, 5), dtype=dtype)
        N.fill_normal_(out, key, 0.25, full=(4, 9, 5), starts=(2, 4, 0))
        want = (prng.normal(key, (4, 9, 5))[2:3, 4:7] * 0.25).to(dtype)
        assert torch.equal(out, want)
    with pytest.raises(ValueError):
        N.fill_normal_(torch.empty(3, dtype=torch.float16), key)
    with pytest.raises(ValueError):
        N.fill_normal_(torch.empty((4, 4))[:, :2], key)
    with pytest.raises(ValueError):
        N.fill_normal_(torch.empty((1, 3, 5)), key, full=(4, 6, 5), starts=(2, 4, 0))
    with pytest.raises(ValueError, match="on the host"):
        N.fill_normal_(torch.empty(3), key.to("meta"))


class _SpyLibrary:
    """Records each ``td_normal`` call's arguments and writes what the kernel
    would: its index walk re-enacted on the struct's merged dims and
    strides (the last dim fastest, the first dim's stride times what is
    left), then the plain version's draw of each flat index, scaled and
    rounded to the output's dtype."""

    def __init__(self):
        self.calls, self.rc = [], 0

    def td_normal(self, args_ref, stream):
        from repro_torch.kernels import _build

        a = args_ref._obj
        self.calls.append({f: getattr(a, f) if f not in ("shape", "stride") else list(getattr(a, f))
                           for f, _ in _build.NormalArgs._fields_})
        rest = torch.arange(a.n, dtype=torch.int64)
        flat = torch.full((a.n,), a.offset, dtype=torch.int64)
        for d in range(a.ndim - 1, 0, -1):
            flat += (rest % a.shape[d]) * a.stride[d]
            rest = rest // a.shape[d]
        flat += rest * a.stride[0]
        key = torch.tensor([a.k0, a.k1], dtype=torch.int64).to(torch.uint32)
        v = prng.normal_of_bits(prng._bits_at(key, flat)) * torch.tensor(a.scale, dtype=torch.float32)
        v = v.to(torch.bfloat16 if a.out_bf16 else torch.float32)
        ctypes.memmove(a.out, v.data_ptr(), v.numel() * v.element_size())
        return self.rc


def test_fill_card_path_is_one_launch_with_the_kernels_arguments(monkeypatch):
    """A "card" tensor (the CPU standing in) reaches the library once a
    fill, with the block's dims merged where they are contiguous in the
    leaf, its first flat index, the host key's words and the float32 std;
    what the kernel's walk writes equals the plain version, past 2**32
    too; a nonzero return code raises and counts no launch."""
    from repro_torch.kernels import _build, block_mask
    from repro_torch.kernels import normal as N

    lib = _SpyLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(block_mask, "_card_stream", lambda dev: (0, contextlib.nullcontext()))
    monkeypatch.setattr(block_mask, "on_card", lambda t: True)
    monkeypatch.setattr(block_mask, "sm_count", lambda dev: 132)
    N.reset_launch_counts()
    key = prng.fold_in(prng.prng_key(0), 3)
    cases = [((7, 9), 0.1, None, None, 0, ((63,), (1,))),
             ((1, 6, 4), 0.5, (5, 6, 8), (2, 0, 4), 2 * 48 + 4, ((6, 4), (8, 1))),
             ((1, 2, 3, 8), 0.03, (94, 128, 4096, 1536), (7, 5, 100, 0), None,
              ((2, 3, 8), (4096 * 1536, 1536, 1)))]
    for i, (shape, std, full, starts, first, merged) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            out = torch.empty(shape, dtype=dtype)
            N.fill_normal_(out, key, std, full=full, starts=starts)
            want = N.normal_ref(key, shape, std, dtype, full=full, starts=starts)
            assert torch.equal(out, want), (shape, dtype)
            c = lib.calls[-1]
            nd = len(merged[0])
            assert (c["ndim"], tuple(c["shape"][:nd]), tuple(c["stride"][:nd])) == (nd, *merged)
            assert c["out"] == out.data_ptr() and c["n"] == out.numel() and c["out_bf16"] == (dtype == torch.bfloat16)
            assert (c["k0"], c["k1"]) == tuple(key.to(torch.int64).tolist()) and c["scale"] == float(np.float32(std))
            assert c["grid"] == N.normal_grid(out.numel(), 132)
            if first is not None:
                assert c["offset"] == first
    assert lib.calls[-1]["offset"] >> 32 == 1
    assert N.LAUNCHES == {"td_normal_kernel": 6}
    lib.rc = 700
    with pytest.raises(RuntimeError, match="td_normal_kernel"):
        N.fill_normal_(torch.empty(4), key)
    assert N.LAUNCHES == {"td_normal_kernel": 6}


def test_normal_arguments_match_the_cuda_struct():
    """``NormalArgs`` lists the C struct's fields in its order, with its
    array length; the kernel's constants are the plain version's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import normal as N

    src = (ROOT / "src/repro_torch/kernels/csrc/normal.cu").read_text()
    body = src[src.index("struct TdNormalArgs {"):].split("};")[0].split("{", 1)[1]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = decl.split(",")
        names += [first.split()[-1].lstrip("*").split("[")[0]] + [r.strip().lstrip("*") for r in rest]
    assert names == [f for f, _ in _build.NormalArgs._fields_]
    assert f"kMaxDims = {N.MAX_DIMS};" in src and f"kThreads = {N.NORMAL_THREADS};" in src
    consts = [float.fromhex(h) for h in re.findall(r"(-?0x[0-9a-f.]+p[+-]?\d+)f", src)]
    plain = [*prng._LOG_A, *prng._LOG_B, *prng._LOG_C, *prng._LOG1P_P, *prng._LOG1P_Q, *prng._ERFINV_LT5,
             *prng._ERFINV_GE5, prng.NORMAL_LO, prng.SQRT2, prng._SQRT_HALF, prng._LOG1P_SMALL, prng._LOG_E_LO,
             prng._LOG_E_HI]
    assert sorted(consts) == sorted(plain)


def test_merged_dims_and_grid():
    from repro_torch.kernels import normal as N

    assert N.merged_dims((1, 4096, 11008), (4096 * 11008, 11008, 1)) == ((4096 * 11008,), (1,))
    assert N.merged_dims((1, 4096, 2752), (4096 * 11008, 11008, 1)) == ((4096, 2752), (11008, 1))
    assert N.merged_dims((1, 2, 256, 1536), (128 * 4096 * 1536, 4096 * 1536, 1536, 1)) == \
        ((2, 256 * 1536), (4096 * 1536, 1))
    assert N.merged_dims((1, 1), (5, 1)) == ((1,), (1,))
    assert N.normal_grid(100, 132) == 1 and N.normal_grid(10**9, 132) == 132 * N.NORMAL_CTAS_PER_SM


# ---------------------------------------------------------------------------
# end to end: the two serve launchers, each package's own weights
# ---------------------------------------------------------------------------

SERVE_ARGV = ["--arch", "qwen3-4b", "--smoke", "--requests", "4", "--slots", "2", "--prompt-len", "8", "--new",
              "6", "--backend", "reference", "--block", "2", "16", "16"]


def _launch_tokens(module, argv: list, monkeypatch) -> dict:
    engines = []
    base = module.ServeEngine

    class Spy(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(module, "ServeEngine", Spy)
    with redirect_stdout(io.StringIO()):
        module.main(argv)
    (eng,) = engines
    return {rid: [int(t) for t in r.tokens] for rid, r in eng._requests.items()}


def test_serve_launchers_emit_the_same_tokens_from_their_own_weights(monkeypatch):
    """The port's ``launch.serve --smoke`` and JAX's ``repro.launch.serve
    --smoke`` on one greedy command line (``--backend reference``, the CPU):
    each draws its weights from its own ``init_params`` at seed 0 (nothing
    carried across, no initialiser patched) and both emit the same tokens."""
    want = _launch_tokens(jserve, SERVE_ARGV, monkeypatch)
    got = _launch_tokens(tserve, [*SERVE_ARGV, "--device", "cpu"], monkeypatch)
    assert len(got) == 4 and all(got.values()) and got == want
