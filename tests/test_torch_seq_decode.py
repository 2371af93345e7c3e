"""Sequence-split decode (item 14e) on 4 CPU ranks, against the JAX
package's unsharded ``decode_step``.

A batch-1 decode cache whose rows do not divide the data axes is split by
sequence over ``data`` (JAX's ``cache_pspecs``, the dry run's ``long_500k``
cells).  One pool of 4 spawned ranks (``repro_torch.parallel.rehearsal``)
runs the port's ``decode_step`` on meshes ``(data 4, model 1)`` and
``(2, 2)`` under a policy whose ``seq_axis`` is ``"data"``: each rank holds
its rows of the cache (and its kv heads over ``model``), the rank that owns
``pos`` writes the new row, and the attention puts the ranks' rows together
(:func:`repro_torch.models.attention.seq_combine`).

* Reduced deepseek-7b (GQA), zamba2 (the hybrid's shared block),
  deepseek-7b with the int8 KV cache and deepseek-v2 (the MLA latent,
  whole on every model rank; its MoE's decode branch), fp32 parameters
  from the JAX initializer, decode from JAX's caches after a prefill:
  logits within rtol = atol = 1e-5 of JAX's unsharded step.
* ``pos`` at a shard's last row (7 of 4 x 8 rows: three ranks hold no
  valid row), at the next shard's first row (8) and in the last shard (27).
* Only the owner writes: every other rank's rows come back bit-equal, the
  owner's differ in the row at ``pos`` alone.
* The layout equals JAX's ``cache_pspecs`` on the matching ``AbstractMesh``.
* The one-card form (``SeqSplit(parts=n)``, the ranks' parts in turn)
  against the unsplit step.

The module imports no JAX at its top, so the ranks stay light.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import attention as TA
from repro_torch.models import hybrid as TH
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.attention import KVCache
from repro_torch.models.mla import MLACache
from repro_torch.parallel import sharding as S
from repro_torch.parallel.rehearsal import RankPool, mesh
from repro_torch.runtime import Runtime

GEOM = dict(bm=2, bk=16, bn=16)
TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = 32
POSITIONS = (7, 8, 27)
ARCHS = ("deepseek-7b", "zamba2-2.7b", "deepseek-7b:int8", "deepseek-v2-236b")
DEADLINE = 120.0


def port_cfg(arch):
    base, _, kind = arch.partition(":")
    cfg = reduce_config(get_config(base))
    return dataclasses.replace(cfg, kv_cache_quant=True) if kind == "int8" else cfg


def _jax_cfg(arch):
    from repro.configs import get_config as jget_config, reduce_config as jreduce_config

    base, _, kind = arch.partition(":")
    cfg = jreduce_config(jget_config(base))
    return dataclasses.replace(cfg, kv_cache_quant=True) if kind == "int8" else cfg


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}


def _leaf(x):
    return None if x is None else (np.asarray(x, np.float32), str(x.dtype))


def _from_jax_caches(cfg, jc):
    """JAX's stacked decode caches (``(float32 array, dtype name)`` leaves)
    as the port's per-layer ones, in JAX's dtypes."""
    t = lambda x, *i: None if x is None else torch.from_numpy(x[0][i]).to(_DT[x[1]])
    if cfg.family == "hybrid":
        ssm, kv = jc
        groups = kv[0][0].shape[0]
        return TH.HybridCache(
            ssm=[[TS.SSMCache(*(t(f, g, a) for f in ssm)) for a in range(cfg.attn_every)] for g in range(groups)],
            kv=[KVCache(*(t(f, g) for f in kv)) for g in range(groups)])
    kind = MLACache if cfg.use_mla else KVCache
    return {stack: [kind(*(t(f, l) for f in fields)) for l in range(fields[0][0].shape[0])]
            for stack, fields in jc.items()}


def _kv_leaves(cfg, caches):
    """The port's attention caches: one ``KVCache`` (``MLACache``) per layer
    or shared-block invocation."""
    return caches.kv if cfg.family == "hybrid" else [c for stack in sorted(caches) for c in caches[stack]]


# ---------------------------------------------------------------------------
# rank tasks
# ---------------------------------------------------------------------------


def task_decode(arch, shape, params, jcaches, tok, pos):
    """This rank's logits of one decode step on its rows of the cache (the
    sequence over ``data``), its rows before and after, and its offset."""
    cfg = port_cfg(arch)
    policy = S.ShardingPolicy(mesh=mesh(shape, ("data", "model")), seq_axis="data")
    local = S.shard_tree(_to_torch(params), policy.param_pspecs(TM.param_specs(cfg)), policy)
    sh = S.ModelShards(policy, None)
    glob = _from_jax_caches(cfg, jcaches)
    specs = S.rank_cache_pspecs(glob, (), TM.cache_splits(cfg, sh.tp), seq="data")
    caches = S.map_specs(lambda x, sp: S.local_shard(x, sp, policy).clone(), glob, specs)
    before = [[None if x is None else x.clone() for x in c] for c in _kv_leaves(cfg, caches)]
    rt = Runtime(backend="reference", device="cpu", sharding=policy, **GEOM)
    with rt.use(), torch.no_grad():
        logits, caches = TM.decode_step(local, cfg, caches, {"tokens": torch.from_numpy(tok)},
                                        torch.tensor(pos, dtype=torch.int32))
    after = [list(c) for c in _kv_leaves(cfg, caches)]
    rows = before[0][0].shape[1]
    return logits.numpy(), before, after, sh.seq_offset(rows), rows


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(4, tmp_path_factory.mktemp("ranks"), timeout=60.0) as p:
        yield p


@pytest.fixture(scope="module")
def jparams():
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro.models.common import init_params as jinit_params
    from repro_torch.convert import params_from_jax

    out = {}
    for arch in ARCHS:
        jp = jinit_params(JM.param_specs(_jax_cfg(arch)), jax.random.PRNGKey(0), dtype=jnp.float32)
        out[arch] = (jp, _numpy(params_from_jax(jax.tree.map(np.asarray, jp), port_cfg(arch))))
    return out


def _jax_fp32_tails():
    import contextlib
    import functools

    from repro.models import ssm as JS

    @contextlib.contextmanager
    def patch():
        # JAX's scan cannot carry bf16 conv tails under fp32 params
        # (tests/test_torch_serve.py); its decode gets fp32 tails
        init = JS.init_ssm_cache
        JS.init_ssm_cache = functools.partial(init, dtype=np.float32)
        try:
            yield
        finally:
            JS.init_ssm_cache = init

    return patch()


@pytest.fixture(scope="module")
def jax_steps(jparams):
    """Per (arch, pos): JAX's caches after a ``pos``-token prefill grown to
    ROWS rows, the next token and JAX's unsharded decode logits."""
    import jax.numpy as jnp

    from repro import runtime as jrt
    from repro.models import model as JM

    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, size=max(POSITIONS)).astype(np.int32)
    out = {}
    for arch in ARCHS:
        jp, _ = jparams[arch]
        jcfg = _jax_cfg(arch)
        for pos in POSITIONS:
            with _jax_fp32_tails(), jrt.use(jrt.Runtime(backend="reference", **GEOM)):
                logits, caches = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt[None, :pos])})
                full = jrt.resolve(None).grow_caches(jcfg, caches, 1, ROWS)
                tok = jnp.argmax(logits[:, -1], -1)[:, None]
                if jcfg.family == "hybrid":
                    leaves = (tuple(_leaf(x) for x in full.ssm), tuple(_leaf(x) for x in full.kv))
                else:
                    leaves = {stack: tuple(_leaf(x) for x in c) for stack, c in full.items()}
                want, _ = JM.decode_step(jp, jcfg, full, {"tokens": tok}, pos)
            out[arch, pos] = (leaves, np.asarray(tok, np.int64), np.asarray(want))
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_split_decode_matches_jax_unsharded(pool, jparams, jax_steps, arch, pos, shape):
    _, tp = jparams[arch]
    jcaches, tok, want = jax_steps[arch, pos]
    cfg = port_cfg(arch)
    outs = pool.run(task_decode, arch, shape, tp, jcaches, tok, pos, deadline=DEADLINE)
    owners = 0
    for logits, before, after, offset, rows in outs:
        np.testing.assert_allclose(logits, want, **TOL)
        assert rows == ROWS // shape[0]
        owner = offset <= pos < offset + rows
        owners += owner
        for b_layer, a_layer in zip(before, after):
            for b, a in zip(b_layer, a_layer):
                if b is None:
                    continue
                changed = (b != a).reshape(b.shape[0], rows, -1).any(-1).any(0)
                if owner:  # the new row alone (int8 scales may round to the old value)
                    assert not changed[torch.arange(rows) != pos - offset].any()
                else:
                    assert not changed.any()
        # the owner's K row really is the new token's (not left as the zero it held)
        if owner and not cfg.kv_cache_quant:
            assert after[0][0][:, pos - offset].abs().sum() > 0
    assert owners == shape[1]  # one data rank owns pos, on each model rank


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-2.7b", "deepseek-7b:int8"])
def test_split_layout_equals_jax_cache_pspecs(arch, shape):
    """``rank_cache_pspecs`` with ``seq`` against JAX's size rule on the
    matching ``AbstractMesh``, the stacked layer dims dropped: the sequence
    over ``data``, the kv heads over ``model``; JAX's rule also cuts the
    Mamba2 ``conv_b``/``conv_c`` tails, which the port holds whole (the
    documented difference, ROADMAP queue 3)."""
    from jax.sharding import AbstractMesh, PartitionSpec

    from repro.configs.base import InputShape as JShape
    from repro.models import model as JM
    from repro.parallel.sharding import cache_pspecs

    cfg, jcfg = port_cfg(arch), _jax_cfg(arch)
    cell = JShape("long", ROWS, 1, "decode")
    jspecs = cache_pspecs(jcfg, cell, AbstractMesh(shape, ("data", "model")), JM.abstract_cache(jcfg, 1, ROWS))
    duck = type("Mesh", (), {"axis_names": ("data", "model"), "shape": dict(zip(("data", "model"), shape))})()
    assert S.seq_axis(S.BatchShape(1, ROWS, "decode"), duck) == "data"
    glob = TM.abstract_cache(cfg, 1, ROWS)
    ours = S.rank_cache_pspecs(glob, (), TM.cache_splits(cfg, shape[1]), seq="data")
    sizes = dict(zip(("data", "model"), shape))

    def norm(spec, n):  # the last n entries, an axis of one rank as no axis
        spec = (tuple(spec) + (None,) * n)[:max(len(tuple(spec)), n)]
        return tuple(None if e is None or sizes.get(e, 1) == 1 else e for e in spec[-n:])
    if cfg.family == "hybrid":
        pairs = [(o, j) for o, j in zip(ours.kv[0], jspecs.kv)]
        pairs += [(o, j) for f, (o, j) in enumerate(zip(ours.ssm[0][0], jspecs.ssm)) if f not in (1, 2)]
        for f in (1, 2):  # conv_b / conv_c: JAX cuts G*N over model, the port holds them whole
            assert ours.ssm[0][0][f] == (None, None, None)
    else:
        pairs = list(zip(ours["layers"][0], jspecs["layers"]))
    for o, j in pairs:
        if o is None:
            assert j is None
            continue
        assert isinstance(j, PartitionSpec)
        assert norm(o, len(o)) == norm(j, len(o))


def test_one_card_parts_match_the_unsplit_step():
    """``SeqSplit(parts=4)`` (four ranks' parts in turn on one device, as on
    the card) against the unsplit step, GQA, MLA and the hybrid, fp32."""
    from repro_torch.models.common import init_params

    for arch in ("deepseek-7b", "deepseek-v2-236b", "zamba2-2.7b", "gemma2-2b"):
        cfg = reduce_config(get_config(arch))
        params = init_params(TM.param_specs(cfg), seed=0, dtype=torch.float32, device="cpu")
        gen = torch.Generator().manual_seed(0)
        with Runtime(backend="reference", device="cpu", **GEOM).use(), torch.no_grad():
            _, pre = TM.prefill(params, cfg, {"tokens": torch.randint(0, 256, (2, 20), generator=gen)})
            caches = TM.init_cache(cfg, 2, ROWS)
            _copy_rows(caches, pre)
            tok = {"tokens": torch.randint(0, 256, (2, 1), generator=gen)}
            for pos in (20, 23, 24, 31):
                a, b = copy.deepcopy(caches), copy.deepcopy(caches)
                want, _ = TM.decode_step(params, cfg, a, tok, torch.tensor(pos))
                got, _ = TM.decode_step(params, cfg, b, tok, torch.tensor(pos), seq=TA.SeqSplit(parts=4))
                np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _copy_rows(dst, src):
    """Prefill caches into the first rows of zero decode caches."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_rows(dst[k], src[k])
    elif isinstance(dst, list):
        for a, b in zip(dst, src):
            _copy_rows(a, b)
    elif isinstance(dst, (KVCache, TH.HybridCache)) or type(dst).__name__ == "MLACache":
        if isinstance(dst, TH.HybridCache):
            _copy_rows(dst.ssm, src.ssm)
            _copy_rows(dst.kv, src.kv)
            return
        for a, b in zip(dst, src):
            if a is not None:
                a[:, :b.shape[1]] = b.to(a.dtype)
    else:  # an SSMCache: whole
        for a, b in zip(dst, src):
            a.copy_(b.to(a.dtype))


def test_owner_write_only_inside_its_rows():
    """The blend writes the row at ``pos`` into the rank whose rows hold it,
    for a scalar and a per-row ``pos``, and leaves every other rank's rows
    as they were; it reads no host value (it runs on meta tensors)."""
    full = torch.arange(2 * 12 * 3, dtype=torch.float32).reshape(2, 12, 3)
    new = -torch.ones(2, 3)
    for pos in (torch.tensor(5), torch.tensor([5, 9])):
        parts = [full[:, i * 4:(i + 1) * 4].clone() for i in range(3)]
        for i, p in enumerate(parts):
            TA.owner_write(p, new, pos, 4 * i)
        got = torch.cat(parts, dim=1)
        want = full.clone()
        if pos.ndim:
            want[torch.arange(2), pos] = new
        else:
            want[:, 5] = new
        assert torch.equal(got, want)
    meta = torch.empty(2, 4, 3, device="meta")
    TA.owner_write(meta, new.to("meta"), torch.tensor(5, device="meta"), 4)
