"""The frontend configs in repro_torch against repro on the CPU: qwen2-vl-72b
(M-RoPE over precomputed image-and-text embeddings) and musicgen-large
(precomputed audio frame embeddings, one LM head per codebook).

The models are the reduced configs (``reduce_config``: 2 layers, d_model 64,
4 query heads of 16 over 2 KV heads, M-RoPE sections (4, 2, 2), 2
codebooks), with fp32 parameters from the JAX initializer carried across by
``params_from_jax``: qwen2-vl with SiLU (as registered) and with ReLU (the
fused emitted-mask FFN under ``reference``), musicgen with its non-gated
GELU FFN.  Embeddings come from numpy with a seed.  Each qwen2-vl sequence
holds a 4 x 4 image between two text runs, its positions Qwen2-VL's rope
index (text ``i`` -> (i, i, i); patch (r, c) -> (p, p + r, p + c) after a
``p``-token prefix; the trailing text from ``p + 4``), with another prefix
on each row: the t/h/w streams differ.  With equal streams M-RoPE equals
RoPE at theta 1e6 exactly, so such a test could not see a wrong section
split (:func:`test_equal_streams_equal_a_rope_model` documents it).

JAX's layer scans carry the hidden state, which must keep one dtype; a
frontend's embeddings enter as bf16 (JAX casts them, whatever the model's
dtype) and leave an fp32 block as fp32, so under fp32 parameters JAX's
scan refuses them.  Its configs here therefore set ``unroll`` (JAX's own
Python loop over the layers; the port ignores the flag), and JAX's decode,
which scans even then, is run as its ``decode_step`` runs it with the scan
written out as a loop over JAX's ``_block_decode``
(:func:`_jax_decode_fp32`).  bf16 parameters go through JAX's
``decode_step`` itself.

Tolerances: ``mrope_tables`` rtol = atol = 1e-6; the models in fp32 rtol =
atol = 1e-5 (the plain products and the softmax sum in another order than
XLA's), a decode step from the same bf16 caches in both packages; bf16
decode atol 0.1 (``tests/test_torch_model.py``'s bf16 bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import runtime as jrt
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.common import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import runtime as trt
from repro_torch.convert import params_from_jax
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as tstep
from test_torch_model import TOL as MODEL_TOL

GEOM = dict(bm=8, bk=16, bn=16)
TOL = dict(rtol=1e-5, atol=1e-5)
MROPE_TOL = dict(rtol=1e-6, atol=1e-6)
VL, MG = "qwen2-vl-72b", "musicgen-large"
#: model name -> (arch, activation)
MODELS = {"qwen2-vl-silu": (VL, "silu"), "qwen2-vl-relu": (VL, "relu"), "musicgen-gelu": (MG, "gelu")}
B, S = 3, 24
GRID = (4, 4)  # the image: t = 1, 4 x 4 patches
PREFIX = (4, 2, 6)  # text tokens ahead of the image, row by row
OPT = dict(lr=1e-3, warmup_steps=1)
#: AdamW's first step moves a parameter by ``lr * g / (|g| + eps)``: where
#: ``|g|`` is within a few ``eps`` of zero, a gradient difference in the
#: products' summation order moves it by up to ``lr``.  Parameters are held
#: to TOL where ``|g|`` reaches this, and within ``2 * lr`` elsewhere, as
#: ``tests/test_torch_train.py`` holds the MoE step's
WELL_CONDITIONED = 100 * tadamw.OptConfig().eps


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(name, **kw):
    arch, act = MODELS[name]
    kw = {"activation": act, "unroll": True, **kw}
    jcfg = dataclasses.replace(jconfigs.reduce_config(jconfigs.get_config(arch)), **kw)
    tcfg = dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(arch)), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _model(name, dtype=jnp.float32, seed=0, **kw):
    jcfg, tcfg = _cfgs(name, **kw)
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed), dtype=dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def image_positions(b, s, grid=GRID, prefix=PREFIX):
    """Qwen2-VL's rope index ``[b, 3, s]`` of ``p`` text tokens, an image
    of ``1 x grid`` patches and the text after it, ``p`` cycling through
    ``prefix`` row by row."""
    gh, gw = grid
    out = np.zeros((b, 3, s), np.int32)
    for r in range(b):
        p = prefix[r % len(prefix)]
        rows = [(i, i, i) for i in range(p)]
        rows += [(p, p + y, p + x) for y in range(gh) for x in range(gw)]
        start = p + max(gh, gw)
        rows += [(start + i,) * 3 for i in range(s - len(rows))]
        out[r] = np.asarray(rows).T
    return out


def _batch(cfg, rng, b=B, s=S, labels=False, positions=None):
    """numpy inputs: ``inputs_embeds``, M-RoPE ``positions`` (an image grid
    unless given), ``labels`` (``[b, s, K]`` under the audio frontend)."""
    out = {"inputs_embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    if cfg.mrope_sections is not None:
        out["positions"] = image_positions(b, s) if positions is None else positions
    if labels:
        shape = (b, s, cfg.num_codebooks) if cfg.frontend == "audio" else (b, s)
        out["labels"] = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


def _port_leaves(jtree, tcfg):
    """A JAX parameter-shaped tree (gradients, moments) in the port's
    layout, in its ``tree_leaves`` order."""
    return tadamw.tree_leaves(params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32), jtree), tcfg))


def _jax_decode_fp32(jp, jcfg, caches, batch, pos):
    """JAX's ``decode_step`` with its layer scan written out as a loop over
    JAX's ``_block_decode`` (the scan's carry cannot change dtype, and under
    fp32 parameters a frontend's bf16 embeddings leave the first block as
    fp32); the head as ``decode_step`` computes it."""
    h = JT._embed_in(jp, jcfg, batch)
    flags = JT._static_flags(jcfg, jcfg.num_layers)
    new = []
    for i, g in enumerate(flags):
        p = jax.tree.map(lambda x: x[i], jp["layers"])
        c = jax.tree.map(lambda x: x[i], caches["layers"])
        h, c = JT._block_decode(p, jcfg, h, c, pos, g, None)
        new.append(c)
    h = JC.rms_norm(h, jp["final_norm"], zero_centered=jcfg.post_norms)
    if jcfg.frontend == "audio":
        logits = jnp.einsum("bsd,kdv->bskv", h, jp["lm_head"])
    else:
        logits = JT.head_matmul(jcfg, h, jp["lm_head"])
    return JC.softcap(logits, jcfg.final_softcap), {"layers": jax.tree.map(lambda *xs: jnp.stack(xs), *new)}


# ---------------------------------------------------------------------------
# M-RoPE tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim,sections,theta", [(16, (4, 2, 2), 1e6), (128, (16, 24, 24), 1e6),
                                                (64, (8, 12, 12), 1e4)])
def test_mrope_tables_match_jax(dim, sections, theta):
    pos = image_positions(B, S) + np.arange(B, dtype=np.int32)[:, None, None] * 97  # large angles too
    jcos, jsin = JC.mrope_tables(jnp.asarray(pos), dim, sections, theta)
    tcos, tsin = TC.mrope_tables(torch.from_numpy(pos), dim, sections, theta)
    assert tuple(tcos.shape) == tuple(jcos.shape) == (B, S, 1, dim // 2)
    _close(jcos, tcos, MROPE_TOL)
    _close(jsin, tsin, MROPE_TOL)
    # the split is visible: one slot moved from the t stream to h gives
    # other tables on the image's patches
    moved = (sections[0] - 1, sections[1] + 1, sections[2])
    other, _ = TC.mrope_tables(torch.from_numpy(pos), dim, moved, theta)
    assert not torch.allclose(other, tcos, atol=1e-3)


def test_mrope_tables_refuse_bad_inputs():
    with pytest.raises(ValueError, match=r"\[B, 3, S\]"):
        TC.mrope_tables(torch.arange(S), 16, (4, 2, 2))
    with pytest.raises(ValueError, match="sum"):
        TC.mrope_tables(torch.from_numpy(image_positions(B, S)), 16, (4, 2, 3))


def test_equal_streams_equal_a_rope_model():
    """With t = h = w M-RoPE is RoPE at its theta, exactly, in both
    packages: a test whose streams are equal cannot see the section split.
    With the image grid the logits differ from the RoPE model's."""
    _, tcfg, _, tp = _model("qwen2-vl-silu")
    rope = dataclasses.replace(tcfg, mrope_sections=None)
    assert rope.rope_theta == 1e6
    equal = np.broadcast_to(np.arange(S, dtype=np.int32), (B, 3, S)).copy()
    rng = np.random.default_rng(3)
    batch = _batch(tcfg, rng, positions=equal)
    with trt.Runtime(backend="dense", device="cpu").use(), torch.no_grad():
        got = TM.forward(tp, tcfg, _t(batch))
        want = TM.forward(tp, rope, _t(batch))
        grid = TM.forward(tp, tcfg, _t(dict(batch, positions=image_positions(B, S))))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.allclose(grid, want, atol=1e-3)
    pos = jnp.asarray(equal)
    jcos, jsin = JC.mrope_tables(pos, 16, (4, 2, 2), 1e6)
    rcos, rsin = JC.rotary_embedding(pos[:, 0], 16, 1e6)
    np.testing.assert_array_equal(np.asarray(jcos[:, :, 0]), np.asarray(rcos))
    np.testing.assert_array_equal(np.asarray(jsin[:, :, 0]), np.asarray(rsin))


# ---------------------------------------------------------------------------
# the models against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "reference"])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_loss_and_gradients_match_jax(name, backend):
    jcfg, tcfg, jp, tp = _model(name)
    batch = _batch(tcfg, np.random.default_rng(1), labels=True)
    with jrt.use(jrt.Runtime(backend=backend, **GEOM)):
        jl = JM.forward(jp, jcfg, _j(batch))
        jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(p, jcfg, _j(batch)))(jp)
    leaves = tadamw.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    with trt.Runtime(backend=backend, device="cpu", **GEOM).use():
        tl = TM.forward(tp, tcfg, _t(batch))
        loss = TM.loss_fn(tp, tcfg, _t(batch))
        grads = torch.autograd.grad(loss, leaves)
    want = (B, S, tcfg.num_codebooks, tcfg.vocab_size) if tcfg.frontend == "audio" else (B, S, tcfg.vocab_size)
    assert tuple(tl.shape) == tuple(jl.shape) == want
    _close(jl, tl)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    jleaves = _port_leaves(jgrads, tcfg)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        _close(jg, g)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax(name, microbatches):
    """One ``make_train_step`` step on ``reference``: loss, gradient norm,
    first moments and the updated parameters (see ``WELL_CONDITIONED``);
    two microbatches split every leaf of the batch, positions included."""
    jcfg, tcfg, jp, tp = _model(name)
    batch = _batch(tcfg, np.random.default_rng(2), b=4, labels=True)
    with jrt.use(jrt.Runtime(backend="reference", **GEOM)):
        jfn = jax.jit(jstep.make_train_step(jcfg, jadamw.OptConfig(**OPT), microbatches=microbatches))
        jp2, jo2, jm = jfn(jp, jadamw.init_opt_state(jp), _j(batch))
        jgrads = jax.grad(lambda p: JM.loss_fn(p, jcfg, _j(batch)))(jp)
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use():
        fn = tstep.make_train_step(tcfg, tadamw.OptConfig(**OPT), microbatches=microbatches)
        tp2, to2, tm = fn(tp, tstep.init_train_state(tcfg, tp), _t(batch))
    assert tp2 is tp and to2.step == 1
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    for t, j in zip(tadamw.tree_leaves(to2.m), _port_leaves(jo2.m, tcfg)):
        _close(j, t)
    conditioned = total = 0
    for t, j, jg in zip(tadamw.tree_leaves(tp2), _port_leaves(jp2, tcfg), _port_leaves(jgrads, tcfg)):
        t, j, jg = t.detach().numpy(), j.numpy(), jg.numpy()
        well = np.abs(jg) >= WELL_CONDITIONED
        np.testing.assert_allclose(t[well], j[well], **TOL)
        np.testing.assert_array_less(np.abs(t - j), 2 * OPT["lr"])
        conditioned, total = conditioned + int(well.sum()), total + t.size
    assert conditioned > 0.98 * total


def _as_jax_caches(tc):
    """The port's per-layer bf16 KV caches as JAX's stacked ones."""
    stack = lambda f: jnp.stack([jnp.asarray(getattr(c, f).float().numpy()).astype(jnp.bfloat16)
                                 for c in tc["layers"]])
    return {"layers": JA.KVCache(k=stack("k"), v=stack("v"))}


@pytest.mark.parametrize("backend", ["dense", "reference"])
@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_caches_and_decode_match_jax(name, backend):
    """``prefill`` (last logits and every layer's KV cache, fp32), then
    three decode steps of one-position embeddings at a per-row position
    (text mode under M-RoPE), each step from the same bf16 caches in both
    packages: the fp32 prefill caches agree within 1e-5, and where a value
    lies at a near-tie between two bf16 values the two packages' roundings
    can part (as ``tests/test_torch_kv_quant.py`` finds), which a decode
    from each package's own caches would carry into its logits.  The rows
    each step writes agree within one bf16 step."""
    jcfg, tcfg, jp, tp = _model(name)
    rng = np.random.default_rng(4)
    batch = _batch(tcfg, rng)
    max_len, steps = 32, 3
    jr = jrt.Runtime(backend=backend, **GEOM)
    tr = trt.Runtime(backend=backend, device="cpu", **GEOM)
    with jrt.use(jr):
        jpl, jc = JM.prefill(jp, jcfg, _j(batch))
    with tr.use():
        tpl, tc = TM.prefill(tp, tcfg, _t(batch))
    assert tuple(tpl.shape) == tuple(jpl.shape)
    assert tpl.shape[:2] == (B, 1) and tpl.shape[-1] == tcfg.vocab_size
    _close(jpl, tpl)
    for layer, cache in enumerate(tc["layers"]):
        _close(jc["layers"].k[layer], cache.k)
        _close(jc["layers"].v[layer], cache.v)
    with jrt.use(jr):
        jc = jr.grow_caches(jcfg, jc, B, max_len)
        jstep_fn = jax.jit(lambda p, c, x, q: _jax_decode_fp32(p, jcfg, c, {"inputs_embeds": x}, q))
    with tr.use():
        tc = tr.grow_caches(tcfg, tc, B, max_len)
    pos = np.array([S, S + 1, S + 3], np.int32)  # each row at its own position
    for _ in range(steps):
        x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        with jrt.use(jr):
            jl, jc = jstep_fn(jp, _as_jax_caches(tc), jnp.asarray(x), jnp.asarray(pos))
        with tr.use():
            tl, tc = TM.decode_step(tp, tcfg, tc, {"inputs_embeds": torch.from_numpy(x)},
                                    torch.from_numpy(pos).long())
        assert tuple(tl.shape) == tuple(jl.shape)
        _close(jl, tl)
        for layer, cache in enumerate(tc["layers"]):
            _close(jc["layers"].k[layer].astype(jnp.float32), cache.k, dict(rtol=2**-8, atol=1e-5))
            _close(jc["layers"].v[layer].astype(jnp.float32), cache.v, dict(rtol=2**-8, atol=1e-5))
        pos = pos + 1


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_decode_matches_jax_decode_step(name):
    """bf16 parameters through JAX's own ``prefill`` and jitted
    ``decode_step`` (scanned: every leaf bf16), three steps at a scalar
    position, within the bf16 bound."""
    jcfg, tcfg, jp, tp = _model(name, dtype=jnp.bfloat16, unroll=False)
    rng = np.random.default_rng(5)
    batch = _batch(tcfg, rng)
    jr = jrt.Runtime(backend="reference", **GEOM)
    tr = trt.Runtime(backend="reference", device="cpu", **GEOM)
    with jrt.use(jr):
        _, jc = JM.prefill(jp, jcfg, _j(batch))
        jc = jr.grow_caches(jcfg, jc, B, 32)
        jfn = jax.jit(lambda p, c, x, q: JM.decode_step(p, jcfg, c, {"inputs_embeds": x}, q))
    with tr.use():
        _, tc = TM.prefill(tp, tcfg, _t(batch))
        tc = tr.grow_caches(tcfg, tc, B, 32)
    for step in range(3):
        x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        with jrt.use(jr):
            jl, jc = jfn(jp, jc, jnp.asarray(x), jnp.int32(S + step))
        with tr.use():
            tl, tc = TM.decode_step(tp, tcfg, tc, {"inputs_embeds": torch.from_numpy(x)}, S + step)
        assert tl.dtype == torch.bfloat16
        _close(jl, tl, MODEL_TOL["bfloat16"])


@pytest.mark.parametrize("name", ["qwen2-vl-silu", "qwen2-vl-relu", "musicgen-gelu"])
def test_decode_equals_a_teacher_forced_forward(name):
    """The prefill and three decode steps give the logits of one forward
    over the prompt and the steps' embeddings, the steps in text mode at
    their sequence index (how JAX decodes after an M-RoPE prefill), within
    relative L2 2^-8 per row and position: the decode reads K/V rounded once
    to bf16 (2^-9 relative each).  Under M-RoPE the forward with the steps
    at Qwen2-VL's own next index (max + 1) differs by far more: the check
    sees the decode's position."""
    _, tcfg, _, tp = _model(name)
    rng = np.random.default_rng(8)
    batch = _t(_batch(tcfg, rng))
    steps = torch.from_numpy(rng.standard_normal((3, B, 1, tcfg.d_model)).astype(np.float32))
    rt = trt.Runtime(backend="reference", device="cpu", **GEOM)
    with torch.no_grad(), rt.use():
        first, caches = TM.prefill(tp, tcfg, batch)
        caches = rt.grow_caches(tcfg, caches, B, S + len(steps))
        got = [first[:, -1]]
        for t, x in enumerate(steps):
            out, caches = TM.decode_step(tp, tcfg, caches, {"inputs_embeds": x}, S + t)
            got.append(out[:, -1])
        got = torch.stack(got, 1)  # [B, 4, ...]
        full = {"inputs_embeds": torch.cat([batch["inputs_embeds"], steps[:, :, 0].transpose(0, 1)], 1)}

        def forward(start):
            if "positions" in batch:
                text = torch.arange(start, start + len(steps)).expand(B, 3, len(steps)).to(torch.int32)
                full["positions"] = torch.cat([batch["positions"], text], 2)
            return TM.forward(tp, tcfg, full)[:, S - 1:]

        want = forward(S)
        rel = (torch.linalg.vector_norm((got - want).flatten(2), dim=-1)
               / torch.linalg.vector_norm(want.flatten(2), dim=-1))
        assert float(rel.max()) < 2**-8
        if "positions" in batch:
            nxt = int(batch["positions"][:, :, -1].max()) + 1
            assert nxt < S  # the image's positions run behind the sequence index
            moved = torch.linalg.vector_norm((forward(nxt) - want)[:, 1:].flatten(2), dim=-1)
            assert float((moved / torch.linalg.vector_norm(want[:, 1:].flatten(2), dim=-1)).min()) > 16 * 2**-8


# ---------------------------------------------------------------------------
# what the port refuses, and the parameter tree
# ---------------------------------------------------------------------------


def test_mrope_without_positions_raises_as_jax_does():
    jcfg, tcfg, jp, tp = _model("qwen2-vl-silu")
    batch = _batch(tcfg, np.random.default_rng(6))
    del batch["positions"]
    with pytest.raises(ValueError):
        JM.prefill(jp, jcfg, _j(batch))
    with pytest.raises(ValueError, match="positions"):
        TM.prefill(tp, tcfg, _t(batch))
    with pytest.raises(ValueError, match="positions"):
        TM.forward(tp, tcfg, _t(batch))


@pytest.mark.parametrize("arch", [VL, MG])
def test_serve_engine_refuses_frontends(arch):
    tcfg = tconfigs.reduce_config(tconfigs.get_config(arch))
    _, _, _, tp = _model("qwen2-vl-silu" if arch == VL else "musicgen-gelu")
    with pytest.raises(NotImplementedError, match="tokens only"):
        ServeEngine(tp, tcfg, slots=2, max_len=32, rt=trt.Runtime(backend="reference", device="cpu", **GEOM))


@pytest.mark.parametrize("arch", [VL, MG])
def test_sparsity_taps_are_refused_as_jax_refuses_them(arch):
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    tcfg = tconfigs.reduce_config(tconfigs.get_config(arch))
    with jrt.use(jrt.Runtime(backend="reference", **GEOM)), pytest.raises(ValueError, match="frontend"):
        jstep.make_train_step(jcfg, jadamw.OptConfig(), sparsity_taps=True)
    with trt.Runtime(backend="reference", device="cpu", **GEOM).use(), pytest.raises(ValueError, match="frontend"):
        tstep.make_train_step(tcfg, tadamw.OptConfig(), sparsity_taps=True)


def test_train_launcher_refuses_frontends():
    from repro_torch.launch import train as launch_train

    with pytest.raises(NotImplementedError, match="inputs_embeds"):
        launch_train.main(["--arch", VL, "--smoke", "--device", "cpu", "--backend", "reference", "--steps", "1"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_and_hybrid_refuse_a_frontend(arch):
    cfg = dataclasses.replace(tconfigs.reduce_config(tconfigs.get_config(arch)), frontend="audio")
    with pytest.raises(NotImplementedError, match="frontend"):
        TM.param_specs(cfg)
    with pytest.raises(NotImplementedError, match="frontend"):
        TM.forward({}, cfg, {"inputs_embeds": torch.zeros(1, 4, cfg.d_model)})


@pytest.mark.parametrize("name", ["qwen2-vl-silu", "musicgen-gelu"])
def test_params_from_jax_takes_a_tree_without_embed(name):
    jcfg, tcfg, jp, tp = _model(name, seed=7)
    assert "embed" not in jp and "embed" not in tp
    assert set(tp) == set(TM.param_specs(tcfg)) == set(JM.param_specs(jcfg)) == {"layers", "final_norm", "lm_head"}
    head = (tcfg.num_codebooks, tcfg.d_model, tcfg.vocab_size) if tcfg.frontend == "audio" else \
        (tcfg.d_model, tcfg.vocab_size)
    assert tuple(tp["lm_head"].shape) == head == tuple(TM.param_specs(tcfg)["lm_head"].shape)
    np.testing.assert_array_equal(tp["lm_head"].numpy(), np.asarray(jp["lm_head"]))
    assert len(tp["layers"]) == tcfg.num_layers
