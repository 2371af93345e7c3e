"""The port's config registry against the JAX package's, and the qwen3-4b
model (grouped-query attention with qk-norm, the train launcher's default
``--arch``) and the qwen3-moe-235b-a22b model (the MoE family) against
JAX's on the CPU.

Every config the port registers equals JAX's field for field, reduced or
not, with the same ``param_count`` and ``active_param_count``; so do MLA
configs (deepseek-v2-236b, and qwen3-moe with MLA attention) and the SSM
and hybrid configs (mamba2-780m, zamba2-2.7b: JAX's count, which takes
``3·d·d_inner + 2·d·N + d_inner·d`` a Mamba2 layer, is mirrored as it is).
Reduced mamba2-780m and zamba2-2.7b give JAX's logits too, and so do reduced
starcoder2-3b (a non-gated tanh-GELU FFN, GQA over 2 KV heads) and reduced
gemma2-2b (sliding-window attention on alternate layers, sandwich norms,
logit softcaps; 16 tokens run past its window of 8), reduced qwen2-vl-72b
(M-RoPE over a 2 x 3 image's positions, embeddings in place of tokens) and
reduced musicgen-large (two codebook heads), whose ``param_count``, as
JAX's, takes an embedding table the tree does not hold.  Reduced
qwen3-4b (2 layers, d_model 64, 4 query heads over 2 KV heads, qk-norm) and
reduced qwen3-moe (the same attention, 8 experts top-2) give the same
``forward`` and ``prefill`` logits as JAX's within
``tests/test_torch_model.py``'s tolerances (fp32 rtol = atol = 1e-4; bf16
atol 0.1), parameters carried across by ``params_from_jax``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import runtime as jrt
from repro.models import model as JM
from repro.models.common import init_params as jinit_params
from repro_torch import configs as tconfigs
from repro_torch import runtime as trt
from repro_torch.convert import params_from_jax
from repro_torch.models import model as TM
from test_torch_model import TOL

GEOM = dict(bm=8, bk=16, bn=16)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


PORTED = ["deepseek-7b", "deepseek-v2-236b", "gemma2-2b", "mamba2-780m", "musicgen-large", "qwen2-vl-72b",
          "qwen3-4b", "qwen3-moe-235b-a22b", "starcoder2-3b", "zamba2-2.7b"]


def test_the_port_registers_deepseek_and_qwen3():
    """Every config of the JAX package, the two frontend configs included."""
    assert tconfigs.ALL_ARCHS == PORTED == sorted(jconfigs.ALL_ARCHS)


@pytest.mark.parametrize("arch", PORTED)
def test_registered_config_equals_jax_field_for_field(arch):
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tconfigs.reduce_config(t)) == dataclasses.asdict(jconfigs.reduce_config(j))
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("kw", [dict(), dict(first_dense_layers=1, num_shared_experts=1, d_ff=128),
                                dict(num_layers=8)], ids=["registered", "dense1-shared", "8-layers"])
def test_moe_param_counts_equal_jax(kw):
    t = dataclasses.replace(tconfigs.get_config("qwen3-moe-235b-a22b"), **kw)
    j = dataclasses.replace(jconfigs.get_config("qwen3-moe-235b-a22b"), **kw)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count() < t.param_count()


@pytest.mark.parametrize("arch,kw", [("qwen3-moe-235b-a22b", dict(use_mla=True)),
                                     ("deepseek-v2-236b", dict()),
                                     ("deepseek-v2-236b", dict(num_layers=6))],
                         ids=["qwen3-moe-mla", "deepseek-v2", "deepseek-v2-6-layers"])
def test_mla_param_counts_equal_jax(arch, kw):
    """MLA's attention term (query and KV latents, their up-projections and
    the output), counted as JAX counts it, in place of GQA's."""
    t = dataclasses.replace(tconfigs.get_config(arch), **kw)
    j = dataclasses.replace(jconfigs.get_config(arch), **kw)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count() < t.param_count()
    gqa = dataclasses.replace(t, use_mla=False)
    assert t.param_count() != gqa.param_count()


def _reduced_logits_match_jax(arch, backend, dtype_name, seq=12):
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    tcfg = tconfigs.reduce_config(tconfigs.get_config(arch))
    if tcfg.family in ("dense", "moe"):
        assert tcfg.num_kv_heads < tcfg.num_heads
    if tcfg.frontend is not None:
        # JAX's layer scan cannot carry the bf16 embeddings into fp32 blocks:
        # its unrolled loop runs them (tests/test_torch_frontends.py)
        jcfg, tcfg = (dataclasses.replace(c, unroll=True) for c in (jcfg, tcfg))
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(2), dtype=getattr(jnp, dtype_name))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(3)
    if tcfg.frontend is None:
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, size=(2, seq)).astype(np.int32)}
    else:
        batch = {"inputs_embeds": rng.standard_normal((2, seq, tcfg.d_model)).astype(np.float32)}
    if tcfg.mrope_sections is not None:  # a 2 x 3 image after 3 text tokens
        streams = [(i, i, i) for i in range(3)] + [(3, 3 + r, 3 + c) for r in range(2) for c in range(3)]
        streams += [(6 + i,) * 3 for i in range(seq - len(streams))]
        batch["positions"] = np.broadcast_to(np.asarray(streams, np.int32).T, (2, 3, seq)).copy()
    with jrt.use(jrt.Runtime(backend=backend, **GEOM)):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jl = JM.forward(jp, jcfg, jb)
        jpl, _ = JM.prefill(jp, jcfg, jb)
    with trt.Runtime(backend=backend, device="cpu", **GEOM).use():
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        tl = TM.forward(tp, tcfg, tb)
        tpl, _ = TM.prefill(tp, tcfg, tb)
    for t, j in ((tl, jl), (tpl, jpl)):
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_qwen3_reduced_logits_match_jax(backend, dtype_name):
    assert tconfigs.reduce_config(tconfigs.get_config("qwen3-4b")).qk_norm
    _reduced_logits_match_jax("qwen3-4b", backend, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_qwen3_moe_reduced_logits_match_jax(backend, dtype_name):
    assert tconfigs.reduce_config(tconfigs.get_config("qwen3-moe-235b-a22b")).qk_norm
    _reduced_logits_match_jax("qwen3-moe-235b-a22b", backend, dtype_name)


@pytest.mark.parametrize("kw", [dict(), dict(num_layers=12), dict(ssm_state=16, ssm_expand=4)],
                         ids=["registered", "12-layers", "state16-expand4"])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_ssm_and_hybrid_param_counts_equal_jax(arch, kw):
    t = dataclasses.replace(tconfigs.get_config(arch), **kw)
    j = dataclasses.replace(jconfigs.get_config(arch), **kw)
    assert t.param_count() == j.param_count() == t.active_param_count()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_mamba2_reduced_logits_match_jax(backend, dtype_name):
    _reduced_logits_match_jax("mamba2-780m", backend, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_zamba2_reduced_logits_match_jax(backend, dtype_name):
    _reduced_logits_match_jax("zamba2-2.7b", backend, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_starcoder2_reduced_logits_match_jax(backend, dtype_name):
    cfg = tconfigs.get_config("starcoder2-3b")
    assert not cfg.mlp_gated and cfg.activation == "gelu" and cfg.num_kv_heads == 2
    assert "w_gate" not in TM.param_specs(tconfigs.reduce_config(cfg))["layers"][0]["mlp"]
    _reduced_logits_match_jax("starcoder2-3b", backend, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_gemma2_reduced_logits_match_jax(backend, dtype_name):
    cfg = tconfigs.reduce_config(tconfigs.get_config("gemma2-2b"))
    assert cfg.sliding_window == 8 and cfg.local_global_alternate and cfg.post_norms and cfg.embed_scale
    _reduced_logits_match_jax("gemma2-2b", backend, dtype_name, seq=16)


@pytest.mark.parametrize("arch,reduced,count", [("musicgen-large", False, 2_436_890_624),
                                                ("qwen2-vl-72b", False, 72_704_065_536),
                                                ("musicgen-large", True, 106_496),
                                                ("qwen2-vl-72b", True, 106_496)])
def test_frontend_param_counts_equal_jax(arch, reduced, count):
    """JAX's count: ``v·d`` for an embedding table a frontend config does
    not have, and ``num_codebooks·v·d`` for the audio frontend's heads;
    the norm gains are not counted."""
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    if reduced:
        t, j = tconfigs.reduce_config(t), jconfigs.reduce_config(j)
    assert t.param_count() == j.param_count() == count == t.active_param_count()
    matrices = sum(math.prod(s.shape) for s in _spec_leaves(TM.param_specs(t)) if len(s.shape) > 1)
    assert count - matrices == t.vocab_size * t.d_model  # the table the count takes and the tree lacks


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_qwen2_vl_reduced_logits_match_jax(backend, dtype_name):
    cfg = tconfigs.reduce_config(tconfigs.get_config("qwen2-vl-72b"))
    assert cfg.mrope_sections == (4, 2, 2) and cfg.frontend == "vision" and cfg.rope_theta == 1e6
    _reduced_logits_match_jax("qwen2-vl-72b", backend, dtype_name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["dense", "reference"])
def test_musicgen_reduced_logits_match_jax(backend, dtype_name):
    cfg = tconfigs.reduce_config(tconfigs.get_config("musicgen-large"))
    assert cfg.frontend == "audio" and cfg.num_codebooks == 2 and not cfg.mlp_gated
    _reduced_logits_match_jax("musicgen-large", backend, dtype_name)
