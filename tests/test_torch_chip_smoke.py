"""chip_smoke.py's helpers for the frontend train phases, on the CPU.

The train batches of qwen2-vl-ReLU and musicgen-large at full width are
built on the ``meta`` device (shapes, dtypes; nothing allocated), the M-RoPE
rope index is checked value by value, ``train_cut``'s choice is reckoned
from ``param_specs`` under a dispatch mode that fails on any tensor
operation, and the train path's launch and plan-cache counts are held to
the path the phases' docstrings spell out.  The counts were held on the
card by the phases themselves; the plan-cache formula also matches a
reduced qwen2-vl-ReLU step on the ``reference`` backend here.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import runtime as trt
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import model as TM
from repro_torch.models.common import init_params
from repro_torch.optim import OptConfig
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def C():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class NoTensorOps(TorchDispatchMode):
    """Fails on any aten operation: no tensor is made, so nothing allocates."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran")


def _vl_relu():
    return dataclasses.replace(get_config("qwen2-vl-72b"), activation="relu")


def test_train_cut_of_the_frontends_allocates_nothing(C):
    with NoTensorOps():
        vl, n_vl = C.train_cut(_vl_relu())
        mg, n_mg = C.train_cut(get_config("musicgen-large"))
        two = C.spec_numel(TM.param_specs(dataclasses.replace(vl, num_layers=2)))
    # one layer and the head (no embedding: a frontend feeds embeddings)
    assert vl.num_layers == 1 and vl.activation == "relu" and vl.d_model == 8192 and vl.vocab_size == 152064
    assert round(n_vl / 1e9, 3) == 2.123
    assert n_vl * C.TRAIN_BYTES_PER_PARAM <= C.TRAIN_BUDGET_GB * 1e9 < two * C.TRAIN_BYTES_PER_PARAM
    assert mg.num_layers == 48 and round(n_mg / 1e9, 3) == 2.433  # whole


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-large"])
def test_frontend_train_batch_shapes(C, arch):
    cfg = _vl_relu() if arch == "qwen2-vl-72b" else get_config(arch)
    b, s = C.TRAIN_BATCH, C.TRAIN_SEQ
    batch = C.frontend_train_batch(cfg, 1, "meta")
    assert batch["inputs_embeds"].shape == (b, s, cfg.d_model) and batch["inputs_embeds"].dtype == torch.bfloat16
    assert batch["inputs_embeds"].device.type == "meta"
    labels = (b, s, cfg.num_codebooks) if cfg.frontend == "audio" else (b, s)
    assert tuple(batch["labels"].shape) == labels and batch["labels"].dtype == torch.int32
    assert ("positions" in batch) == (cfg.mrope_sections is not None)
    if "positions" in batch:
        assert tuple(batch["positions"].shape) == (b, 3, s)
    # every microbatch cuts each leaf on its rows, positions included
    halves = [{k: v[i * b // 2:(i + 1) * b // 2] for k, v in batch.items()} for i in range(2)]
    assert all(v.shape[0] == b // 2 for h in halves for v in h.values())


def test_frontend_train_batch_values_on_the_cpu(C):
    cfg = reduce_config(get_config("qwen2-vl-72b"))
    one, again, other = (C.frontend_train_batch(cfg, i, "cpu") for i in (1, 1, 2))
    assert torch.equal(one["inputs_embeds"], again["inputs_embeds"])
    assert not torch.equal(one["inputs_embeds"], other["inputs_embeds"])
    labels = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(C.TRAIN_BATCH, C.TRAIN_SEQ))
    assert np.array_equal(one["labels"].numpy(), labels)
    assert int(one["labels"].max()) < cfg.vocab_size


def test_the_rope_index_is_qwen2_vl_s_image_prompt(C):
    pos = C.vl_positions(2)
    text, (gh, gw) = C.VL_TEXT, C.VL_GRID
    assert pos.shape == (2, 3, C.TRAIN_SEQ) == (2, 3, 2 * text + gh * gw)
    assert np.array_equal(pos[0], pos[1])
    p = pos[0].T  # [S, 3]: (t, h, w) per position
    assert np.array_equal(p[:text], np.repeat(np.arange(text)[:, None], 3, 1))
    image = p[text:text + gh * gw].reshape(gh, gw, 3)
    assert (image[..., 0] == text).all()
    assert np.array_equal(image[..., 1], text + np.arange(gh)[:, None].repeat(gw, 1))
    assert np.array_equal(image[..., 2], text + np.arange(gw)[None, :].repeat(gh, 0))
    start = text + max(gh, gw)
    assert np.array_equal(p[text + gh * gw:], np.repeat(np.arange(start, start + text)[:, None], 3, 1))
    assert not (p[:, 0] == p[:, 1]).all()  # three streams: M-RoPE is not RoPE here


def test_train_path_counts(C):
    vl = dataclasses.replace(_vl_relu(), num_layers=1)
    want = C.train_path_launches(vl, 2)
    # per microbatch, remat's two forwards: 2 fused gates, 2 w_down forwards, the
    # head's, 2 x 3 backward products; plans: 2 by value (w_down's and the head's
    # cotangents), 3 from masks, 1 transpose; a step: the head's weight plan and
    # its transpose
    assert want["tensordash_matmul_fused"] == 4 and want["tensordash_matmul_planned"] == 18
    assert (want["planner[values]"], want["planner[emitted]"], want["planner[transpose]"]) == (5, 6, 3)
    assert C.train_path_launches(vl, 2, first=True)["planner[transpose]"] == 4
    assert C.train_plan_cache(vl, 2, first=True) == (3, 9) and C.train_plan_cache(vl, 2) == (4, 8)
    assert not any(C.train_path_launches(get_config("musicgen-large"), 2).values())
    assert C.train_plan_cache(get_config("musicgen-large"), 2) == (0, 0)
    # the deepseek train phase's path (4 layers), as that phase held it on the card
    ds = dataclasses.replace(get_config("deepseek-7b"), activation="relu", num_layers=4)
    got = C.train_path_launches(ds, 2)
    assert (got["tensordash_matmul_fused"], got["tensordash_matmul_planned"], got["planner[values]"],
            got["planner[emitted]"], got["planner[transpose]"]) == (16, 54, 11, 24, 9)
    with pytest.raises(ValueError):
        C.train_path_launches(get_config("mamba2-780m"), 2)


def test_train_plan_cache_counts_match_a_reduced_step(C):
    """The formula against the plan cache of a reduced qwen2-vl-ReLU (one
    layer, remat) trained on the ``reference`` backend for two steps."""
    cfg = dataclasses.replace(reduce_config(get_config("qwen2-vl-72b")), activation="relu", num_layers=1, remat=True)
    params = init_params(TM.param_specs(cfg), seed=0, dtype=torch.float32, device="cpu")
    rt = trt.Runtime(backend="reference", device="cpu", bm=8, bk=16, bn=16)
    rng = np.random.default_rng(0)
    with rt.use():
        opt = tstep.init_train_state(cfg, params)
        step = tstep.make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1), microbatches=2)
        prev = rt.plan_cache.stats()
        for i in range(2):
            b, s = 4, 16
            batch = {"inputs_embeds": torch.from_numpy(rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)),
                     "positions": torch.from_numpy(np.broadcast_to(
                         np.stack([np.arange(s), np.arange(s) // 4, np.arange(s) % 4]), (b, 3, s)).copy()),
                     "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))}
            params, opt, m = step(params, opt, batch)
            pc = rt.plan_cache.stats()
            assert (pc["hits"] - prev["hits"], pc["misses"] - prev["misses"]) == C.train_plan_cache(
                cfg, 2, first=i == 0)
            prev = pc
            assert torch.isfinite(m["loss"])


def test_plans_first_built_while_serving_train():
    """chip_smoke serves qwen2-vl before it trains it: a plan first built
    under ``torch.inference_mode`` (the dense gate's memoized plan, the LM
    head's cached plan) must be a normal tensor, which a training step's
    backward can save.  Reduced deepseek-7b-ReLU: a prefill under inference
    mode, then the loss and gradients on the same runtime and shapes, equal
    to a runtime that never served."""
    cfg = dataclasses.replace(reduce_config(get_config("deepseek-7b")), activation="relu")
    params = init_params(TM.param_specs(cfg), seed=0, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int64))
    batch = {"tokens": tokens, "labels": tokens}
    served = trt.Runtime(backend="reference", device="cpu", bm=8, bk=16, bn=16)
    with torch.inference_mode(), served.use():
        TM.prefill(params, cfg, {"tokens": tokens})
    assert served.plan_cache.stats()["misses"] == 1
    got = {}
    for tag, rt in (("served", served), ("fresh", trt.Runtime(backend="reference", device="cpu", bm=8, bk=16, bn=16))):
        with rt.use():
            loss, grads, _ = tstep.accumulate_grads(tstep.make_loss_fn(cfg), cfg, params, batch)
        got[tag] = (float(loss), [g.detach().clone() for g in grads])
    assert got["served"][0] == got["fresh"][0]
    assert all(torch.equal(a, b) for a, b in zip(got["served"][1], got["fresh"][1]))
