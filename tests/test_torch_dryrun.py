"""The port's dry run (``repro_torch.launch.dryrun``) and its helpers
against the JAX package's.

* ``SHAPES``, ``cells``, ``input_specs`` and ``abstract_cache`` equal JAX's
  in shape and dtype for all 10 archs and every cell (the port's per-layer
  caches stacked as JAX stacks them); ``params``, ``active_params`` and
  ``model_flops`` equal JAX's.
* Per-rank argument bytes on the production meshes, 16x16 and 2x16x16,
  equal the local bytes of JAX's ``param_pspecs``, ``batch_pspecs`` and
  ``cache_pspecs`` on ``AbstractMesh``es, for full-width configs cut in
  depth.  Where JAX's size rule cuts a cache dim that the port's local steps
  need whole (an MLA latent, the Mamba2 ``conv_b``/``conv_c`` tails, a
  KV cache's head dim where the kv heads do not divide ``model``; ROADMAP
  queue 3) the port holds that dim whole, and the test holds it to JAX's
  bytes with that dim whole.
* FLOPs of reduced dense and MoE configs equal a hand count of their
  products in train, prefill and decode, and ``FlopCounterMode``'s total;
  collective bytes on a 2x2 mesh equal a hand count of the TP all-reduces,
  the FSDP gathers (and their gradients' reduce-scatters) and the
  vocab-parallel cross entropy's all-reduces.
* The CLI writes ``dryrun_torch.json`` with JAX's record keys and
  ``fits_80gb``, and refuses JAX's ``dryrun.json``.

The fake process group lives in its own process: every run of the port's
dry run here is a subprocess with a timeout.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, SHAPES, cells, get_config, input_specs
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.models import model as TM

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 600

#: run in a child process: a fake group of ``world`` ranks, then ``body``
#: (which sets ``out``), printed as JSON on the last line
CHILD = """
import dataclasses, json, sys
import torch
from repro_torch import runtime as rtm
from repro_torch.configs import SHAPES, InputShape, cells, get_config, reduce_config, ALL_ARCHS
from repro_torch.launch import dryrun as D
world = {world}
D.fake_process_group(world)
out = {{}}
{body}
print(json.dumps(out))
"""


def run_child(world: int, body: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", CHILD.format(world=world, body=body)], capture_output=True,
                          text=True, timeout=TIMEOUT, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def depth_cut(cfg):
    """Full width, the fewest layers that keep every kind of block: one
    group of a hybrid, one MoE block after the dense ones, two layers of a
    local/global model, else one."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=cfg.attn_every)
    if cfg.family == "moe":
        return dataclasses.replace(cfg, num_layers=cfg.first_dense_layers + 1)
    return dataclasses.replace(cfg, num_layers=2 if cfg.local_global_alternate else 1)


# ---------------------------------------------------------------------------
# shapes, specs and counts against JAX
# ---------------------------------------------------------------------------


def test_shapes_and_cells_equal_jax():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cells as jcells
    from repro.configs import get_config as jget_config

    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ALL_ARCHS:
        assert cells(get_config(arch)) == jcells(jget_config(arch)), arch
    assert sum(len(cells(get_config(a))) for a in ALL_ARCHS) == 32


def _stacked(tree):
    """The port's cache tree with each list of like layers stacked, as JAX
    stacks them: ``(shape, dtype)`` leaves, ``None`` kept."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_stacked(v) for v in tree))
    if isinstance(tree, list):
        parts = [_stacked(v) for v in tree]
        return _stack(parts)
    return None if tree is None else (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _stack(parts):
    first = parts[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack([p[i] for p in parts]) for i in range(len(first))))
    if first is None:
        return None
    assert all(p == first for p in parts)
    return ((len(parts),) + first[0], first[1])


def _jax_leaves(tree):
    import jax

    if isinstance(tree, dict):
        return {k: _jax_leaves(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_jax_leaves(v) for v in tree))
    return None if tree is None else (tuple(tree.shape), str(tree.dtype))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_and_abstract_cache_equal_jax(arch):
    from repro.configs import get_config as jget_config
    from repro.configs import input_specs as jinput_specs
    from repro.models import model as JM

    cfg, jcfg = get_config(arch), jget_config(arch)
    for cell in cells(cfg):
        ours, theirs = input_specs(cfg, cell), jinput_specs(jcfg, cell)
        assert set(ours) == set(theirs)
        for k, v in ours.items():
            if k == "cache":
                got = _stacked(v)
                want = _jax_leaves(theirs[k])
                assert type(got).__name__ == type(want).__name__
                assert got == want if not isinstance(got, tuple) else tuple(got) == tuple(want)
            else:
                assert v.device.type == "meta"
                assert (tuple(v.shape), str(v.dtype).replace("torch.", "")) == (
                    tuple(theirs[k].shape), str(theirs[k].dtype)), (cell, k)
    got = _stacked(TM.abstract_cache(cfg, 4, 64))
    want = _jax_leaves(JM.abstract_cache(jcfg, 4, 64))
    assert (tuple(got) if isinstance(got, tuple) else got) == (tuple(want) if isinstance(want, tuple) else want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_active_params_and_model_flops_equal_jax(arch):
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config

    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for cell in cells(cfg):
        s = JSHAPES[cell]
        # JAX's _compile_once: 6 N D (train), 2 N D (prefill), 2 N B (decode)
        tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
        want = (6.0 if s.kind == "train" else 2.0) * jcfg.active_param_count() * tokens
        assert D.model_flops(cfg, SHAPES[cell]) == want


def test_abstract_params_are_local_meta_shards_and_draw_nothing():
    from repro_torch.models.common import abstract_params, init_params
    from repro_torch.configs import reduce_config

    cfg = reduce_config(get_config("deepseek-7b"))
    specs = TM.param_specs(cfg)
    ab = abstract_params(specs)
    real = init_params(specs, seed=0, device="cpu")
    state = torch.random.get_rng_state()
    ab = abstract_params(specs, dtype=torch.float32)
    assert torch.equal(state, torch.random.get_rng_state())
    flat = lambda t: [x for x in D._tensors(t)]
    assert [(x.shape, x.device.type) for x in flat(ab)] == [(y.shape, "meta") for y in flat(real)]
    assert {x.dtype for x in flat(ab)} == {torch.float32}


# ---------------------------------------------------------------------------
# per-rank argument bytes against JAX's spec tables on abstract meshes
# ---------------------------------------------------------------------------

ARG_BODY = """
import dataclasses
def cut(cfg):
    if cfg.family == "hybrid": return dataclasses.replace(cfg, num_layers=cfg.attn_every)
    if cfg.family == "moe": return dataclasses.replace(cfg, num_layers=cfg.first_dense_layers + 1)
    return dataclasses.replace(cfg, num_layers=2 if cfg.local_global_alternate else 1)
mp = world == 512
mesh = D.fake_mesh(*D.MESHES[mp])
for arch in ALL_ARCHS:
    cfg = cut(get_config(arch))
    for c in cells(cfg):
        pol = D.policy_for(SHAPES[c], mesh)
        with rtm.Runtime(backend="dense", device="meta", sharding=pol).use():
            held, _ = D.rank_inputs(cfg, SHAPES[c], pol)
        out[arch + "|" + c] = {k: sum(D._nbytes(t) for t in D._tensors(v)) for k, v in held.items()}
"""


@pytest.fixture(scope="module", params=[256, 512], ids=["pod", "multipod"])
def port_arg_bytes(request):
    return request.param, run_child(request.param, ARG_BODY)


def _local_bytes(tree, specs, sizes, whole=lambda path, spec: spec):
    """Sum over leaves of the bytes of one shard under JAX's specs;
    ``whole(path, spec)`` may drop entries the port holds whole."""
    import jax
    from jax.sharding import PartitionSpec

    total = 0
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for (path, x), spec in zip(leaves, spec_leaves):
        n = math.prod(x.shape) * np.dtype(x.dtype).itemsize
        for e in whole(jax.tree_util.keystr(path), tuple(spec)):
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= sizes[a]
        total += n
    return total


def _port_layout(cfg, tp):
    """``whole(path, spec)`` for JAX's cache specs: the entries the port's
    ``rank_cache_pspecs`` holds whole.  JAX's size rule cuts the first dim
    after the batch that divides ``model``; the port's local steps hold an
    MLA latent and RoPE key, the Mamba2 B/C conv tails, and a KV cache's
    head dim (its kv heads replicated where they do not divide ``model``)
    whole on every model rank."""
    splits = TM.cache_splits(cfg, tp)

    def whole(path, spec):
        leaf = path.rsplit(".", 1)[-1]
        keep_model = (leaf in ("conv_x", "state") and "ssm" in splits) or (
            leaf in ("k", "v", "k_scale", "v_scale") and "kv" in splits and spec[-1] != "model")
        if leaf in ("c_kv", "k_pe", "conv_b", "conv_c") or not keep_model:
            return tuple(None if e == "model" else e for e in spec)
        return spec

    return whole


def test_rank_argument_bytes_equal_jax_layouts(port_arg_bytes):
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.configs import input_specs as jinput_specs
    from repro.models import model as JM
    from repro.models.common import abstract_params as jabstract_params
    from repro.optim.adamw import init_opt_state as jinit_opt_state
    from repro.parallel.sharding import batch_pspecs, cache_pspecs, param_pspecs

    world, port = port_arg_bytes
    shape, names = D.MESHES[world == 512]
    mesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    differs = set()
    for arch in ALL_ARCHS:
        jcfg = depth_cut(jget_config(arch))
        specs = JM.param_specs(jcfg)
        aparams, pps = jabstract_params(specs), param_pspecs(specs, mesh)
        for cell in cells(jcfg):
            s = JSHAPES[cell]
            got = port[f"{arch}|{cell}"]
            assert got["params"] == _local_bytes(aparams, pps, sizes), (arch, cell)
            inputs = jinput_specs(jcfg, s)
            bps = {k: v for k, v in batch_pspecs(jcfg, s, mesh).items() if k in inputs}
            assert got["batch"] == _local_bytes({k: inputs[k] for k in bps}, bps, sizes), (arch, cell)
            if s.kind == "train":
                opt = jax.eval_shape(jinit_opt_state, aparams)
                assert got["opt"] == _local_bytes((opt.m, opt.v), (pps, pps), sizes)
            if s.kind == "decode":
                cps = cache_pspecs(jcfg, s, mesh, inputs["cache"])
                tp = sizes["model"]
                assert got["cache"] == _local_bytes(inputs["cache"], cps, sizes, _port_layout(get_config(arch), tp))
                if got["cache"] != _local_bytes(inputs["cache"], cps, sizes):
                    differs.add(arch)
                assert got["pos"] == 4  # JAX's 0-d int32 pos
    # the layouts differ exactly where the port holds a dim JAX's size rule cuts
    assert differs == {"deepseek-v2-236b", "gemma2-2b", "mamba2-780m", "qwen2-vl-72b", "qwen3-4b",
                       "qwen3-moe-235b-a22b", "starcoder2-3b", "zamba2-2.7b"}


# ---------------------------------------------------------------------------
# FLOPs and collectives against hand counts
# ---------------------------------------------------------------------------

COUNT_BODY = """
from torch.utils.flop_counter import FlopCounterMode
mesh = D.fake_mesh((1, 1) if world == 1 else (2, 2), ("data", "model"))
cells_ = {"train": InputShape("t", 16, 4, "train"), "prefill": InputShape("p", 16, 2, "prefill"),
          "decode": InputShape("d", 16, 2, "decode")}
for arch in ("deepseek-7b", "qwen3-moe-235b-a22b"):
    cfg = reduce_config(get_config(arch))
    for kind, shape in cells_.items():
        r = D.run_cell(cfg, shape, mesh)
        c = r["counter"]
        rec = {"flops": c.flops, "calls": c.calls, "peak": r["peak_bytes"], "args": r["argument_bytes"]}
        if world == 1:
            with FlopCounterMode(display=False) as fc:
                D.run_cell(cfg, shape, mesh)
            rec["flop_counter"] = fc.get_total_flops()
        out[arch + "|" + kind] = rec
    if world == 4:
        # the loss alone (no backward): the vocab-parallel cross entropy's all-reduces
        from repro_torch.models import model as M
        pol = D.policy_for(cells_["train"], mesh)
        with rtm.Runtime(backend="dense", device="meta", sharding=pol).use():
            held, inputs = D.rank_inputs(cfg, cells_["train"], pol)
            c = D.Counter(D._tensors(held) + D._tensors(inputs))
            with c, torch.no_grad():
                M.loss_fn(held["params"], cfg, held["batch"])
        out[arch + "|loss"] = {"calls": c.calls}
"""


@pytest.fixture(scope="module")
def counts_1x1():
    return run_child(1, COUNT_BODY)


@pytest.fixture(scope="module")
def counts_2x2():
    return run_child(4, COUNT_BODY)


def _dense_fwd_flops(cfg, tokens: int, keys: int, head_tokens: int) -> dict:
    """Forward product FLOPs by operand dtype of reduced deepseek-7b (bf16
    weights): the projections, the fp32 scores, the bf16 P.V, the gated FFN
    and the head."""
    d, h, kv, hd, f, v, n = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
                             cfg.vocab_size, cfg.num_layers)
    proj = 2 * d * h * hd * 2 + 2 * d * kv * hd * 2  # wq, wo; wk, wv
    ffn = 3 * 2 * d * f
    return {"bfloat16": n * tokens * (proj + ffn + 2 * h * keys * hd) + head_tokens * 2 * d * v,
            "float32": n * tokens * 2 * h * hd * keys}


def _moe_fwd_flops(cfg, tokens: int, keys: int, head_tokens: int, decode: bool) -> dict:
    """Reduced qwen3-moe: attention as dense, the fp32 router, every
    expert at its capacity (the decode branch's: 4x the share, at least 1,
    at most T*k) and the
    combine's weighted sum."""
    d, h, kv, hd, v, n = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.vocab_size,
                          cfg.num_layers)
    e, k, f = cfg.num_experts, cfg.top_k, cfg.moe_d_ff
    share = int(tokens * k / e * cfg.capacity_factor)
    cap = min(max(1, share * 4), tokens * k) if decode else max(1, share)
    proj = 2 * d * h * hd * 2 + 2 * d * kv * hd * 2
    experts = e * cap * 3 * 2 * d * f
    combine = 2 * tokens * k * d
    return {"bfloat16": n * (tokens * (proj + 2 * h * keys * hd) + experts + combine) + head_tokens * 2 * d * v,
            "float32": n * tokens * (2 * h * hd * keys + 2 * d * e)}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-moe-235b-a22b"])
def test_flops_equal_hand_count(counts_1x1, arch, kind):
    from repro_torch.configs import reduce_config

    cfg = reduce_config(get_config(arch))
    rec = counts_1x1[f"{arch}|{kind}"]
    tokens, keys, head = {"train": (64, 16, 64), "prefill": (32, 16, 2), "decode": (2, 16, 2)}[kind]
    if arch == "deepseek-7b":
        want = _dense_fwd_flops(cfg, tokens, keys, head)
    else:
        want = _moe_fwd_flops(cfg, tokens, keys, head, decode=kind == "decode")
    if kind == "train":  # each product's backward: the gradients of both its operands
        want = {dt: 3 * f for dt, f in want.items()}
    assert rec["flops"] == want
    assert sum(rec["flops"].values()) == rec["flop_counter"]


def test_collectives_equal_hand_count_on_2x2(counts_2x2):
    """Reduced deepseek-7b on ``(data 2, model 2)``, operand bytes per rank.
    FSDP: each weight gathered over ``data`` (the embedding's and the
    head's d_model halves; each layer's q/k/v/o and FFN weights); the
    gradient of each reduce-scattered in fp32.  TP: the vocab-parallel
    embedding's and each attention's and FFN's partial outputs all-reduced
    over ``model`` in fp32.  CE: the max and the two sums of the
    vocab-parallel cross entropy over ``model``, the mean's share over
    ``data``."""
    from repro_torch.configs import reduce_config

    cfg = reduce_config(get_config("deepseek-7b"))
    d, h, kv, hd, f, v, n = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
                             cfg.vocab_size, cfg.num_layers)
    # gathered over data: [V/2, d] embedding, [d, V/2] head, a layer's local weights
    layer_w = d * (h * hd // 2) * 2 + d * (kv * hd // 2) * 2 + 3 * d * (f // 2)
    gathered = 2 * (v // 2) * d + n * layer_w  # elements, bf16
    per = lambda calls, kind: RL.collective_bytes([(k, b, g) for k, b, g, _ in calls])[kind]

    pre = counts_2x2["deepseek-7b|prefill"]["calls"]
    rows = 16  # batch 2 over data 2: one 16-token row a rank
    # bf16 gathers: operand = result / 2 = the gathered elements' count in
    # bytes; then the last position's logits gathered over model ([1, 1, V/2])
    assert per(pre, "all-gather") == gathered + (v // 2) * 2
    assert per(pre, "all-reduce") == 4 * rows * d + n * 2 * 4 * rows * d  # embedding + attention + FFN, fp32
    train = counts_2x2["deepseek-7b|train"]["calls"]
    assert per(train, "reduce-scatter") == 4 * gathered  # each gathered weight's fp32 gradient
    loss = counts_2x2["deepseek-7b|loss"]["calls"]
    tokens = 2 * 16  # batch 4 over data 2
    ce = [b for k, b, g, _ in loss if k == "all-reduce"][-3:]
    assert ce == [4 * tokens, 2 * 4 * tokens, 4]  # max, (sum, target), the mean's share over data
    assert per(loss, "all-reduce") == 4 * tokens * d + n * 2 * 4 * tokens * d + sum(ce)
    for k, b, g, inter in pre + train + loss:  # one axis, or the whole mesh (the norm); one host
        assert g in (2, 4) and not inter


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

JAX_KEYS = {"arch", "shape", "mesh", "chips", "kind", "lower_s", "compile_s", "hbm_bytes_adj", "memory_adj_s",
            "mem", "roofline", "collectives", "model_flops", "params", "active_params", "useful_flops_ratio", "ok"}


def test_cli_writes_both_meshes_with_jax_keys(tmp_path):
    out = tmp_path / "results" / "dryrun_torch.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-780m", "--shape", "long_500k",
           "--mesh", "both", "--out", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(out.read_text())
    assert set(res) == {"mamba2-780m|long_500k|pod", "mamba2-780m|long_500k|multipod"}
    for key, rec in res.items():
        assert rec["ok"], rec
        assert JAX_KEYS <= set(rec) and "fits_80gb" in rec
        assert set(rec["mem"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
        assert {"compute_s", "memory_s", "collective_s", "dominant", "bound_s"} <= set(rec["roofline"])
        assert rec["chips"] == (512 if key.endswith("multipod") else 256)
        assert rec["mesh"] == ("2x16x16" if key.endswith("multipod") else "16x16")
        assert rec["fits_80gb"] and rec["sequence_split"] == "data"
    assert "done: 2/2 cells ok" in proc.stdout
    bad = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-780m", "--out",
           str(tmp_path / "dryrun.json")]
    proc = subprocess.run(bad, capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert proc.returncode != 0 and "dryrun.json" in proc.stderr
    assert not (tmp_path / "dryrun.json").exists()


REGROUP_BODY = """
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S
import torch.distributed as dist
cfg = reduce_config(get_config("deepseek-7b"))
seen = []
for turn in range(2):
    if turn:
        D.fake_process_group(world)
    pol = S.ShardingPolicy(mesh=D.fake_mesh((2, 2), ("data", "model")))
    sh = T.shards_of(cfg, rtm.Runtime(backend="dense", device="meta", sharding=pol))
    S.mesh_all_reduce(torch.zeros(2, device="meta"), sh)  # its groups are this process group's
    seen.append(id(sh))
    dist.destroy_process_group()
out["fresh"] = seen[0] != seen[1]
"""


def test_an_equal_mesh_over_a_new_process_group_gets_new_groups():
    """Two meshes of one layout compare equal; the model's groups are cached
    per mesh object, so a mesh made over a later process group (one after
    another in a process, as chip_smoke's phases make them) never gets the
    destroyed group's."""
    assert run_child(4, REGROUP_BODY)["fresh"]


def test_save_refuses_the_jax_file(tmp_path):
    with pytest.raises(ValueError, match="dryrun.json"):
        D.save_results(str(tmp_path / "dryrun.json"), {})
