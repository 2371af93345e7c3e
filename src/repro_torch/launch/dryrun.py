"""Dry run on the production meshes (port of ``repro/launch/dryrun.py``):
every (architecture x input shape) cell as rank 0's program on ``meta``
tensors, which hold no memory, under a fake process group of 256 (16x16)
or 512 (2x16x16) ranks, priced at H100 rates.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --mesh pod

A cell runs the port's own entry points on the ``dense`` backend, as the
JAX dry run lowers on it: ``make_train_step`` for ``train_4k``, ``prefill``
for ``prefill_32k``, ``decode_step`` for ``decode_32k`` and ``long_500k``
(whose batch-1 cache is split over ``data`` by sequence, item 14e).  Rank 0
holds its ``local_shard`` of every parameter, its AdamW moments, its cut of
the batch and its decode caches (``rank_cache_pspecs``).  A dispatch mode
counts, per rank:

* FLOPs by operand dtype, by ``torch.utils.flop_counter``'s formulas (the
  same total as ``FlopCounterMode``);
* bytes as the inputs and outputs of every op that is not a view (the
  unfused convention of XLA-CPU's ``bytes accessed``);
* the collectives at the dispatcher: result bytes, group size and whether
  the group spans hosts of 8 ranks (:mod:`repro_torch.launch.roofline`);
* argument bytes (what the rank holds before the step), peak bytes (the
  arguments plus the most the step's own tensors held at once, from live
  ``meta`` storage) and output bytes (returned tensors that are not
  arguments).

Nothing is scanned, so every cell counts its full depth; no per-layer
extrapolation is needed.  Results go to ``results/dryrun_torch.json``
(``--out``), keyed ``arch|shape|pod`` or ``arch|shape|multipod``, with the
JAX dry run's keys plus ``fits_80gb``; ``lower_s`` is the seconds to build
the rank's abstract inputs and ``compile_s`` the seconds of the counted run
(nothing compiles).  JAX's ``results/dryrun.json`` is never written.

The fake process group (``torch.testing._internal.distributed.fake_pg``)
is the default group of the process that runs the cells: start the dry run
in a process of its own, never one that holds another group.  With
``--mesh both`` or ``--jobs`` above 1 each (mesh, arch) runs in a child
process of its own, ``--jobs`` of them at once.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ALL_ARCHS, SHAPES, InputShape, cells, get_config, input_specs
from repro_torch.launch.roofline import H100, RooflineTerms, collective_bytes, spans_hosts
from repro_torch.parallel import sharding as S

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch.json")

#: the JAX dry run's file, which this one never writes
JAX_RESULTS = "dryrun.json"

#: ``multi_pod`` -> (mesh shape, axis names): the production meshes
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}

#: c10d op name -> the collective kind it is counted under
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute", "broadcast_": "collective-permute",
}

#: ops that ask for metadata only (the flop counter skips them too)
_META_OPS = {
    torch.ops.aten.sym_is_contiguous.default, torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format, torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default, torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default, torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}


def fake_process_group(world: int) -> None:
    """Make a fake default process group of ``world`` ranks, this process
    rank 0: collectives return at once and move nothing.  The module is
    private to torch; where it is missing this raises (there is no other
    way to run a 512-rank program in one process)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs torch.testing._internal.distributed.fake_pg, "
                           f"which this torch ({torch.__version__}) lacks") from e
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group: run it in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def fake_mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` over the fake group's ranks, row-major."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=tuple(names))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _key(t) -> int:
    return t.untyped_storage()._cdata


class Counter(TorchDispatchMode):
    """Counts what one run does, per rank: FLOPs by operand dtype, bytes in
    and out of each op, collectives, and the live bytes of the tensors the
    run makes (``args``: the tensors it is given, which are not counted as
    made).  ``peak`` is the most those held at once."""

    def __init__(self, args=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops: dict[str, float] = {}
        self.bytes = 0
        self.calls: list = []  # (kind, result bytes, group size, spans hosts)
        self._arg_keys = {_key(t) for t in args}
        self._live: dict = {}  # storage key -> [bytes, tensors alive]
        self._seen: set = set()
        self.cur = self.peak = 0
        self._groups: dict = {}

    # -- live storage --------------------------------------------------------
    def _release(self, key: int, tid: int) -> None:
        self._seen.discard(tid)
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.cur -= entry[0]
            del self._live[key]

    def _track(self, t) -> None:
        key = _key(t)
        if key in self._arg_keys:
            return
        if key not in self._live:
            nb = t.untyped_storage().nbytes()
            self._live[key] = [nb, 0]
            self.cur += nb
            self.peak = max(self.peak, self.cur)
        if id(t) not in self._seen:
            self._seen.add(id(t))
            self._live[key][1] += 1
            weakref.finalize(t, self._release, key, id(t))

    # -- collectives -----------------------------------------------------------
    def _group(self, obj):
        pg = dist.ProcessGroup.unbox(obj)
        if pg.group_name not in self._groups:
            ranks = dist.get_process_group_ranks(pg)
            self._groups[pg.group_name] = (len(ranks), spans_hosts(ranks))
        return self._groups[pg.group_name]

    def _collective(self, func, args) -> None:
        name = func._schema.name.split("::")[-1]
        kind = _C10D_KINDS.get(name)
        if kind is None:
            return  # barrier and the like move no payload
        g = next((a for a in args if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type())), None)
        size, inter = self._group(g) if g is not None else (1, False)
        if size > 1:
            self.calls.append((kind, sum(_nbytes(t) for t in _tensors(args[0])), size, inter))

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_OPS:
            return func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.registry and func is not torch.ops.prim.device.default:
            out = func.decompose(*args, **kwargs)  # as FlopCounterMode does, under this mode
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in self.registry:
            first = next(t for t in _tensors((args, kwargs)))
            dt = str(first.dtype).replace("torch.", "")
            self.flops[dt] = self.flops.get(dt, 0) + self.registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


def _local(x, spec, policy):
    """A fresh meta tensor of this rank's shard of ``x`` under ``spec``."""
    return torch.empty_like(S.local_shard(x, spec, policy), memory_format=torch.contiguous_format)


def model_flops(cfg, shape: InputShape) -> float:
    """JAX's ``model_flops``: 6 N D for a train cell, 2 N D otherwise (N the
    active parameters, D the tokens; one new token a row in decode)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def policy_for(shape: InputShape, mesh):
    """The cell's sharding policy: ``mesh``, and the decode caches'
    sequence split where the batch does not divide the data axes
    (:func:`repro_torch.parallel.sharding.seq_axis`)."""
    return S.ShardingPolicy(mesh=mesh, seq_axis=S.seq_axis(shape, mesh) if shape.kind == "decode" else None)


def rank_inputs(cfg, shape: InputShape, policy, *, dtype=torch.bfloat16) -> tuple[dict, dict]:
    """``(held, inputs)``: what this rank holds before the cell's step, as
    meta tensors (``params``, its local shards; ``opt``, the AdamW moments
    of a train cell; ``batch``, its cut of the batch; ``cache`` and ``pos``
    of a decode cell: its decode caches under ``rank_cache_pspecs``), and
    the cell's global inputs (:func:`~repro_torch.configs.input_specs`).
    Call under a runtime whose sharding is ``policy``."""
    from repro_torch.models import model as M
    from repro_torch.models.common import abstract_params
    from repro_torch.optim import init_opt_state
    from repro_torch.train.step import local_batch

    sh = S.ModelShards(policy, policy.param_pspecs(M.param_specs(cfg)))
    params = abstract_params(M.param_specs(cfg), dtype=dtype, policy=policy)
    inputs = input_specs(cfg, shape)
    held = {"params": params}
    if shape.kind == "train":
        opt = init_opt_state(params)
        held.update(opt=opt, batch=local_batch(cfg, inputs, sh))
        return held, inputs
    bspecs = policy.batch_pspecs(cfg, shape)
    held["batch"] = {k: _local(v, bspecs[k], policy) for k, v in inputs.items() if k in bspecs}
    if shape.kind == "decode":
        glob = inputs["cache"]
        data = sh.data_axes if shape.global_batch % sh.n_data == 0 else ()
        specs = S.rank_cache_pspecs(glob, data, M.cache_splits(cfg, sh.tp), seq=policy.seq_axis)
        held["cache"] = S.map_specs(lambda x, sp: _local(x, sp, policy), glob, specs)
        held["pos"] = inputs["pos"]
    return held, inputs


def run_cell(cfg, shape: InputShape, mesh, *, microbatches: int = 1, dtype=torch.bfloat16) -> dict:
    """Rank 0's program of one cell on ``mesh`` (a ``DeviceMesh`` of the
    fake group): its counts and the record's fields (see the module
    docstring).  ``cfg`` may be cut or changed; ``microbatches`` goes to the
    train step."""
    from repro_torch import runtime as rtm
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig
    from repro_torch.train.step import make_train_step

    t0 = time.time()
    policy = policy_for(shape, mesh)
    with rtm.Runtime(backend="dense", device="meta", sharding=policy).use():
        held, inputs = rank_inputs(cfg, shape, policy, dtype=dtype)
        # the train step takes the global batch and cuts each microbatch's rows
        given = _tensors(held) + (_tensors(inputs) if shape.kind == "train" else [])
        t_lower = time.time() - t0
        counter = Counter(given)
        t0 = time.time()
        with counter:
            if shape.kind == "train":
                step = make_train_step(cfg, OptConfig(), microbatches=microbatches)
                out = step(held["params"], held["opt"], inputs)
            else:
                with torch.no_grad():
                    if shape.kind == "prefill":
                        out = M.prefill(held["params"], cfg, held["batch"])
                    else:
                        out = M.decode_step(held["params"], cfg, held["cache"], held["batch"], held["pos"])
            given_keys = {_key(t) for t in given}
            made = {_key(t): t for t in _tensors(out) if _key(t) not in given_keys}
            out_bytes = sum(t.untyped_storage().nbytes() for t in made.values())
            del out, made
        t_run = time.time() - t0
    arg_bytes = sum(_nbytes(t) for t in _tensors(held))
    return {"counter": counter, "lower_s": t_lower, "compile_s": t_run, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes, "peak_bytes": arg_bytes + counter.peak, "temp_bytes": counter.peak}


def record(arch: str, cfg, shape: InputShape, mesh, **kw) -> dict:
    """One cell's record, JAX's keys plus the port's (see the module
    docstring)."""
    r = run_cell(cfg, shape, mesh, **kw)
    c, chips = r["counter"], mesh.mesh.numel()
    calls = [(k, b, g) for k, b, g, _ in c.calls]
    per = collective_bytes(calls)
    inter = collective_bytes([(k, b, g) for k, b, g, x in c.calls if x])
    flops = sum(c.flops.values())
    terms = RooflineTerms(flops=flops * chips, hbm_bytes=float(c.bytes) * chips,
                          coll_bytes=float(sum(per.values())) * chips,
                          chips=chips, flops_by_dtype=tuple(sorted((d, f * chips) for d, f in c.flops.items())),
                          coll_bytes_inter=float(sum(inter.values())) * chips)
    adj = (r["argument_bytes"] + r["output_bytes"] + 2 * r["temp_bytes"]) * chips
    mf = model_flops(cfg, shape)
    return {
        "arch": arch, "shape": shape.name, "mesh": "x".join(map(str, mesh.mesh.shape)), "chips": chips,
        "kind": shape.kind, "lower_s": round(r["lower_s"], 1), "compile_s": round(r["compile_s"], 1),
        "hbm_bytes_adj": adj, "memory_adj_s": adj / (chips * H100.hbm_bw),
        "mem": {"argument_bytes": r["argument_bytes"], "output_bytes": r["output_bytes"],
                "temp_bytes": r["temp_bytes"], "peak_bytes": r["peak_bytes"]},
        "roofline": terms.as_dict(),
        "collectives": {k: v * chips for k, v in per.items()},
        "collectives_inter_host": {k: v * chips for k, v in inter.items()},
        "model_flops": mf, "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "useful_flops_ratio": mf / terms.flops if terms.flops else None,
        "fits_80gb": r["peak_bytes"] <= H100.hbm_bytes,
        "depth": f"full ({cfg.num_layers} layers counted; nothing is scanned, no extrapolation)",
        "sequence_split": S.seq_axis(shape, mesh) if shape.kind == "decode" else None,
        "ok": True,
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """One production cell on the fake group already made (its size must
    be the mesh's)."""
    return record(arch, get_config(arch), SHAPES[shape_name], fake_mesh(*MESHES[multi_pod]))


def load_results(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(path: str, results: dict) -> None:
    if os.path.basename(path) == JAX_RESULTS:
        raise ValueError(f"{path}: the port's dry run never writes the JAX dry run's {JAX_RESULTS}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(results, f, indent=1)
    os.replace(tmp, path)


def _one_mesh(args, multi_pod: bool) -> None:
    shape, _ = MESHES[multi_pod]
    world = 1
    for s in shape:
        world *= s
    fake_process_group(world)
    try:
        results = load_results(args.out)
        archs = ALL_ARCHS if args.arch is None else [args.arch]
        for arch in archs:
            shapes = cells(get_config(arch)) if args.shape is None else [args.shape]
            for shape_name in shapes:
                key = f"{arch}|{shape_name}|{'multipod' if multi_pod else 'pod'}"
                if key in results and results[key].get("ok") and not args.force:
                    print(f"[skip] {key}")
                    continue
                print(f"[run ] {key}", flush=True)
                try:
                    rec = lower_cell(arch, shape_name, multi_pod)
                    r = rec["roofline"]
                    print(f"   ok: run={rec['compile_s']}s compute={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s"
                          f" coll={r['collective_s']:.4f}s dom={r['dominant']}"
                          f" useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}"
                          f" peak/rank={rec['mem']['peak_bytes'] / 1e9:.2f}GB fits_80gb={rec['fits_80gb']}",
                          flush=True)
                except Exception as e:  # record failures: they are bugs
                    rec = {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"   FAIL {type(e).__name__}: {e}", flush=True)
                results[key] = rec
                save_results(args.out, results)
    finally:
        dist.destroy_process_group()


def _children(args) -> int:
    """The cells in child processes, one a (mesh, arch), at most
    ``args.jobs`` at once, each into a file of its own, merged into
    ``--out``; the first nonzero exit code, or 0."""
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = [args.arch] if args.arch else ALL_ARCHS
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--jobs", "1"]
    base += ["--shape", args.shape] if args.shape else []
    base += ["--force"] if args.force else []
    results = load_results(args.out)
    todo, running, rcs = [], [], []
    for m in meshes:
        for a in archs:
            part = f"{args.out}.{m}.{a}.json"
            save_results(part, {k: v for k, v in results.items() if k.startswith(f"{a}|") and k.endswith(f"|{m}")})
            todo.append((part, base + ["--mesh", m, "--arch", a, "--out", part]))
    parts = [p for p, _ in todo]
    while todo or running:
        while todo and len(running) < args.jobs:
            running.append(subprocess.Popen(todo.pop(0)[1]))
        time.sleep(0.2)
        rcs += [p.returncode for p in running if p.poll() is not None]
        running = [p for p in running if p.returncode is None]
    for part in parts:
        results.update(load_results(part))
        os.remove(part)
    save_results(args.out, results)
    return next((rc for rc in rcs if rc), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true", help="every arch and cell (the default without --arch)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS))
    ap.add_argument("--jobs", type=int, default=2,
                    help="child processes at once (one a mesh and arch; 1 with one mesh: this process)")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == JAX_RESULTS:
        ap.error(f"--out {args.out}: the JAX dry run's file; the port writes dryrun_torch.json")
    if args.mesh == "both" or args.jobs > 1:
        rc = _children(args)  # one fake group a process
        if rc:
            return rc
    else:
        _one_mesh(args, args.mesh == "multipod")
    results = load_results(args.out)
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"done: {n_ok}/{len(results)} cells ok -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
