"""Training launcher (port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-4b --steps 20 \
        --ckpt-dir /path/to/ckpt

runs the full config on the card (``--device cuda --backend cuda``, the
defaults); ``--smoke --device cpu --backend reference`` runs the reduced
config on the CPU through the same loop: checkpointing, preemption guard,
straggler deadline, TensorDash sparsity taps, dynamic sparse training.
Weights are drawn from seed 0, data from ``SyntheticLM``.

Resilience: the step is non-finite-guarded (``make_train_step(
guard_nonfinite=True)``) — a NaN/Inf loss or gradient skips the update,
backs off exponentially, and after ``--max-faults`` *consecutive* faulted
steps checkpoints-before-abort (exit code 3).  ``--inject-faults`` replays
a seeded :class:`repro_torch.resilience.FaultPlan` (``nan_loss@3;
step_stall@5:secs=1`` ...) through the production loop, and every
degradation — skip-step, straggler abort, preemption save, corrupt-
checkpoint skip — is surfaced in the :class:`repro_torch.resilience.
ResilienceLog` summary.

Under a process group of more than one rank (``torchrun``, or a group the
caller made) the launcher trains the sharded model on ``make_local_mesh()``
(``(1, world)`` over ``("data", "model")``); ``--multi-pod`` builds the
production mesh ``(2, 16, 16)``, which raises unless the group has its 512
ranks.  On a mesh each rank draws every weight from seed 0 in turn and keeps
only its shard of it, so a card holds its shards and one whole weight at a
time; checkpoints are gathered leaf by leaf to the first rank, which writes
them in the JAX package's format, and are restored onto this mesh's shards;
the per-plan lines carry the ``imbalance`` of each plan's work over the
row-parallel shards (``PlanCache.plan_stats(shards=)``), in the JAX
launcher's format.  ``--dynamic-sparsity`` on a mesh: every rank builds the
controller from the global shapes and refreshes the same global masks from
the step's global scores; checkpoints hold no masks.  Only rank 0 prints.  ``--device`` is the one flag the
JAX launcher lacks.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import runtime as rtm
from repro_torch.checkpoint.manager import PreemptionGuard, restore_latest, save
from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.common import init_params
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.parallel.sharding import ShardingPolicy
from repro_torch.resilience import FaultPlan, ResilienceLog, capture_warnings
from repro_torch.resilience import faults as rfaults
from repro_torch.resilience import log as rlog
from repro_torch.train.step import make_train_step, state_specs

_DST_INT_KEYS = {"update_every", "begin", "end", "t_end", "min_size"}
_DST_FLOAT_KEYS = {"target", "alpha"}


def parse_dynamic_sparsity(spec: str) -> dict:
    """``target=0.9,update_every=100`` -> DynamicSparsityConfig kwargs."""
    kw: dict = {}
    for item in filter(None, (s.strip() for s in spec.split(","))):
        key, sep, val = item.partition("=")
        key = key.strip().replace("-", "_")
        if not sep:
            raise argparse.ArgumentTypeError(
                f"--dynamic-sparsity item {item!r} is not key=value"
            )
        if key in _DST_INT_KEYS:
            kw[key] = int(val)
        elif key in _DST_FLOAT_KEYS:
            kw[key] = float(val)
        elif key == "exclude":
            kw[key] = tuple(filter(None, val.split("+")))
        else:
            raise argparse.ArgumentTypeError(
                f"--dynamic-sparsity key {key!r} unknown (ints: "
                f"{sorted(_DST_INT_KEYS)}, floats: {sorted(_DST_FLOAT_KEYS)}, "
                "exclude=tok+tok)"
            )
    return kw


def _process_group(device: str) -> int:
    """The default process group's size, made from ``torchrun``'s
    environment (``WORLD_SIZE`` > 1) when none exists yet."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if device.startswith("cuda") else "gloo")
    return dist.get_world_size() if dist.is_initialized() else 1


def _agree(seconds: float, preempted: bool, device, world: int) -> tuple[float, bool]:
    """The step's seconds and the preemption flag as every rank of the group
    sees them (the slowest rank's time, any rank's signal), so the ranks
    take the same deadline and checkpoint decisions."""
    if world == 1:
        return seconds, preempted
    buf = torch.tensor([seconds, float(preempted)], dtype=torch.float64, device=device)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX)  # lint: allow-shard-map-axes: every rank of the launch
    return float(buf[0]), bool(buf[1])  # lint: allow-host-sync: host decisions, once a step


def _mesh(args, world: int):
    """The mesh the launcher trains on: the production mesh with
    ``--multi-pod`` (raises on another world size), the local mesh under a
    group of several ranks, none on one."""
    if args.multi_pod:
        return make_production_mesh(multi_pod=True)
    return make_local_mesh() if world > 1 else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--multi-pod", action="store_true",
                    help="train on the production mesh (2, 16, 16): a process group of 512 ranks")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--step-deadline", type=float, default=300.0,
                    help="straggler mitigation: abort+checkpoint if a step "
                         "exceeds this (the first executed step is exempt: "
                         "it pays the kernels' build and first launches)")
    ap.add_argument("--backend", default="cuda", choices=rtm.available_backends(),
                    help="kernel backend for the TensorDash sparse paths")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sparsity-taps", action="store_true",
                    help="record per-layer A/G densities + modeled TensorDash "
                         "speedup every step (paper Fig. 14 live view)")
    ap.add_argument("--dynamic-sparsity", type=parse_dynamic_sparsity,
                    default=None, metavar="KVS",
                    help="RigL dynamic sparse training, e.g. "
                         "'target=0.9,update_every=100' (keys = "
                         "repro_torch.sparse_train.DynamicSparsityConfig fields; "
                         "ramp end defaults to --steps)")
    ap.add_argument("--bm", type=int, default=None, help="block rows (sparse kernels)")
    ap.add_argument("--bk", type=int, default=None, help="contraction block size")
    ap.add_argument("--bn", type=int, default=None, help="output block size")
    ap.add_argument("--geometry", default="explicit", choices=rtm.GEOMETRIES,
                    help="'auto' resolves tile geometry / grid family per "
                         "call site from the TuningDB (python -m repro_torch.tune)")
    ap.add_argument("--inject-faults", default="", metavar="SPEC",
                    help="seeded fault replay, e.g. 'nan_loss@3;step_stall@5:"
                         "secs=1' (repro_torch.resilience.FaultPlan grammar)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--max-faults", type=int, default=3,
                    help="consecutive non-finite steps before checkpoint+abort")
    ap.add_argument("--fault-backoff", type=float, default=0.5,
                    help="base seconds for exponential backoff after a "
                         "skipped (non-finite) step")
    ap.add_argument("--no-nonfinite-guard", action="store_true",
                    help="disable the skip-step guard on non-finite loss/grads")
    args = ap.parse_args(argv)

    world = _process_group(args.device)
    mesh = _mesh(args, world)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    device = args.device
    if device == "cuda" and world > 1:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', dist.get_rank())) % torch.cuda.device_count()}"
    cfg = get_config(args.arch)
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"--arch {cfg.name}: SyntheticLM makes token batches and a {cfg.frontend} frontend "
            "takes inputs_embeds; train it through make_train_step with such batches")
    if args.smoke:
        cfg = reduce_config(cfg)
    cfg = dataclasses.replace(cfg, remat=not args.smoke)
    geom = {k: v for k, v in (("bm", args.bm), ("bk", args.bk), ("bn", args.bn)) if v}
    if args.smoke and not geom and (
        args.backend != "dense" or args.dynamic_sparsity is not None
    ):
        # card-sized blocks don't divide smoke shapes (and would clamp a
        # dynamic-sparsity mask to one block per weight — no granularity)
        geom = {"bm": 8, "bk": 16, "bn": 16}
    policy = ShardingPolicy(mesh=mesh) if mesh is not None else None
    rt = rtm.Runtime(backend=args.backend, device=device,
                     geometry=args.geometry, sharding=policy, **geom)
    rt.kernel.check_platform()  # fail fast (cuda without a card) vs a silent fallback

    log = ResilienceLog()
    fp = FaultPlan.parse(args.inject_faults, seed=args.fault_seed)
    guard_nonfinite = not args.no_nonfinite_guard
    on_card = rt.device.type == "cuda"

    with rt.use(), rlog.use_log(log), rfaults.inject(fp), capture_warnings(log):
        # on a mesh every rank draws the same weights and keeps its shards
        params = init_params(M.param_specs(cfg), seed=0, device=rt.device, policy=policy)
        shardings = state_specs(cfg, policy) if policy is not None else None
        opt = init_opt_state(params)
        data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
        ocfg = OptConfig(total_steps=max(args.steps, 100))
        ctrl = masks = None
        if args.dynamic_sparsity is not None:
            from repro_torch.sparse_train import (
                DynamicSparsityConfig, DynamicSparsityController,
            )

            dkw = dict(args.dynamic_sparsity)
            dkw.setdefault("end", args.steps)
            # on a mesh: the units of the global shapes, the same on every rank
            ctrl = DynamicSparsityController(DynamicSparsityConfig(**dkw), params,
                                             specs=shardings["params"] if shardings else None)
            masks = ctrl.masks()
            say(
                f"dynamic sparsity: {len(ctrl.units)} weight(s), "
                f"target {ctrl.cfg.target:.0%} by step {ctrl.cfg.end}, "
                f"refresh every {ctrl.cfg.update_every}"
            )
        step_fn = make_train_step(
            cfg, ocfg, microbatches=args.microbatches,
            sparsity_taps=args.sparsity_taps, dynamic_sparsity=ctrl,
            guard_nonfinite=guard_nonfinite,
        )
        guard = PreemptionGuard()
        try:
            start = 0
            if args.ckpt_dir:
                s, state = restore_latest(
                    args.ckpt_dir, {"params": params, "opt": opt}, shardings=shardings
                )
                if s is not None:
                    params, opt, start = state["params"], state["opt"], s
                    say(f"resumed at step {s}")

            consecutive_faults = 0
            for i in range(start, args.steps):
                for _ in fp.fires("preempt", i):
                    signal.raise_signal(signal.SIGTERM)
                t0 = time.time()
                rfaults.stall(fp, "step_stall", i)
                kw = {}
                if guard_nonfinite:
                    kw["poison"] = rfaults.train_poison(fp, i)
                params, opt, m = step_fn(params, opt, data.batch_at(i, device=rt.device),
                                         masks, **kw)
                if on_card:
                    torch.cuda.synchronize(rt.device)
                dt, preempted = _agree(time.time() - t0, guard.should_save, rt.device, world)
                if guard_nonfinite and int(m.get("nonfinite", 0)):
                    consecutive_faults += 1
                    log.record("nonfinite", "train.step", "skip-step",
                               step=i, consecutive=consecutive_faults)
                    say(f"step {i}: non-finite loss/grads — update skipped "
                          f"({consecutive_faults}/{args.max_faults} consecutive)")
                    if consecutive_faults >= args.max_faults:
                        if args.ckpt_dir:
                            save(args.ckpt_dir, i + 1,
                                 {"params": params, "opt": opt}, shardings=shardings)
                        log.record("nonfinite", "train.loop", "checkpoint-abort",
                                   step=i, consecutive=consecutive_faults)
                        say(f"{consecutive_faults} consecutive non-finite "
                              "steps: checkpointed, aborting")
                        say(log.summary())
                        sys.exit(3)
                    time.sleep(min(
                        args.fault_backoff * 2 ** (consecutive_faults - 1), 30.0
                    ))
                else:
                    consecutive_faults = 0
                if ctrl is not None and ctrl.should_update(i):
                    rep = ctrl.update(i, m["dst_w_scores"], m["dst_g_scores"])
                    masks = ctrl.masks()
                    say(
                        f"dst refresh step {rep['step']:5d} "
                        f"sparsity {rep['sparsity']:.3f} "
                        f"(target {rep['target_sparsity']:.3f}) "
                        f"pruned {rep['pruned']} regrown {rep['regrown']} "
                        f"plan-edit {rep['edit_ms']:.2f}ms"
                    )
                # the first executed step pays the kernels' build and first
                # launches; a deadline sized for steady-state steps must not
                # count that against it
                if dt > args.step_deadline and i != start:
                    say(f"step {i} exceeded deadline ({dt:.0f}s): checkpoint + abort")
                    log.record("deadline", "train.step", "checkpoint-abort",
                               step=i, seconds=round(dt, 3))
                    if args.ckpt_dir:
                        save(args.ckpt_dir, i + 1, {"params": params, "opt": opt}, shardings=shardings)
                    say(log.summary())
                    return
                if (i + 1) % 5 == 0 or i == start:
                    line = (f"step {i+1:5d} loss {float(m['loss']):.4f} "
                            f"gnorm {float(m['grad_norm']):.2f} {dt:.2f}s")
                    if ctrl is not None:
                        line += f" Wdens={float(m['dst_density']):.2f}"
                    if args.sparsity_taps:
                        from repro_torch.train.step import modeled_speedup

                        sim = modeled_speedup(m, cfg, max_t=64, sample_groups=1)
                        line += (
                            f" A={float(m['A_density'].float().mean()):.2f}"
                            f" G={float(m['G_density'].float().mean()):.2f}"
                            f" ideal={float(m['modeled_speedup']):.2f}x"
                            f" modeled={sim['overall']:.2f}x"
                        )
                    say(line)
                if args.ckpt_dir and ((i + 1) % args.ckpt_every == 0 or preempted):
                    save(args.ckpt_dir, i + 1, {"params": params, "opt": opt}, shardings=shardings)
                    if preempted:
                        log.record("preempt", "train.loop", "checkpoint-exit",
                                   step=i)
                        say("preemption: saved, exiting")
                        say(log.summary())
                        return
        finally:
            guard.close()
    # per-device balance report: how evenly each cached plan's ragged-grid
    # work would deal across the policy's row-parallel shards
    n_shards = policy.spmm_axes("M")[1] if policy is not None else 1
    for ps in rt.plan_cache.plan_stats(shards=n_shards):
        line = (f"plan key={ps['key']!r} side={ps['side']} "
                f"total_work={ps['total_work']}/{ps['blocks']} blocks "
                f"skipped={ps['skipped_fraction']:.0%}")
        if "imbalance" in ps:
            line += f" imbalance={ps['imbalance']:.2f}x over {n_shards} devices"
        say(line)
    if len(log):
        say(log.summary())
    say("done")


if __name__ == "__main__":
    main()
