"""Where a decode step's time goes on the card: the eager chunk against the
CUDA graph.

    python -m repro_torch.launch.profile_decode --arch deepseek-7b --activation relu
    python -m repro_torch.launch.profile_decode --arch qwen3-moe-235b-a22b --activation relu --layers 8
    python -m repro_torch.launch.profile_decode --arch deepseek-v2-236b --activation relu --layers 6
    python -m repro_torch.launch.profile_decode --arch mamba2-780m
    python -m repro_torch.launch.profile_decode --arch zamba2-2.7b
    python -m repro_torch.launch.profile_decode --arch starcoder2-3b
    python -m repro_torch.launch.profile_decode --arch gemma2-2b --activation relu
    python -m repro_torch.launch.profile_decode --arch deepseek-7b --activation relu --temperatures 0,0.8

Builds bf16 weights from seed 0 once, then, one after the other, two
:class:`~repro_torch.serve.engine.ServeEngine`\\ s on the ``cuda`` backend
over the same ``--slots`` prompts: one running the decode chunk eagerly
(``cuda_graph=False``), one replaying it as one CUDA graph;
``--temperatures`` runs the pair at each temperature given (0, the
default, is greedy; above it the engine samples).  ``--layers``
cuts the config's depth, for a model whose weights do not fit the card
(qwen3-moe-235b-a22b's 94 layers need ~467 GB, deepseek-v2-236b's 60
~471 GB); a dense first block stays (deepseek-v2 at 6 layers: 1 dense, 5
MoE), and a hybrid config takes a multiple of its ``attn_every`` (whole
groups: the shared block runs once per group).  Each engine
runs two warm-up steps (admission and the eager chunk; the graph's capture),
timed, then times ``--steps`` engine steps (``--chunk`` decode steps each) untraced,
then traces as many with ``torch.profiler`` and prints the wall time per
decode step (untraced and traced), the device's busy time per decode step
(the sum of kernel times), its idle share, the device launches per decode
step (every kernel row of the trace: a kernel replayed inside the graph
counts as a launch), the kernels that take the most device time and the
host-side ops that take the most host time; last, what the capture step
costs over the eager engine's second step and from which chunk on the
graph's engine is ahead, untraced.  Where the trace shows less
than half the eager chunk's kernels for the graph, it says that the
profiler did not see the graph's kernels.  Needs a CUDA card; it does not
fall back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import runtime as rtm
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.common import init_params
from repro_torch.serve.engine import ServeEngine

PROMPT_LEN = 32  # prompt tokens per slot (weights and prompts drawn from seed 0)
WARMUP_STEPS = 2  # engine steps before timing: the eager warm-up chunk, then the capture


def _device_us(evt) -> float:
    """Self device time of a profiler row (the attribute was renamed across
    PyTorch releases)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_engine(params, cfg, rt, prompts, *, slots: int, chunk: int, steps: int,
                   cuda_graph: bool, temperature: float = 0.0) -> dict:
    """Warm up, time and trace ``steps`` engine steps of a fresh engine."""
    new = chunk * (WARMUP_STEPS + 2 * steps) + 1
    eng = ServeEngine(params, cfg, slots=slots, chunk=chunk, max_len=PROMPT_LEN + new, rt=rt,
                      temperature=temperature, cuda_graph=cuda_graph)
    for p in prompts:
        eng.submit(p, max_new=new)
    warm = []  # seconds of each warm-up step
    for _ in range(WARMUP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = steps * chunk
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    rows = prof.key_averages()
    kernels = sorted(((e.key, _device_us(e), e.count) for e in rows
                      if getattr(e, "device_type", None) == cuda and _device_us(e) > 0),
                     key=lambda r: -r[1])
    host = sorted(((e.key, float(e.self_cpu_time_total), e.count) for e in rows
                   if getattr(e, "device_type", None) == cpu), key=lambda r: -r[1])
    busy_us = sum(us for _, us, _ in kernels)
    st = eng.stats()
    return {
        "decode_steps": n, "untraced_ms": untraced / n * 1e3, "traced_ms": wall / n * 1e3,
        "busy_ms": busy_us / n / 1e3, "idle_share": 1 - busy_us / 1e6 / wall,
        "launches": sum(c for _, _, c in kernels) / n, "host_ops": sum(c for _, _, c in host) / n,
        "kernels": kernels, "host": host, "captures": st["decode_graph_captures"],
        "replays": st["decode_graph_replays"], "warm_s": warm,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--activation", default=None)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2, help="engine steps timed, then as many traced")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--layers", type=int, default=None, help="cut the config to this many layers")
    ap.add_argument("--temperatures", default="0", help="comma-separated; 0 is greedy")
    args = ap.parse_args(argv)
    temps = [float(t) for t in args.temperatures.split(",")]

    cfg = get_config(args.arch)
    if args.activation:
        cfg = dataclasses.replace(cfg, activation=args.activation)
    if args.layers:
        if cfg.family == "hybrid" and args.layers % cfg.attn_every:
            raise ValueError(f"--layers {args.layers}: {cfg.name} runs whole groups of "
                             f"{cfg.attn_every} layers; give a multiple of {cfg.attn_every}")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    rt = rtm.Runtime(backend="cuda", device="cuda")
    rt.kernel.check_platform()
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device=rt.device)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (PROMPT_LEN,), generator=gen) for _ in range(args.slots)]
    name = torch.cuda.get_device_name(rt.device)
    print(f"device={name} arch={cfg.name} layers={cfg.num_layers} activation={cfg.activation} slots={args.slots} "
          f"chunk={args.chunk} decode steps timed={args.steps * args.chunk}, then as many traced")
    for t in temps:
        _profile_pair(params, cfg, rt, prompts, args, t)


def _profile_pair(params, cfg, rt, prompts, args, temperature: float) -> None:
    """Profile an eager and a graph engine at ``temperature`` and print each
    one's lines (labelled with the temperature when it samples), then what
    the capture costs and when the graph is ahead."""
    res = {}
    for mode in ("eager", "graph"):
        label = mode if temperature == 0.0 else f"{mode} t={temperature}"
        r = res[mode] = profile_engine(params, cfg, rt, prompts, slots=args.slots, chunk=args.chunk,
                                       steps=args.steps, cuda_graph=mode == "graph", temperature=temperature)
        print(f"[{label}] wall (untraced) {r['untraced_ms']:.3f} ms per decode step; wall (traced) "
              f"{r['traced_ms']:.3f} ms per decode step; device busy {r['busy_ms']:.3f} ms per decode "
              f"step; idle share {r['idle_share']:.3f}; {r['launches']:.0f} device launches and "
              f"{r['host_ops']:.0f} host ops per decode step; graph captures {r['captures']}, "
              f"replays {r['replays']}")
        print(f"[{label}] {'kernel':<72} {'ms/step':>9} {'calls/step':>10} {'share':>6}")
        for key, us, count in r["kernels"][: args.top]:
            print(f"[{label}] {key[:72]:<72} {us / r['decode_steps'] / 1e3:>9.4f} "
                  f"{count / r['decode_steps']:>10.1f} {us / max(r['busy_ms'] * r['decode_steps'] * 1e3, 1e-9):>6.1%}")
        print(f"[{label}] {'host op':<72} {'ms/step':>9} {'calls/step':>10}")
        for key, us, count in r["host"][: args.top]:
            print(f"[{label}] {key[:72]:<72} {us / r['decode_steps'] / 1e3:>9.4f} "
                  f"{count / r['decode_steps']:>10.1f}")
    # the second warm-up step is an eager chunk for one engine and the
    # capture (with its first replay) for the other; the first steps (the
    # prefill, an eager chunk each) are left out: the first engine's also
    # builds and loads the kernels
    extra = res["graph"]["warm_s"][1] - res["eager"]["warm_s"][1]
    saving = (res["eager"]["untraced_ms"] - res["graph"]["untraced_ms"]) * args.chunk / 1e3
    ahead = f"from its chunk {WARMUP_STEPS + 1 + int(max(extra, 0.0) // saving)} on" if saving > 0 else "never"
    tag = "graph/eager" if temperature == 0.0 else f"graph/eager t={temperature}"
    print(f"[{tag}] capture step {res['graph']['warm_s'][1]:.3f} s, the eager engine's second step "
          f"{res['eager']['warm_s'][1]:.3f} s ({extra:+.3f} s); a replayed chunk saves {saving:.3f} s "
          f"untraced; the graph engine is ahead {ahead}")
    if res["graph"]["launches"] < res["eager"]["launches"] / 2:
        print(f"note: the profiler saw {res['graph']['launches']:.0f} kernels per decode step under the graph "
              f"against {res['eager']['launches']:.0f} eager: it does not see every kernel of a graph replay, "
              "so the graph's busy time and idle share are not measured")


if __name__ == "__main__":
    main()
