"""Where a decode step's time goes on the card.

    python -m repro_torch.launch.profile_decode --arch deepseek-7b --activation relu

Fills ``--slots`` slots of a :class:`~repro_torch.serve.engine.ServeEngine`
(bf16, seeded random weights, ``cuda`` backend), runs one warm-up step, times
``--steps`` engine steps (``--chunk`` decode steps each) untraced, then
traces as many with ``torch.profiler`` and prints the wall time per decode
step (untraced and traced), the device's busy time per decode step (the sum
of kernel times), its idle share, the kernels that take the most device time
and the host-side ops that take the most host time.
Needs a CUDA card; it does not fall back to the CPU.
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


def _device_us(evt) -> float:
    """Self device time of a profiler row (the attribute was renamed across
    PyTorch releases)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--activation", default=None)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2, help="engine steps traced")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    rt = rtm.Runtime(backend="cuda", device="cuda")
    rt.kernel.check_platform()
    cfg = get_config(args.arch)
    if args.activation:
        cfg = dataclasses.replace(cfg, activation=args.activation)
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device=rt.device)
    new = args.chunk * (2 * args.steps + 1) + 1
    eng = ServeEngine(params, cfg, slots=args.slots, chunk=args.chunk,
                      max_len=PROMPT_LEN + new, rt=rt)
    gen = torch.Generator().manual_seed(0)
    for _ in range(args.slots):
        eng.submit(torch.randint(0, cfg.vocab_size, (PROMPT_LEN,), generator=gen), max_new=new)
    eng.step()  # admission (prefill) + one warm-up chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = args.steps * args.chunk
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(((e.key, _device_us(e), e.count) for e in prof.key_averages()
                      if getattr(e, "device_type", None) == cuda and _device_us(e) > 0),
                     key=lambda r: -r[1])
    busy_us = sum(us for _, us, _ in kernels)
    name = torch.cuda.get_device_name(rt.device)
    print(f"device={name} arch={cfg.name} activation={cfg.activation} slots={args.slots} "
          f"decode steps traced={steps}")
    print(f"wall (untraced) {untraced / steps * 1e3:.3f} ms per decode step; wall (traced) "
          f"{wall / steps * 1e3:.3f} ms per decode step; device busy "
          f"{busy_us / steps / 1e3:.3f} ms per decode step; idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}")
    print(f"{'kernel':<72} {'ms/step':>9} {'calls/step':>10} {'share':>6}")
    for key, us, count in kernels[: args.top]:
        print(f"{key[:72]:<72} {us / steps / 1e3:>9.4f} {count / steps:>10.1f} "
              f"{us / busy_us:>6.1%}")
    cpu = torch.autograd.DeviceType.CPU
    host = sorted(((e.key, float(e.self_cpu_time_total), e.count) for e in prof.key_averages()
                   if getattr(e, "device_type", None) == cpu), key=lambda r: -r[1])
    launches = sum(count for _, _, count in kernels)
    print(f"host: {launches / steps:.0f} device kernels and copies launched per decode step; "
          f"{sum(c for _, _, c in host) / steps:.0f} host ops per decode step")
    print(f"{'host op':<72} {'ms/step':>9} {'calls/step':>10}")
    for key, us, count in host[: args.top]:
        print(f"{key[:72]:<72} {us / steps / 1e3:>9.4f} {count / steps:>10.1f}")


if __name__ == "__main__":
    main()
