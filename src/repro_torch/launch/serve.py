"""Continuous-batching serving launcher: replay a request arrival stream
through :class:`repro_torch.serve.engine.ServeEngine` and report latency and
throughput (port of ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch deepseek-7b --requests 8 \
        --slots 4 --prompt-len 32 --new 16 --max-len 128

runs full width on the card (``--device cuda --backend cuda``, the
defaults; deepseek-7b's ReLU-gated variant takes ``--activation relu``).
``--geometry auto`` resolves each call site's tile geometry and grid family
from the port's TuningDB (``TUNING_db_torch.json``, written by ``python -m
repro_torch.tune``; ``$REPRO_TORCH_TUNING_DB`` names another file), keyed
to the card.
``--smoke --device cpu --backend reference`` runs the reduced config on the
CPU.  Weights are drawn from ``--seed``.  ``--rate`` requests/second shapes
the arrival stream (0 = all at t=0); prompt lengths and decode budgets are
jittered per request so slots finish at different times and backfill.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch import runtime as rtm
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import model as M
from repro_torch.models.common import init_params
from repro_torch.serve.engine import QueueFull, ServeEngine


def _pct(xs, q):
    """Percentile, or ``None`` for an empty sample."""
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else None


def _ms(x):
    return f"{x * 1e3:.0f}ms" if x is not None else "n/a"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--activation", default=None,
                    help="override the config's FFN activation (relu takes the fused sparse path)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8,
                    help="concurrent batch slots (the packed decode batch)")
    ap.add_argument("--chunk", type=int, default=8, help="decode steps per chunk")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="arrival rate, requests/sec (0 = all at t=0)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="cuda", choices=rtm.available_backends())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--block", type=int, nargs=3, metavar=("BM", "BK", "BN"),
                    default=None, help="block geometry override")
    ap.add_argument("--geometry", default="explicit", choices=rtm.GEOMETRIES,
                    help="'auto' resolves tile geometry / grid family per call site "
                         "from the TuningDB (python -m repro_torch.tune)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    if args.activation:
        cfg = dataclasses.replace(cfg, activation=args.activation)
    geom = dict(zip(("bm", "bk", "bn"), args.block)) if args.block else {}
    rt = rtm.Runtime(backend=args.backend, device=args.device, geometry=args.geometry, **geom)
    rt.kernel.check_platform()  # fail fast (e.g. cuda without a card)

    params = init_params(M.param_specs(cfg), seed=args.seed, dtype=torch.bfloat16, device=rt.device)
    rng = np.random.default_rng(args.seed)
    plens = rng.integers(max(args.prompt_len // 2, 1), args.prompt_len + 1, size=args.requests)
    budgets = rng.integers(max(args.new // 2, 1), args.new + 1, size=args.requests)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(s)) for s in plens]
    arrivals = (np.zeros(args.requests) if args.rate <= 0
                else np.cumsum(rng.exponential(1.0 / args.rate, size=args.requests)))

    eng = ServeEngine(
        params, cfg, slots=args.slots, max_len=args.max_len or (args.prompt_len + args.new),
        rt=rt, temperature=args.temperature, seed=args.seed, chunk=args.chunk,
    )
    arrivals = arrivals + eng.now()
    t_start = time.monotonic()
    submitted = 0
    while submitted < args.requests or eng.sched.has_work:
        now = eng.now()
        while submitted < args.requests and arrivals[submitted] <= now:
            try:
                eng.submit(prompts[submitted], max_new=int(budgets[submitted]),
                           arrival=float(arrivals[submitted]))
                submitted += 1
            except QueueFull:
                break
        if not eng.sched.has_work:
            time.sleep(min(max(arrivals[submitted] - now, 0.0), 0.05))
            continue
        eng.step()
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    dt = time.monotonic() - t_start

    reqs = list(eng._requests.values())
    ok = [r for r in reqs if r.ok]
    ttft = [r.t_first - r.arrival for r in reqs if r.t_first > 0.0]
    e2e = [r.t_finish - r.arrival for r in ok]
    st = eng.stats()
    pc = st["plan_cache"]
    where = torch.cuda.get_device_name(rt.device) if rt.device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} backend={rt.backend} device={where} slots={args.slots} "
          f"chunk={args.chunk} requests={args.requests}")
    print(f"served {st['tokens_out']} tokens in {dt:.2f}s "
          f"({st['tokens_out']/dt:.1f} tok/s); {st['decode_chunks']} decode chunks")
    print(f"latency  ttft p50={_ms(_pct(ttft,50))} p95={_ms(_pct(ttft,95))}"
          f"   e2e p50={_ms(_pct(e2e,50))} p95={_ms(_pct(e2e,95))}")
    reasons: dict[str, int] = {}
    for r in reqs:
        key = r.finish_reason or "unfinished"
        reasons[key] = reasons.get(key, 0) + 1
    print("finish reasons: " + ", ".join(f"{k}={v}" for k, v in sorted(reasons.items())))
    print(f"plan cache: {pc['hits']} hits / {pc['misses']} misses")
    for ps in rt.plan_cache.plan_stats():
        print(f"  plan key={ps['key']!r} side={ps['side']} "
              f"shape={tuple(ps['shape'])} block={ps['block']} "
              f"total_work={ps['total_work']}/{ps['blocks']} blocks "
              f"skipped={ps['skipped_fraction']:.0%}")
    if rt._db is not None:
        ts = rt.tuning_db.stats()
        print(f"tuning db: {rt.tuning_db.path or '(none found)'} platform={ts['platform']!r} "
              f"entries={ts['entries']} hits={ts['hits']} misses={ts['misses']}")
    if not ok:
        print("ERROR: no request finished cleanly", file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
