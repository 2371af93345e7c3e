"""Continuous-batching serving example on the port (counterpart of
``examples/serve_batched.py``): a request stream with mixed prompt lengths
and decode budgets through a fixed-capacity slot array.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch qwen3-4b \\
      --requests 8 --slots 4 --backend cuda
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu --backend reference

Execution policy (kernel backend, block geometry, plan cache) is one
``repro_torch.runtime.Runtime``.  On the card under greedy decoding the
decode chunk is captured once as a CUDA graph and replayed as the scheduler
admits, finishes and backfills requests (the JAX engine's one trace of its
jitted chunk; a sampled chunk runs eagerly, and so does every chunk on the
CPU).  Under a sparse backend the LM-head SparsityPlan is computed at the
first prefill and replayed (cache hits) by every later prefill and decode
step.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import runtime as rtm
from repro_torch.configs import get_config, reduce_config
from repro_torch.examples import add_device_flag
from repro_torch.models import model as M
from repro_torch.models.common import init_params
from repro_torch.serve.engine import ServeEngine


def init_model(cfg, device) -> dict:
    """The served parameters: bf16 from seed 0 on ``device``."""
    return init_params(M.param_specs(cfg), seed=0, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--backend", default="dense", choices=rtm.available_backends())
    add_device_flag(ap)
    args = ap.parse_args(argv)

    cfg = reduce_config(get_config(args.arch))  # the JAX example's reduced config
    # lint: allow-hand-geometry: the JAX example's blocks, so its plan-cache line is comparable
    rt = rtm.Runtime(backend=args.backend, device=args.device, bm=args.slots, bk=16, bn=16)
    params = init_model(cfg, rt.device)
    rng = np.random.default_rng(1)

    eng = ServeEngine(
        params, cfg, slots=args.slots, max_len=args.prompt_len + args.new,
        rt=rt, temperature=args.temperature, chunk=args.chunk,
    )
    where = torch.cuda.get_device_name(rt.device) if rt.device.type == "cuda" else "the CPU"
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    t0 = time.time()
    rids, budgets = [], {}
    for _ in range(args.requests):
        plen = int(rng.integers(max(args.prompt_len // 2, 1), args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        budget = int(rng.integers(2, args.new + 1))
        rid = eng.submit(prompt, max_new=budget)
        rids.append(rid)
        budgets[rid] = budget
    out = eng.run()
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    dt = time.time() - t0

    st = eng.stats()
    print(f"arch={cfg.name} slots={args.slots} requests={args.requests}")
    print(f"served {st['tokens_out']} tokens in {dt:.2f}s "
          f"({st['tokens_out']/dt:.1f} tok/s on {where}); "
          f"decode program traced {st['decode_graph_captures']}x for {st['chunks_run']} chunks")
    pc = st["plan_cache"]
    print(f"backend={rt.backend} plan cache: {pc['hits']} hits / "
          f"{pc['misses']} misses / 0 traced-in-program")
    for rid in rids[: min(len(rids), 2)]:
        print(f"  req{rid}: {out[rid]}")
    return {"tokens": out, "budgets": budgets, "stats": st}


if __name__ == "__main__":
    main()
