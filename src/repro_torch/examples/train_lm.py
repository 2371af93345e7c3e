"""End-to-end LM training driver on the port (counterpart of
``examples/train_lm.py``).

Default preset is a ~100M-param decoder; ``--preset tiny`` runs the same
pipeline in seconds.  Includes checkpointing, resume, preemption guard, and
the live TensorDash sparsity projection of the FFN activations.  On the card
the train step's planned products run on the SpMM and planner kernels and
the projection on the tile kernel; ``--device cpu`` runs their plain
versions.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset tiny --steps 30 --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300 --relu-ffn
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import runtime as rtm
from repro_torch.checkpoint.manager import PreemptionGuard, latest_step, restore, save
from repro_torch.configs.base import ModelConfig
from repro_torch.core.perf_model import ConvLayer, simulate_conv
from repro_torch.core.sparsity import measure
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.examples import add_device_flag, default_backend
from repro_torch.models import model as M
from repro_torch.models.common import init_params, silu
from repro_torch.optim.adamw import OptConfig, init_opt_state, tree_leaves
from repro_torch.train.step import make_train_step

PRESETS = {
    "tiny": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                 d_ff=128, vocab_size=512, seq=32, batch=8),
    "100m": dict(num_layers=10, d_model=640, num_heads=10, num_kv_heads=10, head_dim=64,
                 d_ff=2560, vocab_size=50304, seq=256, batch=8),
}


def init_model(cfg, device) -> dict:
    """The initial parameters: bf16 from seed 0 on ``device``."""
    return init_params(M.param_specs(cfg), seed=0, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--relu-ffn", action="store_true",
                    help="squared-relu FFN: natural TensorDash sparsity")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    p = PRESETS[args.preset]
    dev = torch.device(args.device)

    cfg = ModelConfig(
        name=f"lm-{args.preset}", family="dense",
        num_layers=p["num_layers"], d_model=p["d_model"], num_heads=p["num_heads"],
        num_kv_heads=p["num_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab_size=p["vocab_size"], activation="relu" if args.relu_ffn else "silu",
        remat=False, q_chunk=p["seq"],
    )
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=p["seq"], global_batch=p["batch"])
    ocfg = OptConfig(lr=3e-4, warmup_steps=20, total_steps=max(args.steps, 100))
    rt = rtm.Runtime(backend=default_backend(dev), device=dev)
    with rt.use():
        step_fn = make_train_step(cfg, ocfg)
    guard = PreemptionGuard()

    start = latest_step(args.ckpt_dir)
    resumed = start
    if start is not None:
        print(f"resuming from checkpoint step {start}")
        params = init_model(cfg, dev)
        opt = init_opt_state(params)
        state = restore(args.ckpt_dir, start, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
    else:
        start = 0
        params = init_model(cfg, dev)
        opt = init_opt_state(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {n_params/1e6:.1f}M params | preset={args.preset}")

    history = []
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            with rt.use():
                params, opt, m = step_fn(params, opt, data.batch_at(i, device=dev))
            history.append({"step": i + 1, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                            "lr": float(m["lr"])})
            if (i + 1) % 10 == 0 or i == start:
                dt = (time.time() - t0) / max(i - start + 1, 1)
                print(f"step {i+1:5d}  loss {history[-1]['loss']:.4f}  gnorm {history[-1]['grad_norm']:.2f}"
                      f"  lr {history[-1]['lr']:.2e}  {dt:.2f}s/step")
            if (i + 1) % args.ckpt_every == 0 or guard.should_save:
                save(args.ckpt_dir, i + 1, {"params": params, "opt": opt})
                if guard.should_save:
                    print("preemption signal: checkpoint saved, exiting")
                    return {"history": history, "resumed_from": resumed, "preempted": True}
    finally:
        guard.close()

    # TensorDash projection from measured FFN activation sparsity
    batch = data.batch_at(args.steps, device=dev)
    with torch.no_grad():
        emb = params["embed"][batch["tokens"].long()]
        mlp = params["layers"][0]["mlp"]
        w = mlp["w_gate"] if "w_gate" in mlp else mlp["w_up"]
        h = emb.reshape(-1, cfg.d_model) @ w
        h = torch.square(torch.maximum(h, torch.zeros((), dtype=h.dtype, device=h.device))) if args.relu_ffn \
            else silu(h)
        frac = float(measure(torch.where(torch.abs(h) < 1e-8, torch.zeros_like(h), h)).fraction)
    proj = simulate_conv(ConvLayer("ffn", cfg.d_model, 1, 1, cfg.d_ff, 1, 1),
                         sparsity=frac, sample_groups=1, max_t=48, device=dev)
    print(f"FFN activation sparsity {frac:.1%} -> TensorDash projection {proj.speedup:.2f}x"
          f" ({'natural (ReLU)' if args.relu_ffn else 'smooth activation: use pruning/PACT to induce'})")
    return {"history": history, "resumed_from": resumed, "preempted": False, "ffn_sparsity": frac,
            "projection": proj.speedup}


if __name__ == "__main__":
    main()
