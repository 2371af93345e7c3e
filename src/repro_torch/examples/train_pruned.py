"""Training-time pruning amplifies TensorDash (paper §4: resnet50_DS90/SM90),
on the port (counterpart of ``examples/train_pruned.py``).

Trains a tiny LM while gradually magnitude-pruning to a target sparsity
(Zhu-Gupta cubic ramp, masks refreshed so weights can regrow — dynamic
sparse reparameterization).  After each refresh the *measured* weight
sparsity drives the TensorDash perf model (the tile kernel on the card),
and the scheduled-form codec (paper §3.6, the schedule kernel on the card)
shows the matching checkpoint-footprint shrink.

  PYTHONPATH=src python -m repro_torch.examples.train_pruned --steps 60 --target 0.9
  PYTHONPATH=src python -m repro_torch.examples.train_pruned --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import runtime as rtm
from repro_torch.checkpoint.codec import compressed_bytes, encode
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.perf_model import ConvLayer, simulate_conv
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.examples import add_device_flag, default_backend
from repro_torch.models import model as M
from repro_torch.models.common import init_params
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.optim.sparsify import PruneState, apply_masks, init_prune, prune_schedule, refresh_masks
from repro_torch.sparse_train.masks import stacked_leaves
from repro_torch.train.step import make_train_step


def init_model(cfg, device) -> dict:
    """The initial parameters: bf16 from seed 0 on ``device``."""
    return init_params(M.param_specs(cfg), seed=0, device=device)


def stacked(params) -> dict:
    """``{JAX path: tensor}`` with each per-layer leaf stacked over the layers,
    the JAX package's layout, in which one magnitude cut spans every layer."""
    return {path: torch.stack(leaf.leaves) if leaf.stacked else leaf.leaves[0]
            for path, leaf in stacked_leaves(params).items()}


def prune_stacked(params, sparsity) -> PruneState:
    """``refresh_masks`` over the stacked leaves, then each layer's slice of
    its mask applied to that layer's leaf in place: the JAX example's
    ``refresh_masks`` + ``apply_masks`` on its stacked tree."""
    leaves, whole = stacked_leaves(params), stacked(params)
    state = refresh_masks(whole, sparsity)
    masked = apply_masks(whole, state)
    with torch.no_grad():
        for path, leaf in leaves.items():
            for i, t in enumerate(leaf.leaves):
                t.copy_(masked[path][i] if leaf.stacked else masked[path])
    return state


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--target", type=float, default=0.9)
    ap.add_argument("--refresh-every", type=int, default=10)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = reduce_config(get_config("deepseek-7b"))
    data = SyntheticLM(cfg.vocab_size, 32, 8, seed=11)
    params = init_model(cfg, dev)
    opt = init_opt_state(params)
    prune = init_prune(params)
    rt = rtm.Runtime(backend=default_backend(dev), device=dev)
    with rt.use():
        step_fn = make_train_step(cfg, OptConfig(lr=2e-3, warmup_steps=5, total_steps=args.steps))

    print("step  loss   weight-sparsity  TensorDash-proj  ckpt-codec")
    rows = []
    for i in range(args.steps):
        with rt.use():
            params, opt, m = step_fn(params, opt, data.batch_at(i, device=dev))
        if (i + 1) % args.refresh_every == 0:
            target_now = float(prune_schedule(i, args.target, 0, args.steps))
            prune = prune_stacked(params, target_now)
            w = torch.stack([layer["mlp"]["w_gate"] for layer in params["layers"]])
            frac = float((w == 0).float().mean())
            proj = simulate_conv(
                ConvLayer("ffn", cfg.d_model, 1, 1, cfg.d_ff, 1, 1),
                sparsity=frac, sample_groups=1, max_t=32, seed=i, device=dev,
            )
            enc = encode(w.reshape(-1, w.shape[-1]), device=dev)
            ratio = compressed_bytes(enc) / (w.numel() * w.element_size())
            rows.append({"step": i + 1, "loss": float(m["loss"]), "sparsity": frac,
                         "projection": proj.speedup, "codec_ratio": ratio})
            print(
                f"{i+1:4d}  {rows[-1]['loss']:5.2f}   {frac:8.1%}        "
                f"{proj.speedup:4.2f}x         {ratio:5.1%} of dense"
            )
    print("\nPaper: pruned-to-90% models sustain ~1.8-2.3x on the weight-side"
          " stream; the codec shrinks footprints in step with sparsity.")
    return {"rows": rows, "masks": prune.masks}


if __name__ == "__main__":
    main()
