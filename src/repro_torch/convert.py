"""Convert the JAX package's parameters into the port's.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), with per-layer weights
stacked along a leading ``[n_layers, ...]`` axis, and returns the port's
parameter dict with one dict per layer.  bfloat16 leaves arrive as numpy's
``bfloat16`` extension dtype, which ``torch.from_numpy`` cannot read; they go
through float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

def tensor_from_numpy(x, device="cpu") -> torch.Tensor:
    """One numpy leaf as a tensor of the same dtype on ``device``."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32, order="C")).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True, order="C")).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree, cfg: ModelConfig, *, device="cpu") -> dict:
    """The port's parameters from the JAX dense-family parameter pytree."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported (dense only)")
    stacked = _map(lambda x: tensor_from_numpy(x, device), tree["layers"])
    n = stacked["ln1"].shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"{n} stacked layers, config says {cfg.num_layers}")
    return {
        "embed": tensor_from_numpy(tree["embed"], device),
        "layers": [_map(lambda x, i=i: x[i].clone(), stacked) for i in range(n)],
        "final_norm": tensor_from_numpy(tree["final_norm"], device),
        "lm_head": tensor_from_numpy(tree["lm_head"], device),
    }
