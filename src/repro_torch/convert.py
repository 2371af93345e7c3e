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
    """The port's parameters from the JAX dense- or MoE-family parameter
    pytree: each stacked layer stack (``layers``, and a MoE config's
    ``dense_layers``) becomes a list of per-layer dicts, whatever the
    attention's leaves (GQA's ``wq``/``wk``/``wv``/``wo``, MLA's ``wq_a``,
    ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``).  Every
    leaf keeps its dtype (the MoE router its fp32); expert weights stay
    ``[E, ...]``."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported (dense and moe only)")
    n_dense = cfg.first_dense_layers if cfg.family == "moe" else 0
    want = {"layers": cfg.num_layers - n_dense, "dense_layers": n_dense}
    out = {"embed": tensor_from_numpy(tree["embed"], device)}
    for stack in ("layers", "dense_layers"):
        if stack not in tree:
            if want[stack]:
                raise ValueError(f"no {stack!r} stack, config says {want[stack]} layers")
            continue
        stacked = _map(lambda x: tensor_from_numpy(x, device), tree[stack])
        n = stacked["ln1"].shape[0]
        if n != want[stack]:
            raise ValueError(f"{n} stacked {stack}, config says {want[stack]}")
        out[stack] = [_map(lambda x, i=i: x[i].clone(), stacked) for i in range(n)]
    out["final_norm"] = tensor_from_numpy(tree["final_norm"], device)
    out["lm_head"] = tensor_from_numpy(tree["lm_head"], device)
    return out
