"""Convert the JAX package's parameters into the port's.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), with per-layer weights
stacked along a leading ``[n_layers, ...]`` axis (a hybrid config's along
``[n_groups, attn_every, ...]``), and returns the port's parameter dict
with one dict per layer.  bfloat16 leaves arrive as numpy's
``bfloat16`` extension dtype, which ``torch.from_numpy`` cannot read; they go
through float32, which holds every bfloat16 value exactly.  The port's own
``init_params(specs, seed=s)`` already equals ``params_from_jax`` of JAX's
``init_params(specs, PRNGKey(s))``; converting is for weights JAX trained or
loaded.
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


def _unstack(tree, n: int, what: str) -> list:
    """The ``n`` slices of a stacked ``[n, ...]`` tree, one dict each."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if leaf.shape[0] != n:
        raise ValueError(f"{leaf.shape[0]} stacked {what}, config says {n}")
    return [_map(lambda x, i=i: x[i].clone(), tree) for i in range(n)]


def params_from_jax(tree, cfg: ModelConfig, *, device="cpu") -> dict:
    """The port's parameters from the JAX parameter pytree of any family.

    Each stacked layer stack (``layers``, and a MoE config's
    ``dense_layers``) becomes a list of per-layer dicts, whatever the
    layer's leaves (GQA's ``wq``/``wk``/``wv``/``wo``, MLA's ``wq_a``,
    ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``, an SSM
    layer's ``ln`` and ``ssm``).  A hybrid config's ``groups``, stacked
    ``[n_groups, attn_every, ...]``, becomes a list of ``n_groups`` lists
    of ``attn_every`` layer dicts; its ``shared`` block is taken as it is.
    Every leaf keeps its dtype (the MoE router its fp32); expert weights
    stay ``[E, ...]``.  A frontend config's tree has no ``embed`` and the
    audio frontend's ``lm_head`` is ``[num_codebooks, d, v]``, kept as it
    is."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported")
    convert = lambda t: _map(lambda x: tensor_from_numpy(x, device), t)
    out = {} if cfg.frontend is not None else {"embed": tensor_from_numpy(tree["embed"], device)}
    if cfg.family == "hybrid":
        n_groups = cfg.num_layers // cfg.attn_every
        out["groups"] = [_unstack(g, cfg.attn_every, "layers in a group")
                         for g in _unstack(convert(tree["groups"]), n_groups, "groups")]
        out["shared"] = convert(tree["shared"])
    else:
        n_dense = cfg.first_dense_layers if cfg.family == "moe" else 0
        want = {"layers": cfg.num_layers - n_dense, "dense_layers": n_dense}
        for stack in ("layers", "dense_layers"):
            if stack not in tree:
                if want[stack]:
                    raise ValueError(f"no {stack!r} stack, config says {want[stack]} layers")
                continue
            out[stack] = _unstack(convert(tree[stack]), want[stack], stack)
    out["final_norm"] = tensor_from_numpy(tree["final_norm"], device)
    out["lm_head"] = tensor_from_numpy(tree["lm_head"], device)
    return out
