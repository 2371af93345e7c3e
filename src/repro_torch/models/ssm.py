"""Mamba2 (state-space duality, arXiv:2405.21060) in plain torch (port of
``repro/models/ssm.py``).

Chunked SSD: the sequence is split into chunks; within a chunk the
semiseparable matrix is materialised, across chunks a small ``[H, P, N]``
state is carried by a loop (the JAX version's ``lax.scan``).  The SSD math
runs in fp32 whatever the activation dtype, as in the JAX version.  The
intra-chunk decay masks its exponent before ``exp`` where JAX masks the
exponential after it: the same values, and a finite gradient where JAX's
overflows to NaN (a chunk whose decay passes 88 nats, as the registered
configs' 128-token chunks do at initialisation).

The JAX package has no Pallas kernel here: every product is a plain ``@``,
so the port's are plain torch too, under any runtime.

:func:`ssm_decode` updates its :class:`SSMCache` in place (the JAX version
returns a new one): the conv tails keep the cache's dtype (bf16) and the
state stays fp32, so a serving engine's packed caches and a captured decode
graph see every step's writes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.common import Spec, rms_norm, silu


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_specs(cfg: SSMConfig) -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.num_heads
    gn = cfg.n_groups * cfg.d_state
    w = cfg.conv_width
    return {
        "in_z": Spec((d, di), axes=("embed", "heads")),
        "in_x": Spec((d, di), axes=("embed", "heads")),
        "in_b": Spec((d, gn), axes=("embed", None)),
        "in_c": Spec((d, gn), axes=("embed", None)),
        "in_dt": Spec((d, h), axes=("embed", "heads")),
        "conv_x_w": Spec((w, di), axes=(None, "heads")),
        "conv_x_b": Spec((di,), init="zeros", axes=("heads",)),
        "conv_b_w": Spec((w, gn)),
        "conv_b_b": Spec((gn,), init="zeros"),
        "conv_c_w": Spec((w, gn)),
        "conv_c_b": Spec((gn,), init="zeros"),
        "dt_bias": Spec((h,), init="zeros", axes=("heads",)),
        "a_log": Spec((h,), init="ones", axes=("heads",)),
        "d_skip": Spec((h,), init="ones", axes=("heads",)),
        "norm_w": Spec((di,), init="ones", axes=("heads",)),
        "out_proj": Spec((di, d), axes=("heads", "embed")),
    }


class SSMCache(NamedTuple):
    conv_x: torch.Tensor  # [B, W-1, d_inner]
    conv_b: torch.Tensor  # [B, W-1, G*N]
    conv_c: torch.Tensor  # [B, W-1, G*N]
    state: torch.Tensor  # [B, H, P, N] fp32


def init_ssm_cache(cfg: SSMConfig, batch: int, dtype=torch.bfloat16, device="cpu") -> SSMCache:
    w = cfg.conv_width - 1
    gn = cfg.n_groups * cfg.d_state
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    return SSMCache(
        conv_x=zeros(batch, w, cfg.d_inner),
        conv_b=zeros(batch, w, gn),
        conv_c=zeros(batch, w, gn),
        state=zeros(batch, cfg.num_heads, cfg.head_dim, cfg.d_state, dt=torch.float32),
    )


def _causal_conv(x, w, b):
    """Depthwise causal conv: x [B,S,C], w [W,C] -> [B,S,C], summed tap by
    tap in the activation dtype as the JAX version sums."""
    width = w.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    y = sum(xp[:, i : i + s, :] * w[i] for i in range(width))
    return y + b


def _conv_step(x_new, conv_state, w, b):
    """One-token conv update: x_new [B,C], conv_state [B,W-1,C].  Returns
    ``(y [B,C], window [B,W,C])``; the new conv state is ``window[:, 1:]``,
    a slice of a fresh tensor, so copying it into ``conv_state`` overlaps
    nothing.  The window's products are exact in fp32 and summed there,
    then rounded once, as a dot of the promoted dtype is."""
    window = torch.cat([conv_state, x_new[:, None]], dim=1)  # promotes as jnp.concatenate
    dt = torch.promote_types(window.dtype, w.dtype)
    y = (window.float() * w.float()).sum(dim=1).to(dt) + b
    return y, window


def _softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``; torch's ``softplus`` switches to ``x`` past 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_chunked(x, dt, a_log, b_in, c_in, *, chunk: int, init_state=None):
    """Chunked SSD.  x [B,S,H,P], dt [B,S,H] (post-softplus), a_log [H],
    b_in/c_in [B,S,N] (ngroups=1, broadcast over heads).
    Returns (y [B,S,H,P] in x's dtype, final_state [B,H,P,N] fp32)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    q = chunk if s >= chunk and s % chunk == 0 else s
    nc = s // q
    a = -torch.exp(a_log.float())  # [H], negative
    dt = dt.float()
    dta = dt * a  # [B,S,H] log-decay increments
    xdt = x.float() * dt[..., None]

    def ch(t):
        return t.reshape((bsz, nc, q) + tuple(t.shape[2:]))

    dta_c = ch(dta)  # [B,nc,Q,H]
    x_c = ch(xdt)  # [B,nc,Q,H,P]
    b_c = ch(b_in.float())  # [B,nc,Q,N]
    c_c = ch(c_in.float())  # [B,nc,Q,N]
    cum = torch.cumsum(dta_c, dim=2)  # [B,nc,Q,H]

    # intra-chunk (diagonal blocks): L[i,j] = exp(cum_i - cum_j), i >= j
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # mask the exponent, not the exponential: above the diagonal li grows
    # with the chunk's decay and exp overflows (past 88 in fp32), and the
    # gradient of a masked inf is 0 * inf = NaN (JAX's where-after-exp
    # gives NaN gradients there); the values are the same
    l_mat = torch.exp(torch.where(tri[None, None, :, :, None], li, -torch.inf))
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)  # [B,nc,Q,Q]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * l_mat, x_c)

    # per-chunk input states
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,Q,H]
    states = torch.einsum("bcqn,bcqhp->bchpn", b_c, decay_states[..., None] * x_c)

    # inter-chunk recurrence, emitting the state *entering* each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B,nc,H]
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # [B,nc,H,P,N]

    y_off = torch.einsum("bcqn,bchpn->bcqhp", c_c, prev_states) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(x.dtype), carry


def ssm_fwd(params, cfg: SSMConfig, x, *, init_state=None, return_cache: bool = False):
    """Full-sequence Mamba2 block.  x [B,S,D] -> [B,S,D].

    With ``return_cache`` also returns the :class:`SSMCache` (the conv
    inputs' last ``W-1`` rows in the activation dtype, and the final SSD
    state) that lets decode continue exactly after this prefix."""
    bsz, s, _ = x.shape
    h, p = cfg.num_heads, cfg.head_dim
    z = x @ params["in_z"]
    xin = x @ params["in_x"]
    bin_ = x @ params["in_b"]
    cin = x @ params["in_c"]
    xs = silu(_causal_conv(xin, params["conv_x_w"], params["conv_x_b"]))
    bs = silu(_causal_conv(bin_, params["conv_b_w"], params["conv_b_b"]))
    cs = silu(_causal_conv(cin, params["conv_c_w"], params["conv_c_b"]))
    dt = _softplus((x @ params["in_dt"]).float() + params["dt_bias"].float())
    y, state = ssd_chunked(xs.reshape(bsz, s, h, p), dt, params["a_log"], bs, cs,
                           chunk=cfg.chunk, init_state=init_state)
    y = y + params["d_skip"].to(y.dtype)[:, None] * xs.reshape(bsz, s, h, p)
    y = rms_norm(y.reshape(bsz, s, -1) * silu(z), params["norm_w"])
    out = y @ params["out_proj"]
    if return_cache:
        w = cfg.conv_width - 1
        return out, SSMCache(conv_x=xin[:, -w:], conv_b=bin_[:, -w:], conv_c=cin[:, -w:], state=state)
    return out


def ssm_decode(params, cfg: SSMConfig, x, cache: SSMCache):
    """One-token recurrent update.  x [B,1,D] -> ``(y [B,1,D], cache)``,
    the cache's conv tails and state overwritten in place with the new ones
    (cast to their dtypes: bf16 tails, fp32 state).  No host read: the call
    captures into a CUDA graph."""
    bsz = x.shape[0]
    h, p = cfg.num_heads, cfg.head_dim
    x1 = x[:, 0]
    z = x1 @ params["in_z"]
    xs, win_x = _conv_step(x1 @ params["in_x"], cache.conv_x, params["conv_x_w"], params["conv_x_b"])
    bs, win_b = _conv_step(x1 @ params["in_b"], cache.conv_b, params["conv_b_w"], params["conv_b_b"])
    cs, win_c = _conv_step(x1 @ params["in_c"], cache.conv_c, params["conv_c_w"], params["conv_c_b"])
    xs, bs, cs = silu(xs), silu(bs), silu(cs)
    dt = _softplus((x1 @ params["in_dt"]).float() + params["dt_bias"].float())  # [B,H]
    a = -torch.exp(params["a_log"].float())
    da = torch.exp(dt * a)  # [B,H]
    xh = xs.reshape(bsz, h, p).float()
    state = cache.state * da[..., None, None] + (xh * dt[..., None])[..., None] * bs.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, cs.float())
    y = y + params["d_skip"].float()[None, :, None] * xh
    y = y.reshape(bsz, -1).to(x.dtype)
    y = rms_norm(y * silu(z), params["norm_w"])
    out = (y @ params["out_proj"])[:, None]
    for buf, new in ((cache.conv_x, win_x), (cache.conv_b, win_b), (cache.conv_c, win_c)):
        buf.copy_(new[:, 1:])
    cache.state.copy_(state)
    return out, cache
