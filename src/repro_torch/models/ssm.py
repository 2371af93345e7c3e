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

Tensor parallel over a mesh's ``model`` axis (:func:`ssm_call` with a
:class:`~repro_torch.parallel.sharding.ModelShards`) splits the heads, the
layout real Mamba TP uses: each model rank holds its heads' columns of
``in_z``/``in_x``/``in_dt``, their conv channels, ``dt_bias``/``a_log``/
``d_skip``/``norm_w`` and its rows of ``out_proj`` (row-parallel: fp32
partials, one all-reduce); B and C (``ngroups`` 1) are computed whole on
every rank from replicated ``in_b``/``in_c`` and conv weights, whose
gradient shares are summed.  The gated RMS norm spans the whole
``d_inner``: each rank's sum of squares is summed over ``model`` in both
directions (:func:`~repro_torch.parallel.sharding.tp_sum`).  A layer whose
heads do not divide the model axis runs replicated over it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.common import Spec, rms_norm, silu
from repro_torch.parallel import sharding as S


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128
    tp: int = 1  # model ranks the heads are split over: d_inner and num_heads are then one rank's

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model // self.tp

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


def _gated_norm(y, z, w, norm_sum=None, n: int = 0, eps: float = 1e-6):
    """``rms_norm(y * silu(z), w)``; with ``norm_sum`` (a tensor-parallel
    rank's channels) the mean of squares is over all ``n`` channels of the
    ranks: ``norm_sum`` sums this rank's fp32 sums of squares over them."""
    g = y * silu(z)
    if norm_sum is None:
        return rms_norm(g, w, eps)
    gf = g.float()
    ss = norm_sum(gf.square().sum(dim=-1, keepdim=True))
    return (gf * torch.rsqrt(ss / n + eps) * w.float()).to(g.dtype)


def _out_proj(y, w, partial: bool):
    """``y @ out_proj``; ``partial``: a row-parallel rank's fp32 partial."""
    return y.float() @ w.float() if partial else y @ w


def ssm_fwd(params, cfg: SSMConfig, x, *, init_state=None, return_cache: bool = False, norm_sum=None,
            partial: bool = False):
    """Full-sequence Mamba2 block.  x [B,S,D] -> [B,S,D].

    With ``return_cache`` also returns the :class:`SSMCache` (the conv
    inputs' last ``W-1`` rows in the activation dtype, and the final SSD
    state) that lets decode continue exactly after this prefix.  As a
    tensor-parallel rank's local step (``cfg.tp``, ``params`` its heads'
    slices), ``norm_sum`` sums the gated norm's statistic over the model
    ranks (:func:`ssm_call` passes ``tp_sum`` over the model group) and
    ``partial`` returns the fp32 partial output."""
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
    y = _gated_norm(y.reshape(bsz, s, -1), z, params["norm_w"], norm_sum, cfg.d_inner * cfg.tp)
    out = _out_proj(y, params["out_proj"], partial)
    if return_cache:
        w = cfg.conv_width - 1
        return out, SSMCache(conv_x=xin[:, -w:], conv_b=bin_[:, -w:], conv_c=cin[:, -w:], state=state)
    return out


def ssm_decode(params, cfg: SSMConfig, x, cache: SSMCache, *, norm_sum=None, partial: bool = False):
    """One-token recurrent update.  x [B,1,D] -> ``(y [B,1,D], cache)``,
    the cache's conv tails and state overwritten in place with the new ones
    (cast to their dtypes: bf16 tails, fp32 state).  No host read: the call
    captures into a CUDA graph.  ``norm_sum``/``partial`` as in
    :func:`ssm_fwd` (the cache then holds the rank's heads)."""
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
    y = _gated_norm(y, z, params["norm_w"], norm_sum, cfg.d_inner * cfg.tp)
    out = _out_proj(y, params["out_proj"], partial)[:, None]
    for buf, new in ((cache.conv_x, win_x), (cache.conv_b, win_b), (cache.conv_c, win_c)):
        buf.copy_(new[:, 1:])
    cache.state.copy_(state)
    return out, cache


#: the leaves every model rank holds whole: B and C are computed whole on
#: each rank (``ngroups`` 1), for the heads of all of them
REPLICATED = ("in_b", "in_c", "conv_b_w", "conv_b_b", "conv_c_w", "conv_c_b")


def ssm_local(p, spec, cfg: SSMConfig, sh: "S.ModelShards"):
    """``(weights, config, group)`` of this rank's Mamba2 layer on a mesh:
    the weights gathered over the data axes (FSDP), then split by heads
    over ``model`` (``config.tp``; the :data:`REPLICATED` leaves enter the
    region through ``tp_copy``, so their gradient shares are summed), or
    gathered over ``model`` too where the heads do not divide it (``group``
    ``None``: the layer runs replicated)."""
    w = {k: S.fsdp_gather(v, spec[k], sh) for k, v in p.items()}
    if sh.tp == 1 or cfg.num_heads % sh.tp:
        return {k: S.gather_model(v, spec[k], sh) for k, v in w.items()}, cfg, None
    g = sh.model_group
    for k in REPLICATED:
        w[k] = S.tp_copy(w[k], g)
    return w, dataclasses.replace(cfg, tp=sh.tp), g


def ssm_call(p, cfg: SSMConfig, x, *, sh=None, spec=None, cache: SSMCache | None = None,
             return_cache: bool = False):
    """One Mamba2 layer over ``x`` (after its norm): the full-sequence form,
    or with ``cache`` one decode step.  On a mesh (``sh``, the layer's
    ``spec``) the head-parallel local step (:func:`ssm_local`) runs between
    ``tp_copy`` and one all-reduce of its fp32 partials.  Returns ``(y,
    cache)`` (``None`` for a full sequence without ``return_cache``)."""
    group = None
    if sh is not None:
        p, cfg, group = ssm_local(p, spec, cfg, sh)
        if group is not None:
            dt = torch.promote_types(x.dtype, p["out_proj"].dtype)
            x = S.tp_copy(x, group)
    kw = {"partial": group is not None,
          "norm_sum": None if group is None else (lambda ss: S.tp_sum(ss, group))}
    if cache is not None:
        y, cache = ssm_decode(p, cfg, x, cache, **kw)
    elif return_cache:
        y, cache = ssm_fwd(p, cfg, x, return_cache=True, **kw)
    else:
        y = ssm_fwd(p, cfg, x, **kw)
    if group is not None:
        y = S.tp_reduce(y, group).to(dt)
    return y, cache
