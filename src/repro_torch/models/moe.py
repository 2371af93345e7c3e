"""Expert-parallel Mixture-of-Experts with TensorDash-style structured
sparsity (port of ``repro/models/moe.py``).

The router's top-k one-hot is the paper's Z-vector at expert granularity:
most (expert, token) pairs are ineffectual, and capacity bucketing advances
the effectual ones into each expert's slots.  A slot no token took holds the
all-zero pad row, so under a sparse runtime and a ReLU gate each expert's
``w_down`` product is a planned block-sparse product whose plan skips it.

Dispatch is gather-based and stays on the device: no ``.item()`` and no
host read, so the decode chunk that runs it can be captured as one CUDA
graph.

On a mesh (``moe_ffn(mesh=...)``, or the ambient runtime's), the layer runs
expert-parallel over ``torch.distributed``, as the JAX package runs it under
``shard_map``:

* experts are split over the ``model`` axis, and each expert's FFN dim is
  FSDP-split over ``data`` and all-gathered per call;
* training and prefill split the tokens over every axis (the sequence over
  ``model``) and send them to their experts' rank with a tiled all-to-all,
  an int8 payload with per-row fp32 scales when ``a2a_quant``
  (:func:`_quantized_all_to_all`, whose gradient is the mirrored quantized
  all-to-all);
* decode (a token count the sequence cannot split) keeps the tokens on
  every ``model`` rank; each rank runs its local experts
  (:func:`decode_local_step`, which needs no process group) and an
  ``all_reduce`` sums the ranks' outputs, so the weights never move.

Capacity is counted per shard, as in the JAX package, so a shard can drop
other tokens than one device does: the sharded layer equals the unsharded
one only where no expert overflows (a large ``capacity_factor``).

The layer differentiates: the all-to-alls are their own transposes, the
FSDP gather of the expert FFN dim reduce-scatters its gradient over
``data`` and the decode branch's sum is the identity backward.  Called with
global tensors (:func:`moe_ffn` with a mesh), each rank's gradients are its
own shard's contribution, and their sum over the ranks is the gradient of
the whole layer.  In a whole sharded model (:func:`moe_ffn_sharded`) the
tensors are the rank's own: the activations its data rows, replicated over
``model``, and the weights its shards under the model's ``param_pspecs``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch import runtime as rtm
from repro_torch.models.common import ACTIVATIONS, Spec

__all__ = ["MoEConfig", "moe_specs", "moe_ffn", "moe_ffn_sharded", "expert_capacity", "decode_local_step"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    activation: str = "silu"
    router_scale: bool = True  # normalize top-k weights to sum to 1
    a2a_quant: bool = True  # int8 dispatch/combine payloads of the expert-parallel all-to-all


def _quantize_rows(x):
    """Per-row symmetric int8 of ``x`` (rows along the last dim): ``(q
    int8, scale fp32 [..., 1])``.  The divisor 127 is a tensor: PyTorch's
    CUDA kernels multiply by the reciprocal of a Python-number divisor,
    one ulp off the true quotient that JAX and the CPU take."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / amax.new_tensor(127.0), 1e-12)
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def _dequantize_rows(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _a2a_tiled(x, split_axis: int, concat_axis: int, group):
    """Tiled all-to-all over ``group``: ``x`` cut into as many equal chunks
    along ``split_axis`` as the group has ranks, chunk ``i`` sent to rank
    ``i``, the received chunks concatenated along ``concat_axis`` in rank
    order (``jax.lax.all_to_all(..., tiled=True)``); ``group=None`` is one
    rank, whose all-to-all is the identity."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _qa2a(x, split_axis: int, concat_axis: int, group):
    q, scale = _quantize_rows(x)
    q = _a2a_tiled(q, split_axis, concat_axis, group)
    scale = _a2a_tiled(scale, split_axis, concat_axis, group)
    return _dequantize_rows(q, scale, x.dtype)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all, with an int8 payload and per-row fp32 scales
    when ``quant`` (about half the bytes of bf16; the DeepSeek-V3
    fp8-dispatch recipe).  Its gradient is the mirrored all-to-all (the
    transpose of a tiled all-to-all swaps its axes), quantized the same
    way, as the JAX package's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group, quant):
        ctx.args = (concat_axis, split_axis, group)
        ctx.run = _qa2a if quant else _a2a_tiled
        return ctx.run(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.run(g.contiguous(), *ctx.args), None, None, None, None


def _quantized_all_to_all(x, split_axis: int, concat_axis: int, group):
    return _AllToAll.apply(x, split_axis, concat_axis, group, True)


def _a2a(cfg: MoEConfig, x, split_axis: int, concat_axis: int, group):
    return _AllToAll.apply(x, split_axis, concat_axis, group, cfg.a2a_quant)


def moe_specs(cfg: MoEConfig) -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    specs = {
        "router": Spec((d, e), init="scaled", scale=0.02, dtype=torch.float32, axes=("embed", None)),
        "w_gate": Spec((e, d, f), axes=("experts", "expert_embed", "expert_mlp")),
        "w_up": Spec((e, d, f), axes=("experts", "expert_embed", "expert_mlp")),
        "w_down": Spec((e, f, d), axes=("experts", "expert_mlp", "expert_embed")),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * cfg.d_ff
        specs["shared"] = {
            "w_gate": Spec((d, fs), axes=("embed", "mlp")),
            "w_up": Spec((d, fs), axes=("embed", "mlp")),
            "w_down": Spec((fs, d), axes=("mlp", "embed")),
        }
    return specs


def expert_capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens (``cfg``: a :class:`MoEConfig` or a
    MoE ``ModelConfig``), in Python floats in the JAX package's order."""
    return max(1, int(t * cfg.top_k / cfg.num_experts * cfg.capacity_factor))


def _route(cfg: MoEConfig, x2, router_w):
    """x2 [T, d] -> (weights [T, k] fp32, experts [T, k] int64, probs [T, E]).
    ``torch.topk`` returns the larger probability first, as ``lax.top_k``."""
    logits = x2.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    if cfg.router_scale:
        top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    return top_p, top_e, probs


def _bucket(cfg: MoEConfig, top_e, n_experts: int, capacity: int, t: int):
    """Capacity bucketing: (slot_table [E, C] token-flat-id or the ``T*k``
    sentinel, pos [T, k] slot within its expert, fits [T, k]).  Positions are
    FIFO in token-major order (a cumsum over the one-hot); an assignment past
    its expert's capacity writes the sentinel entry, which is dropped."""
    flat_e = top_e.reshape(-1)  # [T*k]
    experts = torch.arange(n_experts, device=flat_e.device)
    onehot = (flat_e[:, None] == experts).long()  # [T*k, E]
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)  # [T*k]
    fits = pos < capacity
    slot = torch.where(fits, flat_e * capacity + pos, n_experts * capacity)
    n = t * cfg.top_k
    table = torch.full((n_experts * capacity + 1,), n, dtype=torch.long, device=flat_e.device)
    table.scatter_(0, slot, torch.arange(n, device=flat_e.device))
    return (table[:-1].reshape(n_experts, capacity), pos.reshape(-1, cfg.top_k),
            fits.reshape(-1, cfg.top_k))


def _expert_ffn(cfg: MoEConfig, xe, w_gate, w_up, w_down, rt=None):
    """xe [E, C, d] -> [E, C, d] (grouped gated FFN)."""
    act = ACTIVATIONS[cfg.activation]
    h = act(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    rt = rtm.resolve(rt)
    if rt.wants_sparse and cfg.activation in ("relu", "squared_relu"):
        # relu-family gates leave exact zeros in h (and an empty slot's pad
        # row is all zero), so each expert's down-projection is a planned
        # block-sparse product.  One call per expert, as in the JAX package:
        # every expert resolves its own tuned cell (capacity C, not E*C, is
        # the bucket a geometry="auto" runtime tunes for)
        return torch.stack([rt.matmul(h[e], w_down[e], op="moe_expert") for e in range(h.shape[0])])
    return torch.bmm(h, w_down)


def _shared_ffn(cfg: MoEConfig, params, x):
    act = ACTIVATIONS[cfg.activation]
    h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def _moe_local(cfg: MoEConfig, params, x2, rt=None):
    """All experts on one device.  x2 [T, d] -> [T, d]."""
    t = x2.shape[0]
    e = cfg.num_experts
    cap = expert_capacity(cfg, t)
    top_p, top_e, _ = _route(cfg, x2, params["router"])
    table, pos, fits = _bucket(cfg, top_e, e, cap, t)
    pad = x2.new_zeros((1, x2.shape[1]))
    x_pad = torch.cat([x2, pad], 0)
    token_of = torch.clamp_max(table // cfg.top_k, t)  # sentinel -> pad row
    xe = x_pad[token_of]  # [E, C, d]
    ye = _expert_ffn(cfg, xe, params["w_gate"], params["w_up"], params["w_down"], rt=rt)
    slot = torch.where(fits, top_e * cap + pos, e * cap)  # [T, k]
    return _combine(cfg, ye, slot, top_p, e * cap)


def _combine(cfg: MoEConfig, ye, slot, top_p, n_slots: int):
    """``y [T, d]``: each token's expert outputs weighted by its router
    probabilities; ``slot`` ``n_slots`` is the all-zero row of a dropped
    assignment."""
    ye_flat = torch.cat([ye.reshape(n_slots, -1), ye.new_zeros((1, ye.shape[-1]))], 0)
    return torch.einsum("tkd,tk->td", ye_flat[slot], top_p.to(ye.dtype))


def decode_local_step(cfg: MoEConfig, shard: int, ep_size: int, params, x2, rt=None):
    """Expert shard ``shard``'s share of the decode output, before the sum
    over ``model``: the tokens ``x2 [T, d]`` (every rank holds all of them)
    routed over all experts, and only the assignments to this shard's
    ``E / ep_size`` experts (``params``' ``w_gate``/``w_up``/``w_down``,
    whole along the FFN dim) bucketed and run; the others contribute zero.
    Each slot list holds ``4x`` the per-expert capacity (at most ``T *
    top_k``).  Needs no process group."""
    t = x2.shape[0]
    e_local = cfg.num_experts // ep_size
    top_p, top_e, _ = _route(cfg, x2, params["router"])
    my = shard * e_local
    cap = min(max(1, int(t * cfg.top_k / cfg.num_experts * cfg.capacity_factor) * 4), t * cfg.top_k)
    local = (top_e >= my) & (top_e < my + e_local)
    loc_e = torch.where(local, top_e - my, e_local)  # e_local: the drop bucket
    table, pos, fits = _bucket(cfg, loc_e, e_local + 1, cap, t)
    x_pad = torch.cat([x2, x2.new_zeros((1, x2.shape[1]))], 0)
    xe = x_pad[torch.clamp_max(table[:e_local] // cfg.top_k, t)]
    ye = _expert_ffn(cfg, xe, params["w_gate"], params["w_up"], params["w_down"], rt=rt)
    slot = torch.where(fits & local, loc_e * cap + pos, e_local * cap)
    return _combine(cfg, ye, slot, top_p, e_local * cap)


def _moe_sharded(cfg: MoEConfig, ep_size: int, seq_sharded: bool, params, x2, *, model_group, rt=None):
    """One rank's expert-parallel layer.  ``x2 [t_local, d]``; ``params``
    the router and the rank's experts ``[E / ep_size, d, f]`` (``w_down``
    ``[E / ep_size, f, d]``), already gathered over ``data``.
    ``model_group`` is ``None`` for an expert-parallel size of 1."""
    from repro_torch.parallel.sharding import tp_reduce  # local: parallel imports runtime

    e = cfg.num_experts
    t = x2.shape[0]
    if not seq_sharded:
        shard = dist.get_rank(model_group) if model_group is not None else 0
        return tp_reduce(decode_local_step(cfg, shard, ep_size, params, x2, rt=rt), model_group)
    top_p, top_e, _ = _route(cfg, x2, params["router"])
    cap = expert_capacity(cfg, t)
    table, pos, fits = _bucket(cfg, top_e, e, cap, t)
    x_pad = torch.cat([x2, x2.new_zeros((1, x2.shape[1]))], 0)
    xe = x_pad[torch.clamp_max(table // cfg.top_k, t)]  # [E, C, d]
    xe = _a2a(cfg, xe, 0, 1, model_group)  # dispatch: tokens travel to their experts' rank
    ye = _expert_ffn(cfg, xe, params["w_gate"], params["w_up"], params["w_down"], rt=rt)
    ye = _a2a(cfg, ye, 1, 0, model_group)  # [E, C, d]: back to the tokens' rank
    slot = torch.where(fits, top_e * cap + pos, e * cap)
    return _combine(cfg, ye, slot, top_p, e * cap)


#: the expert-parallel layer's weight specs (JAX's ``shard_map`` in_specs)
_W_SPECS = {
    "router": (None, None),
    "w_gate": ("model", None, "data"),
    "w_up": ("model", None, "data"),
    "w_down": ("model", "data", None),
}


def _gather_experts(params, specs, group_of):
    """The expert weights gathered over ``data`` (FSDP of the expert FFN
    dim), the gradient reduce-scattered back; ``group_of(entry)`` gives a
    spec entry's ``(group, size, index)``."""
    from repro_torch.parallel.sharding import gather_dim  # local: parallel imports runtime

    out = {}
    for k in ("w_gate", "w_up", "w_down"):
        w = params[k]
        for dim, entry in enumerate(specs[k]):
            if entry == "data":
                w = gather_dim(w, dim, group_of(entry)[0], grad_sum=True)
        out[k] = w
    return out


def _moe_expert_parallel(cfg: MoEConfig, params, x, mesh, seq_sharded: bool, rt=None):
    """The layer on ``mesh`` (named axes ``data`` and ``model``, ``pod``
    optional): every rank passes the global ``x`` and expert weights and
    gets the global output, computing on its own slices."""
    from repro_torch.parallel import sharding as S  # local: parallel imports runtime

    sizes = S.axis_sizes(mesh)
    if "model" not in sizes or "data" not in sizes:
        raise ValueError(f"the expert-parallel MoE needs mesh axes 'data' and 'model', got {tuple(sizes)}")
    s, d = x.shape[1], x.shape[2]
    ep = sizes["model"]
    seq_ax = "model" if (seq_sharded and s % ep == 0 and s > 1) else None
    x_spec = (S.data_axes(mesh), seq_ax, None)
    policy = S.ShardingPolicy(mesh=mesh)
    group_of = S.ModelShards(policy, None).group_of
    xl = S.local_shard(x, x_spec, policy)
    local = {k: S.local_shard(params[k], spec, policy) for k, spec in _W_SPECS.items()}
    experts = {"router": local["router"], **_gather_experts(local, _W_SPECS, group_of)}
    model_group = group_of("model")[0] if ep > 1 else None
    y = _moe_sharded(cfg, ep, seq_ax is not None, experts, xl.reshape(-1, d), model_group=model_group,
                     rt=rt).reshape(xl.shape)
    for dim, entry in enumerate(x_spec):  # the global output; the backward takes this rank's slice
        if entry:
            y = S.tp_gather(y, dim, group_of(entry)[0])
    return y


def moe_ffn_sharded(params, specs, cfg: MoEConfig, x, shards, rt=None, *, seq_sharded: bool = True):
    """The MoE FFN of a whole sharded model: ``x [B / data, S, d]`` this
    rank's rows (replicated over ``model``), ``params`` its shards under
    ``specs`` (the model's ``param_pspecs``: experts over ``model``, their
    FFN dim over ``data``, the router's d_model over ``data``), ``shards`` a
    :class:`~repro_torch.parallel.sharding.ModelShards`.  Training and
    prefill split the sequence over ``model`` (``tp_split``), dispatch by
    all-to-all and gather the sequence back; decode (or a sequence the
    model axis does not divide) runs every rank's local experts on all
    tokens and sums.  The router, used on each rank's own tokens or experts,
    gets its gradient summed over ``model``.  Shared experts run replicated
    over ``model``.  Returns ``[B / data, S, d]``, replicated over
    ``model``."""
    from repro_torch.parallel import sharding as S  # local: parallel imports runtime

    b, s, d = x.shape
    g, ep = shards.model_group, shards.tp
    for k in ("w_gate", "w_up", "w_down"):
        if ep > 1 and not shards.is_model(specs[k][0]):
            raise ValueError(f"expert weight {k} spec {specs[k]}: the experts must shard over 'model'")
    shared = 0.0
    if cfg.num_shared_experts:
        w = {k: S.gather_model(S.fsdp_gather(v, specs["shared"][k], shards), specs["shared"][k], shards)
             for k, v in params["shared"].items()}
        shared = _shared_ffn(cfg, w, x)
    experts = {"router": S.tp_copy(S.fsdp_gather(params["router"], specs["router"], shards), g),
               **_gather_experts(params, specs, shards.group_of)}
    if seq_sharded and s % ep == 0 and s > 1:
        xl = S.tp_split(x, 1, g)
        y = _moe_sharded(cfg, ep, True, experts, xl.reshape(-1, d), model_group=g, rt=rt)
        y = S.tp_gather(y.reshape(xl.shape), 1, g)
    else:
        y = _moe_sharded(cfg, ep, False, experts, S.tp_copy(x, g).reshape(-1, d), model_group=g,
                         rt=rt).reshape(b, s, d)
    return y + shared


def moe_ffn(params, cfg: MoEConfig, x, rt=None, *, mesh=None, seq_sharded: bool = True):
    """MoE FFN.  x [B, S, d] -> [B, S, d]; ``rt`` as in
    :func:`repro_torch.models.transformer.mlp_fwd`.  With a mesh (given, or
    the runtime's ``sharding``), expert-parallel over it (see the module
    docstring; ``seq_sharded=False`` takes the decode branch); without one,
    all experts on this device."""
    b, s, d = x.shape
    shared = _shared_ffn(cfg, params["shared"], x) if cfg.num_shared_experts else 0.0
    experts = {k: v for k, v in params.items() if k != "shared"}
    mesh = mesh if mesh is not None else rtm.resolve(rt).mesh
    if mesh is not None:
        return _moe_expert_parallel(cfg, experts, x, mesh, seq_sharded, rt=rt) + shared
    y = _moe_local(cfg, experts, x.reshape(-1, d), rt=rt)
    return y.reshape(b, s, d) + shared
