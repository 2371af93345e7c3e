"""TensorDash scheduled-form checkpoint/offload codec (paper §3.6/3.7; port
of ``repro/checkpoint/codec.py``).

The paper's scheduler doubles as a compression engine: tensors are stored as
packed effectual rows + 3-bit mux selections + 2-bit row-advances.  Here the
same machinery compresses *sparse checkpoint tensors* (pruned weights,
ReLU-family activation snapshots): a scheduler pass at save time, the
Fig. 12 decompressor at load time.  Lossless; only worth the metadata when
the tensor is actually sparse, so ``encode`` falls back to dense below
``min_sparsity``.

The encoded dict is the JAX package's, key for key, dtype for dtype and
value for value (``sel`` and ``advance`` as int8), so an array encoded by
either package decodes in the other.  :func:`encode` compresses on the card
unless ``device="cpu"``.  It takes a numpy array, whose dtype the dict keeps
(bfloat16 too, when the caller's numpy has that type), or a torch tensor.
A bfloat16 tensor, which numpy cannot hold without JAX's dtype package, is
stored as its ``uint16`` bit pattern under ``dtype`` ``"bfloat16_bits"`` (a
dense one with that ``dtype`` entry too), and :func:`decode` gives it back as
a bfloat16 tensor.  That form is the port's own: numpy knows no such dtype,
so the JAX package's decode of a compressed one raises instead of reading
the bits as numbers, and of a dense one returns the ``uint16`` bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compress import Scheduled, compress, decompress

__all__ = ["LANES", "encode", "decode", "compressed_bytes"]

LANES = 16
#: ``sel`` of a padding row in :func:`decode`: ``n_options`` at lookahead 2
_IDLE = 8
#: ``dtype`` of a bfloat16 tensor stored as its ``uint16`` bit pattern
BF16_BITS = "bfloat16_bits"


def _as_tensor(arr, bf16_bits: bool = False):
    """``arr`` as a tensor and the dict's ``dtype`` for it.  numpy's
    bfloat16 (JAX's dtype package), which torch cannot take from numpy,
    travels as its bit pattern, and so does a ``uint16`` array when
    ``bf16_bits``; a bfloat16 tensor is tagged :data:`BF16_BITS`."""
    if isinstance(arr, torch.Tensor):
        name = str(arr.dtype).removeprefix("torch.")
        return arr.detach(), BF16_BITS if arr.dtype == torch.bfloat16 else name
    a = np.ascontiguousarray(arr)
    if a.dtype.name == "bfloat16" or (bf16_bits and a.dtype == np.uint16):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16), "bfloat16"
    return torch.from_numpy(a), str(a.dtype)


def _to_numpy(t: torch.Tensor, like=None) -> np.ndarray:
    """A tensor as numpy: a bfloat16 tensor as ``like``'s dtype when that is
    numpy's bfloat16, else as its ``uint16`` bit pattern."""
    t = t.detach().cpu()  # lint: allow-host-sync: the codec's dict is host numpy
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy().view(np.uint16)
    return bits.view(like.dtype) if like is not None and like.dtype.name == "bfloat16" else bits


def encode(arr, *, min_sparsity: float = 0.3, device="cuda") -> dict:
    """Encode one array; returns a dict of numpy arrays (npz-friendly)."""
    like = arr if isinstance(arr, np.ndarray) else None
    t, dtype = _as_tensor(arr)
    sparsity = int((t == 0).sum()) / t.numel() if t.numel() else float("nan")
    if sparsity < min_sparsity or t.numel() < 4 * LANES:
        if like is not None:
            return {"mode": np.asarray(0), "dense": arr}
        dense = {"mode": np.asarray(0), "dense": _to_numpy(t)}
        return {**dense, "dtype": np.asarray(dtype)} if t.dtype == torch.bfloat16 else dense
    flat = t.reshape(-1).to(device)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % LANES))
    rows = flat.view(-1, LANES)
    enc = compress(rows)
    n = int(enc.n_cycles)
    return {
        "mode": np.asarray(1),
        "shape": np.asarray(tuple(t.shape), np.int64),
        "dtype": np.asarray(dtype),
        "t": np.asarray(rows.shape[0], np.int64),
        "values": _to_numpy(enc.values[:n], like),
        "sel": enc.sel[:n].to(torch.int8).cpu().numpy(),
        "advance": enc.advance[:n].to(torch.int8).cpu().numpy(),
    }


def decode(d: dict, *, device="cuda"):
    """The array ``d`` encodes, decompressed on ``device`` (a numpy array;
    a bfloat16 tensor for the bit-pattern form, see the module's note)."""
    bits = str(d.get("dtype", "")) == BF16_BITS
    if int(d["mode"]) == 0:
        return _as_tensor(d["dense"], bf16_bits=True)[0] if bits else np.asarray(d["dense"])
    t = int(d["t"])
    stored = np.asarray(d["values"])
    n = stored.shape[0]
    dtype = str(d["dtype"])
    vals, _ = _as_tensor(stored, bf16_bits=bits)
    values = torch.zeros((t, LANES), dtype=vals.dtype, device=device)
    sel = torch.full((t, LANES), _IDLE, dtype=torch.int32, device=device)
    adv = torch.zeros((t,), dtype=torch.int32, device=device)
    values[:n] = vals.to(device)
    sel[:n] = torch.from_numpy(np.asarray(d["sel"]).astype(np.int32)).to(device)
    adv[:n] = torch.from_numpy(np.asarray(d["advance"]).astype(np.int32)).to(device)
    enc = Scheduled(values=values, sel=sel, advance=adv,
                    n_cycles=torch.tensor(n, dtype=torch.int32, device=device))
    shape = tuple(int(x) for x in d["shape"])
    size = int(np.prod(shape))
    rows = decompress(enc, t=t).reshape(-1)[:size].reshape(shape)
    if vals.dtype == torch.bfloat16:
        if stored.dtype.name == "bfloat16":
            return _to_numpy(rows, stored)
        return rows.cpu()
    return rows.cpu().numpy().astype(dtype)


def compressed_bytes(d: dict) -> int:
    """Footprint model: values + 3b sel + 2b advance per packed row (vs the
    dense tensor's full footprint)."""
    if int(d["mode"]) == 0:
        return int(np.asarray(d["dense"]).nbytes)
    n = d["values"].shape[0]
    itemsize = d["values"].dtype.itemsize
    return int(n * LANES * itemsize + np.ceil(n * LANES * 3 / 8) + np.ceil(n * 2 / 8))
