"""Deterministic synthetic data pipeline (port of ``repro/data/pipeline.py``).

``batch_at(step)`` is a pure function of ``(seed, step)``: the tokens are
drawn with numpy exactly as the JAX package draws them, bit for bit, and
then placed on an explicit device.  The stream is a hash-mixed Zipf-like
distribution with a copy pattern in each 64-token window, so a small model
has something to learn.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SyntheticLM", "host_shard"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, device="cuda") -> dict:
        """``{"tokens", "labels"}``, int32 ``[global_batch, seq_len]`` on
        ``device`` (labels are the tokens shifted by one)."""
        rng = np.random.default_rng(np.uint64(self.seed * 1_000_003 + step))
        b, s, v = self.global_batch, self.seq_len + 1, self.vocab_size
        u = rng.random((b, s))  # zipf-ish marginals
        ranks = np.minimum((u ** -1.2).astype(np.int64), v - 1)
        toks = (ranks * 2654435761 % v).astype(np.int32)
        # copy structure: the second half of each 64-token window repeats
        # the first half shifted by one (a learnable bigram/copy signal)
        w = 64
        ns = (s // w) * w
        view = toks[:, :ns].reshape(b, -1, w)
        view[:, :, w // 2:] = np.roll(view[:, :, : w // 2], -1, axis=-1)
        toks[:, :ns] = view.reshape(b, ns)
        toks = torch.from_numpy(toks).to(device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def host_shard(batch: dict, process_index: int, process_count: int) -> dict:
    """The rows of a global batch that process ``process_index`` of
    ``process_count`` holds."""
    def sl(x):
        per = x.shape[0] // process_count
        return x[process_index * per:(process_index + 1) * per]

    return {k: sl(v) for k, v in batch.items()}
