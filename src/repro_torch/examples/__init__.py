"""The repo's five examples on the port (counterparts of ``examples/*.py``).

Each runs as ``PYTHONPATH=src python -m repro_torch.examples.<name>``, on the
card unless ``--device cpu`` asks for the host, takes its JAX counterpart's
flags with the same defaults, prints the same table and returns what it
printed from ``main(argv=None)``:

* ``quickstart`` — the TensorDash core: the PE, the MAC accumulator, the
  codec, a convolution's projection and the runtime's planned product;
* ``serve_batched`` — continuous batching through ``ServeEngine``;
* ``train_lm`` — a decoder trained through ``make_train_step`` with
  checkpoints, resume and the FFN's projected speedup;
* ``train_pruned`` — training under gradual magnitude pruning, the codec's
  footprint beside the projection;
* ``train_cnn_sparsity`` — the paper's setting: a ReLU CNN whose measured A
  and G_O zero fractions drive the cycle model (Fig. 14).

Parameters come from a module-level initialiser that a caller may replace
(the tests hand in the JAX example's initial parameters).
"""
from __future__ import annotations

import torch

__all__ = ["add_device_flag", "default_backend"]


def add_device_flag(ap) -> None:
    """``--device``: the card by default; ``cpu`` runs the plain versions."""
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the Hopper kernels, the default) or cpu (their plain versions)")


def default_backend(device) -> str:
    """The kernel backend on ``device``: ``cuda`` (the hand-written kernels)
    on the card, ``reference`` (their plain versions) on the host."""
    return "cuda" if torch.device(device).type == "cuda" else "reference"
