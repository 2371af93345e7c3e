"""Reproduce Fig. 14's dynamics with *measured* sparsity from real training,
on the port (counterpart of ``examples/train_cnn_sparsity.py``).

Trains a small ReLU CNN classifier in PyTorch on a synthetic-but-learnable
image task, and after every epoch measures the actual zero fractions of
(a) post-ReLU activations A and (b) output-activation gradients G_O (via the
zero-probe trick), for every conv layer.  The measured fractions drive the
TensorDash perf model (the tile kernel on the card), giving the
speedup-vs-epoch curve the paper plots.

  PYTHONPATH=src python -m repro_torch.examples.train_cnn_sparsity --epochs 6
  PYTHONPATH=src python -m repro_torch.examples.train_cnn_sparsity --device cpu

The convolutions are ``F.conv2d`` on NCHW activations and OIHW weights (the
JAX example's NHWC/HWIO through ``lax.conv_general_dilated``); the ReLU is
``torch.maximum(h, 0)``, whose gradient at an exact zero is 1/2 as
``jnp.maximum``'s is; a 2x2 max-pool routes a window's gradient to its first
largest element, as XLA's select-and-scatter does, so a window of equal
zeros sends it to one element in both packages.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core.perf_model import BWD_INPUT, BWD_WEIGHT, FWD, ConvLayer, model_speedup
from repro_torch.core.sparsity import apply_probes
from repro_torch.examples import add_device_flag
from repro_torch.kernels.normal import fill_normal_


def make_data(rng, n, size=12, classes=4):
    """Images whose class is a quadrant-localised blob + noise (learnable),
    NHWC float32 numpy and int labels."""
    y = rng.integers(0, classes, n)
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32) * 0.3
    for i, c in enumerate(y):
        r, col = divmod(int(c), 2)
        x[i, r * 6 : r * 6 + 6, col * 6 : col * 6 + 6, :] += 1.2
    return x, y


def init_cnn(device, seed=0, channels=(3, 16, 32), classes=4) -> dict:
    """The JAX example's ``init_cnn(PRNGKey(seed))``, fp32: a key a layer
    from ``split(PRNGKey(seed), 3)``, each HWIO convolution's normals
    divided by fp32 ``sqrt(fan)`` (a division, as JAX's), the head's times
    0.05; the convolutions then in the port's layout (OIHW)."""
    ks = prng.split(prng.prng_key(seed), len(channels))
    params = {}
    for i in range(len(channels) - 1):
        fan = channels[i] * 9
        w = fill_normal_(torch.empty((3, 3, channels[i], channels[i + 1]), device=device), ks[i])
        w = w / torch.tensor(np.sqrt(fan), dtype=torch.float32, device=device)
        params[f"conv{i}"] = w.permute(3, 2, 0, 1).contiguous()
    params["head"] = fill_normal_(torch.empty((channels[-1], classes), device=device), ks[-1], 0.05)
    return params


def cnn_params_from_jax(tree, device) -> dict:
    """The JAX example's parameters (numpy, HWIO convolutions) in the port's
    layout (OIHW)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(v, np.float32), (3, 2, 0, 1))))
           for k, v in tree.items() if k.startswith("conv")}
    out["head"] = torch.from_numpy(np.array(tree["head"], np.float32))
    return {k: v.to(device) for k, v in out.items()}


def forward(params, x, probes=None):
    """Logits ``[n, classes]`` and the post-ReLU activations ``{a0, a1}``
    (NCHW) of ``x [n, 3, H, W]``."""
    h = x
    acts = {}
    for i in range(2):
        h = F.conv2d(h, params[f"conv{i}"], padding=1)  # "SAME" for a 3x3 kernel at stride 1
        h = torch.maximum(h, torch.zeros((), dtype=h.dtype, device=h.device))  # the paper's natural sparsity
        h = apply_probes(h, probes, f"g{i}")
        acts[f"a{i}"] = h
        h = F.max_pool2d(h, 2, 2)
    pooled = h.mean(dim=(2, 3))
    return pooled @ params["head"], acts


def loss_fn(params, x, y, probes=None):
    logits, acts = forward(params, x, probes)
    ll = torch.log_softmax(logits, dim=-1)
    return -ll.gather(1, y[:, None]).mean(), acts


def measure_epoch(params, x, y):
    """A and G_O zero fractions per conv layer (exact zeros, like the paper)."""
    with torch.no_grad():
        _, acts = forward(params, x)
    a_sp = {k: float((v == 0).float().mean()) for k, v in acts.items()}
    probes = {f"g{i}": torch.zeros_like(acts[f"a{i}"], requires_grad=True) for i in range(2)}
    grads = torch.autograd.grad(loss_fn(params, x, y, probes)[0], list(probes.values()))
    g_sp = {k: float((g == 0).float().mean()) for k, g in zip(probes, grads)}
    return a_sp, g_sp


def step(params, x, y, lr: float = 0.05):
    """One SGD step: ``(loss, params - lr * grads)``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves, x, y)[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: (p - lr * g).detach() for (k, p), g in zip(leaves.items(), grads)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--steps-per-epoch", type=int, default=25)
    ap.add_argument("--batch", type=int, default=32)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    x_np, y_np = make_data(rng, 512)
    xtr = torch.from_numpy(x_np).permute(0, 3, 1, 2).contiguous().to(dev)
    ytr = torch.from_numpy(y_np).to(dev)
    params = init_cnn(dev)
    layers = [ConvLayer("conv0", 3, 3, 3, 16, 12, 12), ConvLayer("conv1", 16, 3, 3, 32, 6, 6)]

    print("epoch  loss   A-sparsity  G-sparsity  TensorDash-speedup")
    epochs = []
    for epoch in range(args.epochs):
        a_sp, g_sp = measure_epoch(params, xtr[:128], ytr[:128])
        a_bar = float(np.mean(list(a_sp.values())))
        g_bar = float(np.mean(list(g_sp.values())))
        sp = {FWD: a_bar, BWD_INPUT: g_bar, BWD_WEIGHT: max(a_bar, g_bar)}
        proj = model_speedup(layers, sp, sample_groups=1, max_t=48, seed=epoch, device=dev)
        loss = float("nan")
        for _ in range(args.steps_per_epoch):
            idx = torch.from_numpy(rng.integers(0, len(x_np), args.batch)).to(dev)
            loss, params = step(params, xtr[idx], ytr[idx])
        epochs.append({"epoch": epoch, "loss": float(loss), "a_sp": a_sp, "g_sp": g_sp, "a_bar": a_bar,
                       "g_bar": g_bar, "projection": proj})
        print(
            f"{epoch:4d}  {float(loss):6.3f}   {a_bar:8.2%}   {g_bar:8.2%}"
            f"   {proj['overall']:.2f}x  (A*W {proj[FWD]:.2f} / W*G {proj[BWD_INPUT]:.2f}"
            f" / A*G {proj[BWD_WEIGHT]:.2f})"
        )
    print("\nPaper Fig. 14: dense-model speedup rises in early epochs as the "
          "net learns which features are irrelevant, then stabilises.")
    return {"epochs": epochs}


if __name__ == "__main__":
    main()
