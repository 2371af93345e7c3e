"""Quickstart: the TensorDash core in 60 seconds, on the port (counterpart of
``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu  # on the host

On the card the PE, the convolution's projection and the codec run on the
tile and schedule kernels and the runtime's product on the SpMM and planner
kernels; on the host, their plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core import ConvLayer, compress, decompress, simulate_conv, simulate_macs, simulate_stream
from repro_torch.examples import add_device_flag, default_backend


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)

    # 1. A sparse operand stream through one 16-MAC TensorDash PE.
    z = rng.random((128, 16)) >= 0.66  # 66% zeros
    r = simulate_stream(z, device=dev)
    print(f"PE: {int(r.dense)} dense cycles -> {int(r.cycles)} TensorDash cycles "
          f"({int(r.dense)/int(r.cycles):.2f}x speedup at 66% sparsity)")

    # 2. Numerical fidelity: only zero products are elided.
    a = (rng.standard_normal((64, 16)) * (rng.random((64, 16)) > 0.5)).astype(np.float32)
    b = (rng.standard_normal((64, 16)) * (rng.random((64, 16)) > 0.5)).astype(np.float32)
    acc, cycles = simulate_macs(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    mac_err = abs(float(acc) - float(np.sum(a * b)))
    print(f"MAC fidelity: |acc - ref| = {mac_err:.2e} in {int(cycles)}/64 cycles")

    # 3. Scheduled-form compression (paper 3.6).
    x = (rng.standard_normal((96, 16)) * (rng.random((96, 16)) > 0.7)).astype(np.float32)
    enc = compress(torch.from_numpy(x).to(dev))
    dec = decompress(enc, t=96)
    exact = torch.equal(dec.cpu(), torch.from_numpy(x))
    print(f"codec: 96 rows -> {int(enc.n_cycles)} scheduled rows; exact roundtrip: {exact}")

    # 4. Accelerator-level projection for a conv layer (paper Table 2 config).
    layer = ConvLayer("resnet_conv", 256, 3, 3, 128, 28, 28)
    res = simulate_conv(layer, sparsity=0.66, sample_groups=1, max_t=96, device=dev)
    print(f"conv layer projection: {res.speedup:.2f}x over the dense accelerator")

    # 5. The repro_torch.runtime execution API: pick a kernel backend, plan
    #    once, execute block-sparse.
    # lint: allow-hand-geometry: the JAX quickstart's blocks, so the plan skips the blocks it prints
    rt = runtime.Runtime(backend=default_backend(dev), device=dev, bm=16, bk=32, bn=16)
    am = (rng.standard_normal((64, 128)).astype(np.float32)
          * (rng.random((4, 4)) < 0.5).repeat(16, 0).repeat(32, 1))
    bm = rng.standard_normal((128, 64)).astype(np.float32)
    at, bt = torch.from_numpy(am).to(dev), torch.from_numpy(bm).to(dev)
    plan = rt.plan(at, key="demo")  # a first-class SparsityPlan
    y = rt.matmul(at, bt, plan=plan)
    rt_err = float((y - at @ bt).abs().max())
    print(f"runtime[{rt.backend}]: plan skips {plan.skipped_fraction():.0%} of "
          f"blocks; |err| = {rt_err:.1e}")
    with runtime.use(rt):  # ambient form: model code resolves it implicitly
        ambient = runtime.resolve().backend
        print(f"ambient runtime -> {ambient}; plan cache {rt.plan_cache.stats()}")
    return {"stream": r, "a": a, "b": b, "acc": acc, "mac_cycles": cycles, "x": x, "enc": enc, "exact": exact,
            "conv": res, "plan": plan, "runtime_err": rt_err, "ambient": ambient,
            "plan_cache": rt.plan_cache.stats(), "operands": (am, bm)}


if __name__ == "__main__":
    main()
