#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA Hopper card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one H100.  It

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed);
2. holds each kernel against its plain PyTorch version on the card, at the
   serving main path's decode shapes (4 slots, bf16, full deepseek-7b
   widths) and at small block-sparse shapes in fp32 and bf16, and times the
   kernel, the plain version and one ``torch.matmul`` of the same product;
3. serves full-width deepseek-7b (30 layers, ReLU FFN, bf16, seeded random
   weights) through ``ServeEngine`` on the ``cuda`` backend and checks that
   every FFN gate, ``w_down`` and LM-head product went through the kernels,
   as many times as the path implies, and that no plain executor ran;
4. compares the same prompts' prefill logits with the ``reference``
   backend on the card;
5. holds the v2/v1 grid kernels, planned and fused, bit-equal to the
   ragged kernels at the same geometry and within tolerance of the plain
   versions at the decode shapes and small block-sparse shapes, and
   ``block_zero_mask`` exactly equal to its plain version (timed as in 2);
6. tunes the full-width decode FFN products on the card with
   ``repro_torch.tune.tune_cells`` (a DB in a temporary directory) and
   checks that v2 and v1 candidates ran and passed the numerics gate;
7. serves the same requests under ``Runtime(geometry="auto")`` twice: with
   the tuned DB, and with a DB that pins the FFN to the explicit geometry
   on the v2 grid, which must launch the v2 kernels and give the ragged
   serve's greedy tokens exactly; it counts host syncs per decode step;
8. prints a ``kernels`` JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``; the full per-case table goes to
   ``chiprun_out/chip_smoke.json`` (git-ignored).

Any failed phase raises, and the script exits non-zero without the result
line.  It needs the checkout's ``src/`` and a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: decode slots and serving shape of the serve phase
SLOTS, CHUNK, MAX_LEN, REQUESTS, NEW_TOKENS = 4, 8, 128, 6, 16
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # H100 SXM data sheet, dense
#: relative L2 bound of cuda vs reference prefill logits (bf16, 30 layers):
#: the kernels and the plain executor sum each block in another order, so a
#: bf16 rounding flips here and there and the flips compound through the
#: layers; 2**-5 is eight bf16 steps of relative error
REF_REL_L2 = 2**-5
SOURCE = "src/repro_torch/kernels/csrc/tensordash_spmm.cu"
REPLACES = {
    "tensordash_matmul_fused": "src/repro/kernels/tensordash_spmm.py:506",
    "tensordash_matmul_planned": "src/repro/kernels/tensordash_spmm.py:481",
    "tensordash_matmul_planned[v2/v1]": "src/repro/kernels/tensordash_spmm.py:405",
    "tensordash_matmul_fused[v2/v1]": "src/repro/kernels/tensordash_spmm.py:450",
    "block_zero_mask": "src/repro/kernels/block_mask.py:24",
}
#: one compare per element at the card's non-tensor fp32 rate (data sheet)
COMPARE_RATE = 67e12
#: the full-width decode FFN products tuned in the tune phase: (m, k, n, op)
TUNE_CELLS = ((SLOTS, 4096, 11008, "matmul_fused"), (SLOTS, 11008, 4096, "matmul"))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mem_bandwidth(name: str) -> float:
    """Device-memory bytes/s of the named card (data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    return 3.35e12  # H100 SXM


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a spin kernel, so the card runs them back to back even
    when the host takes longer to issue a call than the card to run it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning while the host queues the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def block_sparse(m, k, bm, bk, density, gen, *, skew=1.0, zero_every=None):
    """``[m, k]`` fp32 with a power-law number of effectual K blocks per
    block row (mean ``density``) and, with ``zero_every``, every
    ``zero_every``-th block row all zero."""
    import torch

    mb, kb = m // bm, k // bk
    w = torch.arange(1, mb + 1, dtype=torch.float64) ** -skew
    nnz = torch.clamp(torch.round(w / w.mean() * density * kb), 1, kb).long()
    if zero_every:
        nnz[::zero_every] = 0
    keep = torch.zeros(mb, kb, dtype=torch.bool)
    for r in range(mb):
        keep[r, torch.randperm(kb, generator=gen)[: int(nnz[r])]] = True
    a = torch.randn(m, k, generator=gen)
    return (a.reshape(mb, bm, kb, bk) * keep[:, None, :, None]).reshape(m, k)


def plan_bytes_flops(nnz, idx, a, b, bm, bk, *, out_elems, extra_bytes=0):
    """Least bytes and operations of a planned product on this data: each
    effectual A block and each needed B row block read once, the output
    and the metadata written/read once."""
    esz = a.element_size()
    nnz_h, idx_h = nnz.cpu(), idx.cpu()
    eff = int(nnz_h.sum())
    used_k = set()
    for r in range(idx_h.shape[0]):
        used_k.update(idx_h[r, : int(nnz_h[r])].tolist())
    n = b.shape[1]
    meta = 4 * (2 * nnz_h.numel() + 1 + max(eff, nnz_h.numel()))
    bytes_ = eff * bm * bk * esz + len(used_k) * bk * n * esz + out_elems * esz + meta + extra_bytes
    return bytes_, 2.0 * eff * bm * bk * n


def check_close(name, got, want, mask_got=None, mask_want=None):
    """Within the kernel tolerance of the plain version
    (``repro_torch.tune.search.kernel_tolerance``: fp32 rtol = atol = 2e-4,
    bf16 rtol 2**-7 plus atol 1e-3 of the largest value); masks exactly."""
    import torch
    from repro_torch.tune.search import kernel_tolerance

    got32, want32 = got.float(), want.float()
    rtol, atol = kernel_tolerance(got.dtype, want)
    err = float((got32 - want32).abs().max())
    if not torch.allclose(got32, want32, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with the plain version (max abs err {err})")
    if mask_got is not None and not torch.equal(mask_got, mask_want):
        raise AssertionError(f"{name}: emitted mask differs from the plain version's")
    return err


def kernel_phase(bw: float):
    import torch
    from repro_torch.kernels import ref, tensordash_spmm as T

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)  # small operands, drawn on the host
    gdev = torch.Generator(device=dev).manual_seed(1)  # full-width weights, drawn on the card
    rows = []

    def run_case(label, kernel, dtype, a, b, bm, bk, bn, plan, *, bias=None, residual=None,
                 activation="relu", main=False):
        nnz, idx, rs, wr, wk = plan
        esz = a.element_size()
        m, n = a.shape[0], b.shape[1]
        if kernel == "tensordash_matmul_fused":
            call = lambda: T.tensordash_matmul_fused(
                nnz, idx, a, b, bias, residual, activation=activation, bm=bm, bk=bk, bn=bn,
                workqueue=(rs, wr, wk))
            plain = lambda: ref.tensordash_matmul_fused_ref(
                nnz, idx, a, b, bias, residual, bm=bm, bk=bk, bn=bn, activation=activation)
            (out, mask), (pout, pmask) = call(), plain()
            extra = (n * 4 if bias is not None else 0) + (m * n * esz if residual is not None else 0)
            extra += (m // bm) * (n // bn)
        else:
            call = lambda: T.tensordash_matmul_planned(nnz, idx, a, b, bm=bm, bk=bk, bn=bn,
                                                       workqueue=(rs, wr, wk))
            plain = lambda: ref.tensordash_matmul_ref(nnz, idx, a, b, bm=bm, bk=bk, bn=bn)
            out, pout, mask, pmask, extra = call(), plain(), None, None, 0
        torch.cuda.synchronize()
        err = check_close(label, out, pout, mask, pmask)
        nbytes, flops = plan_bytes_flops(nnz, idx, a, b, bm, bk, out_elems=m * n, extra_bytes=extra)
        t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAK_FLOPS[str(dtype)] * 1e3
        row = {
            "case": label, "kernel": kernel, "dtype": str(dtype).replace("torch.", ""),
            "shape": f"[{m},{a.shape[1]}]@[{a.shape[1]},{n}]", "block": (bm, bk, bn),
            "max_abs_err": err, "ms": cuda_ms(call), "plain_ms": cuda_ms(plain, iters=5),
            "library_ms": cuda_ms(lambda: torch.matmul(a, b)),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "main_path": main,
        }
        rows.append(row)
        log(f"  {label:<34} {row['dtype']:<8} {row['shape']:<28} kernel {row['ms']:.4f} ms  "
            f"plain {row['plain_ms']:.4f} ms  torch.matmul {row['library_ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})  max_abs_err {err:.3e}")

    bf16 = torch.bfloat16
    # -- the main path's decode shapes: 4 slots, full deepseek-7b widths ------
    x = torch.randn(SLOTS, 4096, generator=gen).to(dev, bf16)
    w_gate = (torch.randn(4096, 11008, generator=gdev, device=dev) / 64).to(bf16)
    run_case("decode gate (fused relu)", "tensordash_matmul_fused", bf16, x, w_gate, SLOTS, 512, 128,
             T.dense_plan_csr(1, 8, dev), main=True)
    del w_gate
    h = block_sparse(SLOTS, 11008, SLOTS, 128, 0.4, gen).to(dev, bf16)
    w_down = (torch.randn(11008, 4096, generator=gdev, device=dev) / 105).to(bf16)
    hmask = (h.reshape(1, SLOTS, 86, 128) != 0).any(dim=3).any(dim=1).to(torch.int8)
    run_case("decode w_down (emitted-mask plan)", "tensordash_matmul_planned", bf16, h, w_down,
             SLOTS, 128, 128, T.plan_from_mask_csr(hmask), main=True)
    del w_down
    lm_head = (torch.randn(4096, 102400, generator=gdev, device=dev) / 64).to(bf16)
    hn = torch.randn(SLOTS, 4096, generator=gen).to(dev, bf16)
    a_t, b_t = lm_head.T, hn.T  # strided views, as Runtime.matmul(side="B") passes them
    run_case("decode LM head (side B, strided)", "tensordash_matmul_planned", bf16, a_t, b_t,
             128, 512, SLOTS, T.plan_blocks_csr(a_t, 128, 512), main=True)
    del lm_head, a_t

    # -- small shapes with real block sparsity -------------------------------
    m, k, n, bm, bk, bn = 256, 1024, 384, 32, 64, 64
    for dtype in (torch.float32, bf16):
        a = block_sparse(m, k, bm, bk, 0.4, gen, zero_every=7).to(dev, dtype)
        b = torch.randn(k, n, generator=gen).to(dev, dtype)
        plan = T.plan_blocks_csr(a, bm, bk)
        col = torch.arange(n) // bn
        bias = (torch.randn(n, generator=gen) - 1e4 * (col % 3 == 0)).to(dev)  # dead column blocks
        res = torch.randn(m, n, generator=gen).to(dev, dtype)
        run_case("sparse 0.4 planned", "tensordash_matmul_planned", dtype, a, b, bm, bk, bn, plan)
        run_case("sparse 0.4 fused relu+bias", "tensordash_matmul_fused", dtype, a, b, bm, bk, bn,
                 plan, bias=bias)
        for act in ("none", "relu", "squared_relu"):
            run_case(f"sparse 0.4 fused {act}+bias+res", "tensordash_matmul_fused", dtype, a, b,
                     bm, bk, bn, plan, bias=bias, residual=res, activation=act)
    return rows


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


def drive_serve(params, cfg, prompts, rt):
    """Serve ``prompts`` through a fresh ``ServeEngine`` on ``rt``: the
    launch counts of the run (set to 0 just before it), its greedy tokens,
    stats, wall and decode seconds, prefill group sizes, and the host syncs
    (``torch.cuda`` sync debug warnings) inside decode chunks and in the
    whole run.  Fails if a plain executor ran."""
    import torch
    from repro_torch.kernels import ref, tensordash_spmm as T
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(params, cfg, slots=SLOTS, chunk=CHUNK, max_len=MAX_LEN, rt=rt)
    groups, decode_s, decode_syncs = [], [0.0], [0]
    admit, decode = eng._admit_group, eng._decode_chunk

    def counted_admit(placements):
        groups.append(len(placements))
        return admit(placements)

    def timed_decode():
        torch.cuda.set_sync_debug_mode("default")  # the timing's own syncs are not counted
        torch.cuda.synchronize()
        t = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            out = decode()
            torch.cuda.set_sync_debug_mode("default")
        decode_syncs[0] += sum("synchroniz" in str(w.message) for w in seen)
        torch.cuda.synchronize()
        decode_s[0] += time.perf_counter() - t
        torch.cuda.set_sync_debug_mode("warn")
        return out

    eng._admit_group, eng._decode_chunk = counted_admit, timed_decode
    plain_calls = []
    orig_plain = (ref.tensordash_matmul_ref, ref.tensordash_matmul_fused_ref)

    def guard(fn):
        def wrapped(*args, **kw):
            plain_calls.append(fn.__name__)
            return fn(*args, **kw)
        return wrapped

    ref.tensordash_matmul_ref, ref.tensordash_matmul_fused_ref = map(guard, orig_plain)
    torch.cuda.reset_peak_memory_stats()
    try:
        for p in prompts:
            eng.submit(p, max_new=NEW_TOKENS)
        T.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = eng.run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = T.launch_counts()
    finally:
        ref.tensordash_matmul_ref, ref.tensordash_matmul_fused_ref = orig_plain
    if plain_calls:
        raise AssertionError(f"serve ran plain executors: {sorted(set(plain_calls))}")
    syncs = decode_syncs[0] + sum("synchroniz" in str(w.message) for w in seen)
    return out, launches, eng.stats(), wall, decode_s[0], groups, decode_syncs[0], syncs


def serve_phase():
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params

    cfg = dataclasses.replace(get_config("deepseek-7b"), activation="relu")
    t0 = time.perf_counter()
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: deepseek-7b relu, {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f} B params in bf16 initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(s)) for s in rng.integers(16, 33, size=REQUESTS)]

    rt = rtm.Runtime(backend="cuda", device="cuda")
    out, launches, st, wall, decode_s, groups, _, _ = drive_serve(params, cfg, prompts, rt)
    calls = len(groups) + st["steps_run"]  # model invocations: prefill groups + decode steps
    want = {k: 0 for k in launches}
    want.update({"tensordash_matmul_fused": cfg.num_layers * calls,
                 "tensordash_matmul_planned": (cfg.num_layers + 1) * calls,
                 "block_zero_mask": 1})  # the LM head's weight plan, built once
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != path's {want}")
    if sorted(len(v) for v in out.values()) != [NEW_TOKENS] * REQUESTS:
        raise AssertionError(f"tokens per request {[len(v) for v in out.values()]}")
    if any(t < 0 or t >= cfg.vocab_size for v in out.values() for t in v):
        raise AssertionError("token outside the vocabulary")
    pc = st["plan_cache"]
    if pc["misses"] != 1 or pc["hits"] != calls - 1:
        raise AssertionError(f"LM-head plan cache {pc}, expected 1 miss and {calls - 1} hits")
    summary = {
        "tokens": st["tokens_out"], "wall_s": wall, "tok_per_s": st["tokens_out"] / wall,
        "decode_steps": st["steps_run"], "ms_per_decode_step": decode_s / st["steps_run"] * 1e3,
        "prefill_groups": len(groups), "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "plan_cache": pc,
        "greedy_tokens": out,
    }
    log(f"serve: {REQUESTS} requests x {NEW_TOKENS} new tokens, slots {SLOTS}, chunk {CHUNK}: "
        f"{summary['tokens']} tokens in {wall:.3f} s = {summary['tok_per_s']:.2f} tok/s; "
        f"{summary['ms_per_decode_step']:.3f} ms per decode step over {st['steps_run']} steps; "
        f"{len(groups)} prefill groups; peak memory {summary['peak_mem_gb']:.2f} GB")
    log(f"serve: kernel launches {launches} == path's (30 fused + 31 planned per model call, "
        f"{calls} calls; 1 block_zero_mask for the LM-head plan); plan cache {pc['hits']} hits / "
        f"{pc['misses']} miss; no plain executor ran")
    return params, cfg, prompts, summary


def reference_phase(params, cfg, prompts):
    """Each prompt's prefill logits under ``cuda`` and ``reference``."""
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.models import model as M

    worst, agree = 0.0, 0
    with torch.inference_mode():
        for p in prompts:
            toks = torch.as_tensor(p, device="cuda")[None]
            logits = {}
            for backend in ("cuda", "reference"):
                with rtm.Runtime(backend=backend, device="cuda").use():
                    logits[backend] = M.prefill(params, cfg, {"tokens": toks})[0][0, -1].float()
            got, want = logits["cuda"], logits["reference"]
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("non-finite cuda logits")
            worst = max(worst, float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)))
            agree += int(got.argmax() == want.argmax())
    log(f"reference: prefill last-token logits, cuda vs reference backend on the card: "
        f"worst relative L2 {worst:.3e} (bound {REF_REL_L2:.3e}); top-1 agreement {agree}/{len(prompts)}")
    if worst > REF_REL_L2:
        raise AssertionError(f"cuda vs reference relative L2 {worst} > {REF_REL_L2}")
    return worst, agree


# ---------------------------------------------------------------------------
# grid-family kernel phase (v2/v1) and block_zero_mask
# ---------------------------------------------------------------------------


def grid_kernel_phase(bw: float):
    """v2/v1 planned and fused at the decode and small shapes: bit-equal to
    the ragged kernel at the same geometry, within tolerance of the plain
    version, masks equal; then ``block_zero_mask`` exactly equal to its
    plain version.  Each case is timed beside its bound and one torch call."""
    import torch
    from repro_torch.kernels import block_zero_mask, ref, tensordash_spmm as T

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    gdev = torch.Generator(device=dev).manual_seed(3)
    rows = []

    def grid_case(label, fused, dtype, a, b, bm, bk, bn, plan, *, bias=None, residual=None,
                  activation="relu", main=False):
        nnz, idx, rs, wr, wk = plan
        m, n = a.shape[0], b.shape[1]
        esz = a.element_size()
        if fused:
            run = lambda grid, wq=None: T.tensordash_matmul_fused(
                nnz, idx, a, b, bias, residual, activation=activation, bm=bm, bk=bk, bn=bn,
                compact_grid=grid, workqueue=wq)
            plain = lambda: ref.tensordash_matmul_fused_ref(
                nnz, idx, a, b, bias, residual, bm=bm, bk=bk, bn=bn, activation=activation)
            extra = (n * 4 if bias is not None else 0) + (m * n * esz if residual is not None else 0)
            extra += (m // bm) * (n // bn)
        else:
            run = lambda grid, wq=None: (T.tensordash_matmul_planned(
                nnz, idx, a, b, bm=bm, bk=bk, bn=bn, compact_grid=grid, workqueue=wq), None)
            plain = lambda: (ref.tensordash_matmul_ref(nnz, idx, a, b, bm=bm, bk=bk, bn=bn), None)
            extra = 0
        rag_out, rag_mask = run("ragged", (rs, wr, wk))
        pout, pmask = plain()
        nbytes, flops = plan_bytes_flops(nnz, idx, a, b, bm, bk, out_elems=m * n, extra_bytes=extra)
        t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAK_FLOPS[str(dtype)] * 1e3
        plain_ms = cuda_ms(plain, iters=5)
        library_ms = cuda_ms(lambda: torch.matmul(a, b))
        for grid in ("v2", "v1"):
            out, mask = run(grid)
            torch.cuda.synchronize()
            if not torch.equal(out, rag_out) or (fused and not torch.equal(mask, rag_mask)):
                raise AssertionError(f"{label} {grid}: not bit-equal to the ragged kernel")
            err = check_close(f"{label} {grid}", out, pout, mask, pmask)
            row = {
                "case": label, "kernel": "tensordash_matmul_fused[v2/v1]" if fused
                else "tensordash_matmul_planned[v2/v1]", "grid": grid,
                "dtype": str(dtype).replace("torch.", ""),
                "shape": f"[{m},{a.shape[1]}]@[{a.shape[1]},{n}]", "block": (bm, bk, bn),
                "max_abs_err": err, "ms": cuda_ms(lambda: run(grid)), "plain_ms": plain_ms,
                "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations", "main_path": main,
            }
            rows.append(row)
            log(f"  {label + ' ' + grid:<37} {row['dtype']:<8} {row['shape']:<28} kernel "
                f"{row['ms']:.4f} ms  plain {plain_ms:.4f} ms  torch.matmul {library_ms:.4f} ms  "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})  max_abs_err {err:.3e}  "
                f"== ragged")

    bf16 = torch.bfloat16
    x = torch.randn(SLOTS, 4096, generator=gen).to(dev, bf16)
    w_gate = (torch.randn(4096, 11008, generator=gdev, device=dev) / 64).to(bf16)
    grid_case("decode gate (fused relu)", True, bf16, x, w_gate, SLOTS, 512, 128,
              T.dense_plan_csr(1, 8, dev), main=True)
    del w_gate
    h = block_sparse(SLOTS, 11008, SLOTS, 128, 0.4, gen).to(dev, bf16)
    w_down = (torch.randn(11008, 4096, generator=gdev, device=dev) / 105).to(bf16)
    hmask = (h.reshape(1, SLOTS, 86, 128) != 0).any(dim=3).any(dim=1).to(torch.int8)
    grid_case("decode w_down (emitted-mask plan)", False, bf16, h, w_down, SLOTS, 128, 128,
              T.plan_from_mask_csr(hmask), main=True)
    del w_down

    m, k, n, bm, bk, bn = 256, 1024, 384, 32, 64, 64
    for dtype in (torch.float32, bf16):
        a = block_sparse(m, k, bm, bk, 0.4, gen, zero_every=7).to(dev, dtype)
        b = torch.randn(k, n, generator=gen).to(dev, dtype)
        plan = T.plan_blocks_csr(a, bm, bk)
        col = torch.arange(n) // bn
        bias = (torch.randn(n, generator=gen) - 1e4 * (col % 3 == 0)).to(dev)
        res = torch.randn(m, n, generator=gen).to(dev, dtype)
        grid_case("sparse 0.4 planned", False, dtype, a, b, bm, bk, bn, plan)
        grid_case("sparse 0.4 fused relu+bias", True, dtype, a, b, bm, bk, bn, plan, bias=bias)
        for act in ("none", "relu", "squared_relu"):
            grid_case(f"sparse 0.4 fused {act}+bias+res", True, dtype, a, b, bm, bk, bn, plan,
                      bias=bias, residual=res, activation=act)

    def mask_case(label, x, bm, bk, main=False):
        mask, want = block_zero_mask(x, bm=bm, bk=bk), ref.block_any_nonzero(x, bm, bk)
        torch.cuda.synchronize()
        if not torch.equal(mask, want):
            raise AssertionError(f"block_zero_mask {label}: differs from the plain version")
        mb, kb = x.shape[0] // bm, x.shape[1] // bk
        # what this data needs: every element of an all-zero block, one
        # element of a block that has a nonzero, and the mask written
        zero = int((want == 0).sum())
        reads = zero * bm * bk + (mb * kb - zero)
        nbytes = reads * x.element_size() + mb * kb
        t_bytes, t_ops = nbytes / bw * 1e3, reads / COMPARE_RATE * 1e3
        row = {
            "case": label, "kernel": "block_zero_mask", "dtype": str(x.dtype).replace("torch.", ""),
            "shape": f"[{x.shape[0]},{x.shape[1]}] strides {tuple(x.stride())}", "block": (bm, bk),
            "zero_blocks": zero, "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: block_zero_mask(x, bm=bm, bk=bk)),
            "plain_ms": cuda_ms(lambda: ref.block_any_nonzero(x, bm, bk), iters=5),
            "library_ms": cuda_ms(lambda: torch.count_nonzero(x.reshape(mb, bm, kb, bk), dim=(1, 3))),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "main_path": main,
        }
        rows.append(row)
        log(f"  block_zero_mask {label:<21} {row['dtype']:<8} {row['shape']:<34} kernel "
            f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  torch.count_nonzero "
            f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})  "
            f"{row['zero_blocks']}/{mb * kb} zero blocks, exact")

    xw = torch.randn(4096, 11008, generator=gdev, device=dev).to(bf16)
    planted = torch.rand(32, 86, generator=gdev, device=dev) < 0.3  # 128 x 128 zero blocks
    xw = (xw.reshape(32, 128, 86, 128) * ~planted[:, None, :, None]).reshape(4096, 11008)
    mask_case("planted zero blocks", xw, 128, 128)
    del xw
    lm_head = (torch.randn(4096, 102400, generator=gdev, device=dev) / 64).to(bf16)
    mask_case("LM head lm_head.T", lm_head.T, 128, 512, main=True)
    return rows


# ---------------------------------------------------------------------------
# tune phase
# ---------------------------------------------------------------------------


def tune_phase():
    """Tune the full-width decode FFN products on the card into a DB in a
    temporary directory; check that v2 and v1 candidates ran and passed."""
    import torch
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.tune import TuningDB, platform_of, search

    platform = platform_of("cuda")
    path = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_")) / "TUNING_db_torch.json"
    db = TuningDB(path, platform=platform)
    t0 = time.perf_counter()
    for m, k, n, _ in TUNE_CELLS:  # the analytic prior's accelerator model, cold
        for d in search.STANDARD_DENSITIES:
            search._modeled_speedup(k, n, d)
    prior_s = time.perf_counter() - t0
    trials, lines = [], []
    T.reset_launch_counts()
    t0 = time.perf_counter()
    for m, k, n, op in TUNE_CELLS:
        search.tune_cells(db, ((m, k, n),), ops=(op,), dtype=torch.bfloat16, backend="cuda",
                          device="cuda", log=lines.append, trials=trials)
    tune_s = time.perf_counter() - t0
    launches = T.launch_counts()
    db.save()
    families = {}
    for fam in ("ragged", "v2", "v1"):
        mine = [t for t in trials if t["compact_grid"] == fam]
        passed = [t for t in mine if "us" in t]
        families[fam] = {"measured": len(passed), "rejected": len(mine) - len(passed)}
    winners = {}
    for key, pol in db.entries().items():
        winners[key.encode()] = (pol.bm, pol.bk, pol.bn, pol.compact_grid, pol.measured_us,
                                 pol.default_us)
        fam = families[pol.compact_grid]
        fam["winner"] = fam.get("winner", 0) + 1
    log(f"tune: {len(TUNE_CELLS)} shapes x {len(search.STANDARD_DENSITIES)} densities on {platform!r} "
        f"in {tune_s:.1f} s (accelerator-model prior {prior_s:.2f} s cold); DB {path} "
        f"({len(db)} cells)")
    for fam, c in families.items():
        log(f"tune: {fam:<6} {c['measured']} candidates measured and gated, {c['rejected']} "
            f"rejected, winner of {c.get('winner', 0)} cells")
    for key, w in winners.items():
        log(f"tune:   {key} -> bm {w[0]} bk {w[1]} bn {w[2]} {w[3]}  {w[4]:.1f} us "
            f"(default {w[5]:.1f} us)")
    log(f"tune: launches {launches}")
    for fam in ("v2", "v1"):
        if launches[f"tensordash_matmul_planned[{fam}]"] < 1 or families[fam]["measured"] < 1:
            raise AssertionError(f"tune: no {fam} candidate ran on the card and passed the gate")
    return db, {"families": families, "winners": winners, "launches": launches,
                "tune_s": tune_s, "prior_s": prior_s, "log": lines, "trials": trials}


# ---------------------------------------------------------------------------
# serve-auto phase
# ---------------------------------------------------------------------------


def pinned_v2_db(cfg, platform: str):
    """A DB whose FFN cells (gate and ``w_down``, every prefill and decode
    row bucket) pin the explicit runtime's geometry on the v2 grid."""
    import torch
    from repro_torch.tune import TunedPolicy, TuningDB

    db = TuningDB(platform=platform)
    pol = TunedPolicy(bm=128, bk=512, bn=128, compact_grid="v2", backend="cuda", source="pinned")
    d, d_ff = cfg.d_model, cfg.d_ff
    for rows in (1 << i for i in range(10)):
        for op, k, n in (("matmul_fused", d, d_ff), ("matmul", d_ff, d)):
            db.store(db.key(op=op, m=rows, k=k, n=n, dtype=torch.bfloat16), pol)
    return db


def serve_auto_phase(params, cfg, prompts, tuned_db, ragged_tokens):
    """The serve phase's requests under ``Runtime(geometry="auto")``: with
    the tuned DB, then with the v2-pinned DB (v2 kernels on the path, the
    ragged serve's tokens exactly)."""
    import torch
    from repro_torch import runtime as rtm

    runs = {}
    for name, db in (("tuned", tuned_db), ("pinned_v2", pinned_v2_db(cfg, tuned_db.platform))):
        rt = rtm.Runtime(backend="cuda", device="cuda", geometry="auto", tuning_db=db)
        out, launches, st, wall, decode_s, groups, decode_syncs, syncs = drive_serve(
            params, cfg, prompts, rt)
        if sorted(len(v) for v in out.values()) != [NEW_TOKENS] * REQUESTS:
            raise AssertionError(f"serve-auto {name}: tokens per request {[len(v) for v in out.values()]}")
        d, d_ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
        dt = torch.bfloat16
        # the decode call sites and the (bm, bk, bn, grid) they resolve to;
        # w_down brings the emitted-mask plan, so only (bn, grid) are tuned there
        gate = rt._resolved("matmul_fused", (SLOTS, d), (d, d_ff), dt)
        w_down = rt._resolved("matmul", (SLOTS, d_ff), (d_ff, d), dt, plan="the emitted-mask plan")
        head = rt._resolved("matmul", (SLOTS, d), (d, v), dt)
        resolved = {"gate": (gate.bm, gate.bk, gate.bn, gate.compact_grid),
                    "w_down (bn, grid)": (w_down.bn, w_down.compact_grid),
                    "lm_head": (head.bm, head.bk, head.bn, head.compact_grid)}
        steps = st["steps_run"]
        runs[name] = {
            "tokens": st["tokens_out"], "wall_s": wall, "tok_per_s": st["tokens_out"] / wall,
            "decode_steps": steps, "ms_per_decode_step": decode_s / steps * 1e3,
            "launches": launches, "resolved": resolved, "same_tokens_as_ragged": out == ragged_tokens,
            "host_syncs_per_decode_step_in_chunks": decode_syncs / steps,
            "host_syncs_per_decode_step_whole_run": syncs / steps,
            "db": tuned_db.stats() if name == "tuned" else db.stats(),
        }
        log(f"serve-auto {name}: {st['tokens_out']} tokens in {wall:.3f} s = "
            f"{st['tokens_out'] / wall:.2f} tok/s; {decode_s / steps * 1e3:.3f} ms per decode "
            f"step; decode sites resolve to {resolved}; launches {launches}; host syncs per "
            f"decode step {decode_syncs / steps:.3f} inside decode chunks, {syncs / steps:.3f} "
            f"in the whole run; tokens == ragged serve: {out == ragged_tokens}")
        if name == "pinned_v2":
            calls = len(groups) + steps
            for wrapper, per_call in (("fused", cfg.num_layers), ("planned", cfg.num_layers)):
                got = launches[f"tensordash_matmul_{wrapper}[v2]"]
                if got != per_call * calls:
                    raise AssertionError(f"serve-auto pinned: {got} v2 {wrapper} launches, "
                                         f"path implies {per_call * calls}")
            if out != ragged_tokens:
                raise AssertionError("serve-auto pinned: greedy tokens differ from the ragged serve's")
    return runs


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository (src/repro_torch missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    bw = mem_bandwidth(name)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"memory bound at {bw / 1e12:.2f} TB/s")
    from repro_torch.kernels import _build

    _build.library()
    log(f"build: nvcc sm_90a kernels ready in {_build.build_seconds:.1f} s")

    log("kernels: each against its plain PyTorch version on the card")
    rows = kernel_phase(bw)
    params, cfg, prompts, serve = serve_phase()
    ref_l2, top1 = reference_phase(params, cfg, prompts)
    log("grid kernels: v2/v1 against the ragged kernel and the plain version; block_zero_mask")
    grid_rows = grid_kernel_phase(bw)
    tuned_db, tune = tune_phase()
    auto = serve_auto_phase(params, cfg, prompts, tuned_db, serve["greedy_tokens"])

    pinned = auto["pinned_v2"]["launches"]
    path_launches = {
        "tensordash_matmul_fused": serve["launches"]["tensordash_matmul_fused"],
        "tensordash_matmul_planned": serve["launches"]["tensordash_matmul_planned"],
        "tensordash_matmul_fused[v2/v1]": pinned["tensordash_matmul_fused[v2]"]
        + pinned["tensordash_matmul_fused[v1]"],
        "tensordash_matmul_planned[v2/v1]": pinned["tensordash_matmul_planned[v2]"]
        + pinned["tensordash_matmul_planned[v1]"],
        "block_zero_mask": pinned["block_zero_mask"],
    }
    kernels = []
    for kname in REPLACES:
        mine = [r for r in rows + grid_rows if r["kernel"] == kname]
        head = next(r for r in mine if r["main_path"])  # the first main-path decode shape
        kernels.append({
            "name": kname, "route": "cuda",
            "source": SOURCE if kname != "block_zero_mask" else "src/repro_torch/kernels/csrc/block_mask.cu",
            "replaces": REPLACES[kname], "launches": path_launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
        })
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "cases": rows + grid_rows, "serve": serve, "reference_rel_l2": ref_l2,
         "reference_top1": top1, "tune": tune, "serve_auto": auto,
         "seconds": time.perf_counter() - t_start}, indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
