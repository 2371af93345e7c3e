#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA Hopper card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one H100.
``python3 chip_smoke.py --profiler-stress N`` instead runs only
:func:`profiler_stress` (N sessions each way).  With no arguments it

1. prints the card (``nvidia-smi`` name and power limit), builds the CUDA
   kernels from ``src/repro_torch/kernels/csrc`` (timed) and prints
   ptxas's registers, spills and static shared memory per kernel;
2. holds each kernel against its plain PyTorch version on the card, at the
   serving main path's decode shapes (4 slots, bf16, full deepseek-7b
   widths), at its prefill shapes (the gate and ``w_down`` at M = 128 rows
   and at a prime M = 29, ``bm = M``) and at small block-sparse shapes in
   fp32 and bf16, and times the kernel, the plain version and one
   ``torch.matmul`` of the same product (each row prints its ratio to that
   call and its share of the bound), and at the MoE experts' ``w_down``
   (qwen3-moe widths, a plan by value at ``bm`` = the capacity: a routed
   decode slot, a prefill capacity of 10 with pad rows, and an expert no
   token reached, whose empty plan must write zeros) and at deepseek-v2's
   decode shapes (the dense first block's gate [4,5120]@[5120,12288] and its
   ``w_down`` on the gate's emitted mask, an expert's ``w_down``
   [1,1536]@[1536,5120] routed and empty, the LM head side B [102400,5120])
   and at the SSM, hybrid, starcoder2, gemma2 and qwen2-vl LM heads side B
   ([50280,1536] at the fitted block 120 x 512, [32000,2560],
   [49152,3072] and [152064,8192] at 128 x 512, [256000,2304] at 128 x
   384), dense and with 40% of the head's blocks zero, and at the decode
   gates of gemma2-ReLU [4,2304]@[2304,9216] (bk 384) and qwen2-vl-ReLU
   [4,8192]@[8192,29568] (bk 512), each ``w_down`` on the emitted mask as
   the runtime plans it (bk 512; qwen2-vl's 128, its fitted 462 being no
   multiple of 128);
   then counts, with the profiler, the CUDA launches of a few calls of each
   wrapper: exactly one per call;
   then the sampler (``sampler_phase``): ``td_sample_kernel``, JAX's
   per-slot key split and Gumbel-max draw, bit-equal (tokens and keys) to
   its plain version on the card at 4 slots x vocab 102400, 151936, 152064
   and 256000, temperatures 0.8 and 1.0, the decode step's and the
   admission's scaling, plain rows and rows with two NaNs, a tie and a
   skipped slot; each vocabulary timed against the plain version and
   ``torch.multinomial`` on the rows' softmax (another stream), with its
   bound; one device launch a call; its fixed cost: a launch that does
   nothing (the spin kernel asked for no cycles), every slot skipped, and 4
   rows at the six served vocabularies with the line through them;
   then the init phase (``init_phase``): ``td_normal_kernel``, JAX's
   ``jax.random.normal`` draws behind ``init_params``, against its plain
   version on the card (an odd leaf, a layer of deepseek-7b's stacked
   ``w_gate``, a TP-4 rank's columns and rows, a slice of qwen3-moe's
   stacked ``w_gate`` at layer 7 whose counters pass 2**32; bf16 equal,
   fp32 within 4 ulps), JAX's literal draws reproduced, and full-width
   deepseek-7b's ``init_params`` (212 launches, the main path) timed
   against its bound beside the old ``torch.randn`` initializer;
   then the core phase: the schedule kernel (``td_schedule_kernel``)
   bit-equal to its plain loop (``sel``, ``advance``, ``n_cycles``) on 64
   seeded streams of 4096 rows at each of six densities, one- and
   two-side, lookahead 1 and 2, ``simulate_macs`` on the card (the plain
   loop's cycles, the accumulator within 1e-5 of a float64 ``sum(a*b)``
   relative to ``sum |a*b|``), both timed; the tile kernel
   (``td_tile_kernel``, the paper's cycle model) equal to its plain loop at
   PE rows 1 to 100, 16 and 8 lanes, lookahead 1 and 2, a tile a warp and
   as many as a warp holds, rows staged and loaded as needed, and on a
   ragged batch of 1000 tiles in one launch, each batch timed with its
   clocks a cycle beside other packings; then, counted as this slice's
   main path, the port's quickstart example
   (``repro_torch.examples.quickstart``, its ``main`` on the card, equal to
   its run on the host), the codec on full-width deepseek-7b ``w_down``
   [11008, 4096] bf16 magnitude-pruned to half (``encode`` on the card,
   ``decode``, bit-exact; encode and decode seconds, the kernel's ms on its one stream of 2 818 048
   rows, split into 2048 segments, the plain loop's ms a row at 4096 rows,
   the compressed bytes), the
   public ops and ``Runtime.sparse_ffn`` at deepseek-7b's FFN widths at 4
   and 128 rows in bf16 (each within the kernel tolerance of its plain
   version, each product one launch, one ``emitted`` plan for ``w_down``),
   and ``Runtime(validate="full")``: a ``corrupt_cache_entry`` evicted by
   ``scrub``, a corrupt caller plan warned about and replanned (output
   bit-equal to the clean plan's), ``check_plan``'s host ms at each level on
   the LM head's 800-row plan, and deepseek-7b-ReLU cut to 2 layers served
   through the decode graph under ``validate="boundary"`` (the eager run's
   tokens, no check while capturing), and the cycle model on the card:
   ``speedup_from_densities`` over deepseek-7b's 30 FFN layers (one tile
   launch, the host's dict exactly, both timed), the Fig. 17/18 rows sweep
   and deepseek-7b's FFN convolution over its whole workload, each equal to
   the host's; then the whole ``w_down`` stream's split schedule bit-equal
   to one thread walking it, both timed (the walk gives the clocks a cycle);
3. serves full-width deepseek-7b (30 layers, ReLU FFN, bf16, JAX's
   ``PRNGKey(0)`` weights) through ``ServeEngine`` on the ``cuda``
   backend, the decode chunk eager, and checks that every FFN gate, ``w_down`` and LM-head
   product and every plan went through the kernels, as many times as the
   path implies (one planner launch per ``w_down`` plan, one for the LM
   head's), that no plain executor and no planner chain ran and no decode
   chunk synced the host; then serves the same requests with the chunk as
   one CUDA graph: the eager run's greedy tokens exactly, one capture over
   a run with backfill, whose launches are one chunk's (the wrappers count
   a capture once; the card runs it at every replay: the profiler counts
   one replay's device launches, each kernel's equal to the capture's), a
   replay for every chunk after the eager warm-up, no host sync in a
   replayed chunk; then,
   through the graph, ``nan_logits@1:slot=0`` and ``inf_logits@1:slot=2``:
   the watchdog retires the poisoned request (``"error"``), every other
   request's tokens equal the clean graph run's, one ``retire-slot`` event,
   no recapture; prints ms per decode step and tokens/s of both runs;
4. compares the same prompts' prefill logits with the ``reference``
   backend on the card; then serves the same requests at temperature 0.8
   (``sampled_serve_phase``, JAX's per-request key streams): eagerly, one
   sampler launch a model call beside the path's launches and no host sync
   in a chunk; again with the plain sampler in the kernel's place (the same
   tokens); through the decode graph (the eager run's tokens, one capture,
   the sampler replayed once a decode step, no host sync in a replay); with
   ``nan_logits@1:slot=0`` through the graph (healthy requests' tokens
   equal the clean run's); ms per decode step against the greedy runs';
5. holds the v2/v1 grid kernels, planned and fused, bit-equal to the
   ragged kernels at the same geometry and within tolerance of the plain
   versions at the decode shapes and small block-sparse shapes, and
   ``block_zero_mask`` (the planner kernel's mask mode) exactly equal to its
   plain version, timed beside ``torch.count_nonzero``;
6. tunes the full-width decode FFN products on the card with
   ``repro_torch.tune.tune_cells`` (a DB in a temporary directory) and
   checks that v2 and v1 candidates ran and passed the numerics gate;
7. serves the same requests under ``Runtime(geometry="auto")`` twice: with
   the tuned DB, and with a DB that pins the FFN to the explicit geometry
   on the v2 grid, which must launch the v2 kernels and give the ragged
   serve's greedy tokens exactly; it counts host syncs per decode step;
   then drives the serve launcher, ``repro_torch.launch.serve.main``, in
   process at full width (8 requests, 4 slots, ``--inject-faults
   nan_logits@1:slot=0``): exit 0, mixed finish reasons, a
   ``retire-slot`` line, one capture; and once more with
   ``--no-cuda-graph`` (no capture), for its tokens/s beside the graph's;
8. serves full-width qwen3-moe-235b-a22b with a ReLU gate cut to 8 layers
   (bf16 experts, fp32 routers, seeded random weights; the deepseek weights
   freed first) with the same requests through ``ServeEngine``, eager and
   as one CUDA graph: the same greedy tokens, every expert's ``w_down`` one
   planned launch on one planner launch by value (128 x 8 of each a model
   call) as the path implies, no plain version, no host sync in a decode
   chunk; prints ms per decode step and tokens/s of both runs, peak memory,
   device launches per decode step by wrapper and the share of expert
   blocks the plans skip; then its prefill logits against ``reference``,
   held on the cuda run's routes (routing itself reported: the router's
   top-k flips where two experts tie within a rounding); then the same for
   full-width deepseek-v2-236b (multi-head latent attention, 160 experts
   top-6 with 2 shared, a dense first block) with a ReLU gate cut to 6
   layers: the dense block's fused gate, emitted plan and planned ``w_down``
   and 160 x 5 planned expert products on plans by value a model call, at
   least 0.85 of the expert blocks skipped at decode; then mamba2-780m (48
   Mamba2 layers) and zamba2-2.7b (54 Mamba2 layers in 9 groups, each after
   the shared attention block, tanh-GELU MLP) as registered, whole, with
   the same requests, eager and as one CUDA graph: the same greedy tokens,
   one planned LM-head launch and no fused one a model call, the head's
   ``values`` plan built once an engine at its fitted block, no host sync in
   a decode chunk, prefill logits within ``REF_REL_L2`` of ``reference``;
   ms per decode step against the bound from the bytes a step moves,
   tokens/s, peak memory, device launches per decode step; then, the same
   way, starcoder2-3b as registered (30 layers, a non-gated GELU FFN: the LM
   head alone on the kernels), gemma2-2b with a ReLU gate (26 layers,
   sliding-window attention on alternate layers, sandwich norms: 26 fused
   gates, emitted plans and planned ``w_down`` a model call) and one
   5120-token request past its 4096-token window, its decode logits held
   to a teacher-forced forward, and deepseek-7b-ReLU with the int8 KV cache
   at 1024 rows a slot: int8 K/V and fp32 scales at 0.516x the bf16 cache's
   bytes, its decode ms per step beside the bf16 cache's, its decode logits
   against the bf16 cache's within ``KV_REL_L2``; then the two frontend
   configs through the model entry points (``prefill``, ``decode_step``,
   ``forward``: the engine, as JAX's, serves tokens only): qwen2-vl-72b
   with a ReLU gate at full width cut to 24 layers (M-RoPE; 4 sequences of
   seeded embeddings, 32 text positions, a 1 x 12 x 16 image and 32 text
   positions at Qwen2-VL's rope index, then 16 eager decode steps in text
   mode) and musicgen-large whole (the same 256 + 16 positions, logits
   ``[4, 1, 4, 2048]`` from its four codebook heads): the wrapper launches
   the path's (qwen2-vl: 24 fused gates, 24 emitted plans and 25 planned
   products a model call, the head's ``values`` plan once; musicgen: none,
   JAX puts none of its products on a kernel), no plain version, prefill
   logits within ``REF_REL_L2`` of ``reference`` and the prefill's and
   every step's logits within it of a teacher-forced ``forward`` on
   ``dense``; prefill ms, decode ms per step against the bound from the
   bytes a step moves, peak memory, device launches per step;
9. holds the planned kernel at the training step's backward shapes (one
   microbatch of 1024 tokens at full widths, fp32 operands and transposed
   views, bf16 output: the gate's, ``w_down``'s and the LM head's ``da``
   and ``db``) against its plain version (fp32, rtol = atol = 2e-4), its
   bf16 store equal to one rounding of its fp32 result, v2/v1 bit-equal on
   two rows, each timed against one fp32 ``torch.matmul`` and its bound,
   the mamba2 head's two backward products at its block 120 and
   qwen2-vl-ReLU's four (the head's ``da``/``db`` at vocab 152064 x d 8192,
   ``w_down``'s at K = d_ff 29568 on the gate's mask at bk 128);
   ``block_zero_mask`` on the two fp32 cotangents; one device launch per
   wrapper call;
10. runs the one-launch planner in every mode: 693 edge cases (one block
   row, one K block, 86, 231 and 800 K blocks, several shared-memory stages,
   views off the 16-byte grid, NaN, bool and int8 masks, coarsen 2 / 4 /
   Nb and at 231 blocks 1 / 3 / 7 / 11), then the path's shapes (the decode
   and training gate masks, the LM-head weights ``lm_head.T`` in bf16
   (deepseek, SSM, hybrid, starcoder2, gemma2, qwen2-vl), gemma2's and
   qwen2-vl's gate masks at the coarsening the runtime fits for their
   ``w_down``, the fp32 ``w_down`` and LM-head
   cotangents, the three transposed forward plans of the weight
   gradients, the MoE experts' ``h[e]`` at capacity 1 and 10 and a pad
   row alone, the SSM and hybrid heads at block rows 120 and 128, the
   former also with 40% of its blocks zero), each plan's five int32 arrays bit-equal to the plain chain
   on the card; each path shape timed (device ms and host wall per call)
   beside the chain, the unfused path on the card (the mask kernel, then the
   chain's compaction; its device launches per call) and
   ``torch.count_nonzero``, with its bound; one device launch per
   planner call;
11. trains deepseek-7b-ReLU at full width cut to 4 layers (bf16 params,
   fp32 AdamW moments; 30 layers of that state would not fit the card's 80
   GB) through ``make_train_step`` on the ``cuda`` backend: step 1's loss
   and gradients against the ``dense`` backend on the card (loss within
   2^-7 relative, each gradient within relative L2 2^-5), 3 timed steps
   (ms, tokens/s, peak memory, loss, grad_norm, taps) whose kernel launches
   and plan-cache hits and misses must equal what the path implies (remat's
   recompute included; each plan one planner launch) with no plain executor
   or planner chain run, two profiled steps
   (device time by kernel), and a ``guard_nonfinite`` step with poison 2
   that must leave params and optimizer state unchanged; then mamba2-780m
   and zamba2-2.7b whole (the deepest cut reckoned to fit; 8 x 256 tokens,
   two SSD chunks a sequence) through ``make_train_step`` on ``cuda``: taps
   refused, step 1's loss and gradient norm against ``dense``, 3 steps with
   the LM head's launches and plan-cache counts held to the path's, and one
   chunked 256-token prefill against ``reference``; then the frontends
   (``frontend_train_phase``): qwen2-vl-72b-ReLU at full width cut to 1
   layer and the head (``train_cut``) and musicgen-large whole, on 8 x 256
   seeded embeddings (qwen2-vl's at Qwen2-VL's rope index of the image
   prompt) in 2 microbatches: step 1's loss and every gradient against
   ``dense`` (the worst leaf reported), 3 timed steps with the launches and
   plan-cache counts of the path (qwen2-vl: the fused gate, its emitted
   plan, the planned ``w_down`` and head and their backward products;
   musicgen none), every loss finite, no plain version; ms a step, tokens/s,
   peak memory; then the examples phase (``examples_phase``): each of the
   port's five examples through its ``main`` at its documented command
   (``serve_batched`` greedy and sampled, ``train_lm --preset 100m --steps
   300 --relu-ffn`` and its resume), the kernels its path reaches launched,
   no plain version, every loss finite, each run's wall seconds;
12. drives the train launcher, ``repro_torch.launch.train.main``, in process
   on full-width qwen3-4b (grouped-query attention with qk-norm, vocab
   151936) cut to 8 layers, 8 x 256 tokens in 2 microbatches, taps on:
   (a) 6 steps with a checkpoint at step 4 (bytes, save seconds, free disk);
   (b) a restart that must print ``resumed at step 4``, restore a tree whose
   per-tensor checksums equal the saved ones and print run (a)'s step-5
   line; (c) the ReLU variant under ``--dynamic-sparsity`` (RigL to 50%)
   with a NaN loss injected at step 1: the skipped step, three mask
   refreshes and their plan-edit ms, the LM-head plan the planner kernel
   built from the masked weight bit-equal to the controller's edited
   forward plan at every refresh, with blocks skipped, and every edited plan
   bit-equal to the planner's fresh plan of its mask; each step's launches
   held to the path's, no plain version run;
13. runs the sharded SpMM of ``repro_torch.parallel.spmm`` one rank after
   another on the card (NCCL refuses two ranks on one card, so no run
   across cards is made): each rank's local step of M (the LM head side B,
   40% of its blocks zero with a power-law skew, 4 shards dealt serpentine
   and contiguous), N (``w_down``, 4 shards; the fused gate at ``bn`` 128,
   2 shards), K (``w_down``, 2 shards, fp32 partials of bf16 operands) and
   of the train ``w_down``'s backward (``da`` M, ``db`` N, 4 shards), put
   together as the collective would: M and N bit-equal to the unsharded
   kernel, K within the kernel tolerance; each shard's kernel ms, work and
   the imbalance, the fp32 store's ms beside the bf16 store's; the
   expert-parallel decode branch of one full-width qwen3-moe MoE layer over
   4 ranks summed against the unsharded layer, with each rank's launches;
   the int8 rows of the all-to-all's payload against numpy's; then an NCCL
   group of world size 1: ``ef_compress_grads``, an int8 all-to-all and the
   quantized all-to-all against the local computation;
13b. runs the sharded model (``sharded_model_phase``): full-width
   deepseek-7b-ReLU's block under tensor parallel 4, each rank's attention
   and FFN body in turn (the FFN's local gate fused on the kernel, its
   emitted plan, its ``w_down`` rows on the fp32 store; one launch of each
   per rank and call), summed against the unsharded block at decode and
   prefill; 4 vocab slices of the LM head on side B bit-equal to the whole
   head, the vocab-parallel cross entropy against the unsharded loss; the
   backward of both (each rank's gradient slices put together against the
   unsharded gradients); on an NCCL group of one rank through
   ``make_local_mesh()``, the sharded train step and engine of the model cut
   to 4 layers against the unsharded ones; ``restore(shardings=)`` of the
   saved block on 4 gloo CPU ranks, bit-equal to ``local_shard``; each
   body's ms per rank, their sum against the unsharded block, the slowest
   rank;
13c. runs the sharded families (``sharded_family_phase``) under tensor
   parallel 4 at full width, each rank's local step in turn: deepseek-v2-ReLU's
   MLA (32 of 128 heads a rank, the latent whole) with its dense FFN (the
   gate fused on the kernel, the emitted plan, the ``w_down`` rows) and
   with its MoE (40 of 160 experts a rank, a ``values`` plan and a planned
   ``w_down`` each); one mamba2-780m layer (12 of 48 heads, the gated
   norm's statistic summed over the ranks); one zamba2-2.7b group (the
   shared block's 8 of 32 heads and 2560 of 10240 MLP columns, six Mamba2
   layers of 20 of 80 heads); one qwen2-vl-72b-ReLU layer over M-RoPE
   positions (16 of 64 heads, 2 of 8 kv heads); at decode and prefill, the
   ranks' outputs summed against the unsharded layer, every rank's kernel
   launches against their plain versions, one launch of each kind per rank
   and call; each family's 4 LM-head slices bit-equal to the whole head;
   then on an NCCL group of one rank the sharded engines of deepseek-v2
   cut to 2 layers, mamba2 and zamba2 against the unsharded ones and
   mamba2's sharded train step against the unsharded one; each body's ms
   per rank, their sum, the slowest rank against the unsharded layer;
13d. runs dynamic sparse training on a mesh (``sharded_dst_phase``):
   full-width deepseek-7b-ReLU's layer and LM head in fp32 with a controller
   refreshed once to 50% at 128-square blocks; under tensor parallel 4 and
   a (2, 2) data x model cut, each rank's slices in turn: the global shapes
   from its slices, its slices masked by its slices of the masks put
   together bit-equal to the masked whole, its partial block scores summed
   over the ranks within 1e-5 of each block's whole score and selecting the
   same masks; each rank's side-B ``values`` plans of its masked ``w_down``
   rows (2752 a rank, cutting through the 128-row mask blocks) and head
   slice, their skipped share beside the mask's sparsity, and its planned
   ``w_down`` launch against its plain version; then qwen3-4b-ReLU cut to 8
   layers, fp32, through ``make_train_step(dynamic_sparsity=)`` on an NCCL
   group of one rank against the unsharded run: masks and counts equal at
   every refresh, losses within 2**-7; step and refresh seconds;
13e. runs the dry-run phase (``dry_run_phase``): (a) the port's dry run,
   ``python -m repro_torch.launch.dryrun --all --mesh both``, started in
   the background (niced) after the build and collected here: all 64
   cells (32 a mesh, 16x16 and 2x16x16) ``ok`` with their per-rank bytes,
   FLOPs, collective bytes and roofline terms at H100 rates, the cells that
   do not fit 80 GB a rank logged, its wall time; (b) the dry run held to
   the card: its record of full-width deepseek-7b-ReLU cut to 4 layers,
   the train phase's batch, on a 1x1 mesh, against a real step on an NCCL
   group of one rank (argument bytes exactly the real parameters', AdamW
   moments' and batch's; the peak within 10% of ``max_memory_allocated``
   on the ``dense`` backend; the FLOPs equal to ``FlopCounterMode``'s; a
   ``cuda``-backend step against the roofline bound); (c) item 14e at full
   width: zamba2-2.7b with a 524288-row cache (48.3 GB of KV from a seed),
   one decode step unsplit and as 16 data ranks' parts in turn combined by
   ``seq_combine``: with bf16 weights one shared attention within relative
   L2 2**-7 and the step's argmax equal (its logits' distance beside the
   model's own bf16 noise), with the weights in fp32 the step's logits
   within 2**-7; the whole step's and one rank's part's ms, and one
   shared-attention invocation's, beside their byte bounds;
14. prints a ``kernels`` JSON line (the four SpMM entries; ``block_zero_mask``
   for the planner kernel in every mode and ``planner[values]``,
   ``planner[emitted]``, ``planner[transpose]`` for each mode;
   ``td_schedule_kernel`` and ``td_tile_kernel``, their launches the core and
   examples phases'; ``td_sample_kernel``, its launches the sampled serve
   runs' and the sampled example's, per decode step too; each with its
   launches over the serve runs (eager, graph, fault replays, the serve
   launcher, the MoE, MLA, SSM, hybrid, starcoder2, gemma2 and int8-cache
   runs and the qwen2-vl and musicgen runs; a captured launch counted once
   per replay; each of the last nine also alone), the timed training
   steps (deepseek, SSM, hybrid, qwen2-vl, musicgen; each per step also
   alone), the examples phase (also alone), launcher runs (a) and (c), the core
   phase's main path, on the serving path alone, per training step and per
   launcher step, and the sharded phase's local steps, the core phase, the
   sharded model phase, the sharded family phase and the sharded dst
   phase alone), the card
   line, and last the result
   line ``{"ok": true, "device": {...}}``; the full per-case table goes to
   ``chiprun_out/chip_smoke.json`` (git-ignored).

Any failed phase raises, and the script exits non-zero without the result
line.  It needs the checkout's ``src/`` and a CUDA card.
"""
from __future__ import annotations

import contextlib
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
PLANNER_SOURCE = "src/repro_torch/kernels/csrc/block_mask.cu"
SPMM = {
    "tensordash_matmul_fused": "src/repro/kernels/tensordash_spmm.py:506",
    "tensordash_matmul_planned": "src/repro/kernels/tensordash_spmm.py:481",
    "tensordash_matmul_planned[v2/v1]": "src/repro/kernels/tensordash_spmm.py:405",
    "tensordash_matmul_fused[v2/v1]": "src/repro/kernels/tensordash_spmm.py:450",
}
#: the planner kernel's launch counters, one per mode (``block_zero_mask`` is mode mask)
PLANNER = ("block_zero_mask", "planner[values]", "planner[emitted]", "planner[transpose]")
#: the kernels line: ``block_zero_mask`` stands for the planner kernel in every mode (its
#: launches) with its mask mode's times; each ``planner[mode]`` for one mode
REPLACES = {**SPMM, **dict.fromkeys(PLANNER, "src/repro/kernels/block_mask.py:24")}
#: one compare per element at the card's non-tensor fp32 rate (data sheet)
COMPARE_RATE = 67e12
#: prefill rows of the kernel phase: a full 4 x 32 prefill group and a prime
#: row count (Runtime.fit gives bm = M for both)
PREFILL_ROWS = (128, 29)
#: wrapper calls per case of the launch check
LAUNCH_REPS = 3
#: the training phase: deepseek-7b-ReLU at full width cut to TRAIN_LAYERS
#: layers (30 layers of bf16 params, fp32 gradient accumulators and fp32
#: AdamW moments need ~110 GB, more than the card's 80 GB; 4 layers make
#: 1.65 B params, ~26 GB of state), a global batch of TRAIN_BATCH x
#: TRAIN_SEQ tokens in TRAIN_MICRO microbatches of TRAIN_TOKENS tokens
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 8, 256, 2, 3
TRAIN_TOKENS = TRAIN_BATCH * TRAIN_SEQ // TRAIN_MICRO
#: cuda vs dense on step 1 (both bf16 forwards that sum blocks in other
#: orders, as REF_REL_L2 says for serving): loss relative, each leaf's
#: gradient relative L2
LOSS_REL, GRAD_REL_L2 = 2**-7, 2**-5
#: the MoE serve phase: qwen3-moe-235b-a22b with a ReLU gate at full width,
#: cut from 94 to MOE_LAYERS layers (94 layers of bf16 weights are ~467 GB;
#: 8 make ~42.3 GB), served as the deepseek-7b serve phase serves; a full
#: 4 x 32-token prefill group gives each expert MOE_PREFILL_CAP slots
MOE_ARCH, MOE_LAYERS, MOE_PREFILL_CAP = "qwen3-moe-235b-a22b", 8, 10
#: the MLA serve phase: deepseek-v2-236b with a ReLU gate at full width, cut
#: from 60 to DSV2_LAYERS layers (60 layers of bf16 weights are ~471 GB; 6,
#: the dense first block and 5 MoE blocks, make ~42.5 GB), served as the MoE
#: serve phase serves
DSV2_ARCH, DSV2_LAYERS = "deepseek-v2-236b", 6
#: the SSM and hybrid serve phases: mamba2-780m and zamba2-2.7b as
#: registered, whole (48 and 54 layers; ~1.7 and ~4.9 GB of bf16 weights),
#: served as the deepseek-7b serve phase serves; their LM head is the one
#: planned product of a model call
SSM_ARCH, HYBRID_ARCH = "mamba2-780m", "zamba2-2.7b"
#: the dense archs served whole: starcoder2-3b as registered (30 layers, a
#: non-gated GELU FFN: the LM head is its one planned product) and gemma2-2b
#: with a ReLU gate (26 layers, local/global sliding-window attention,
#: sandwich norms; the gated FFN takes the fused path), ~6.4 GB of bf16
#: weights each
STARCODER_ARCH, GEMMA_ARCH = "starcoder2-3b", "gemma2-2b"
#: gemma2's long request: 5 query chunks of 1024 prompt tokens and LONG_NEW
#: new ones, so each local layer masks keys more than its 4096-token window back
LONG_PROMPT, LONG_NEW = 5120, 16
#: the int8 KV cache phase: deepseek-7b-ReLU with ``kv_cache_quant`` at
#: KV_MAX_LEN cache rows a slot, so the cache is a visible share of a step's
#: bytes; its decode logits against the bf16 cache's within KV_REL_L2: JAX's
#: own test (tests/test_kv_quant.py) accepts an int8-cache decode within
#: rtol = atol = 0.08 of the full forward, up to 8% at every logit, and a
#: relative L2 of 0.08 allows the same error on average
KV_MAX_LEN, KV_REL_L2 = 1024, 0.08
#: the SSM and hybrid training phases: bytes a parameter of a bf16 model
#: trained with fp32 AdamW moments and gradient accumulators (the deepseek
#: train phase's 45.34 GB peak over its 1.65 B parameters), and the card
#: memory a cut in depth is reckoned against (80 GB less room for the step-1
#: comparison's two gradient sets and the activations)
TRAIN_BYTES_PER_PARAM, TRAIN_BUDGET_GB = 27.5, 72
#: the frontend phases, through the model entry points (the engine, as JAX's,
#: serves tokens only): qwen2-vl-72b with a ReLU gate at full width cut from
#: 80 to VL_LAYERS layers (80 layers of bf16 weights are ~143 GB; 24 make
#: 44.62 GB), and musicgen-large whole (4.87 GB); each prefills SLOTS
#: sequences of seeded embeddings, VL_TEXT text positions, an image of 1 x
#: VL_GRID patches and VL_TEXT text positions (qwen2-vl's positions are
#: Qwen2-VL's rope index), then decodes FRONTEND_NEW eager steps
VL_ARCH, VL_LAYERS, MG_ARCH = "qwen2-vl-72b", 24, "musicgen-large"
VL_TEXT, VL_GRID, FRONTEND_NEW = 32, (12, 16), 16
#: the sharded phase: the share of the LM head's blocks zero (a power-law
#: skew over its block rows) for the M-sharded local steps
SHARD_LM_ZERO = 0.4
#: the sharded model phase: deepseek-7b-ReLU's block and LM head at full
#: width under tensor parallel SM_TP, the ranks' local steps run in turn on
#: the one card: SM_ROWS decode rows over SM_PREFIX cached tokens, one
#: SM_PREFILL-token prefill, the backward at SM_TRAIN_TOKENS tokens; then the
#: whole sharded train step (SM_LAYERS layers, SM_BATCH x SM_SEQ tokens) and
#: engine (SM_REQUESTS prompts of SM_PROMPT tokens, SM_NEW new ones) on an
#: NCCL group of one rank (chunks of SM_CHUNK steps: a warm-up, a capture, replays)
SM_TP, SM_ROWS, SM_PREFIX, SM_PREFILL, SM_TRAIN_TOKENS = 4, 4, 32, 128, 1024
SM_LAYERS, SM_BATCH, SM_SEQ, SM_REQUESTS, SM_PROMPT, SM_NEW, SM_CHUNK = 4, 4, 256, 4, 32, 8, 3
#: the sharded family phase: one layer (or group) of deepseek-v2-ReLU,
#: mamba2-780m, zamba2-2.7b and qwen2-vl-72b-ReLU at full width under tensor
#: parallel SM_TP at the sharded model phase's decode and prefill shapes,
#: deepseek-v2's MoE at capacity factor SF_CAPACITY (no assignment dropped
#: by the unsharded layer or a rank's local step, so their sum is the layer);
#: on an NCCL group of one rank the engines (deepseek-v2-ReLU cut to
#: SF_DSV2_LAYERS layers: its dense first block and one MoE block) and
#: mamba2's train step at SF_BATCH x SF_SEQ tokens
SF_CAPACITY, SF_DSV2_LAYERS, SF_BATCH, SF_SEQ = 8.0, 2, 4, 256
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


def max_sm_clock_hz() -> float:
    """The card's highest SM clock as ``nvidia-smi`` gives it, in Hz (the
    H100 SXM data sheet's 1980 MHz where it gives none)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    try:
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except ValueError:
        return 1980e6


def ptxas_lines(report: str) -> list[str]:
    """One line per kernel of ``nvcc -Xptxas -v``'s report: registers,
    spill stores and loads, static shared memory (the ring is dynamic
    shared memory, sized per launch: each kernel row prints it)."""
    import re

    names = {"13__nv_bfloat16": "bf16", "f": "f32", "t": "u16", "j": "u32"}
    out, name, spill = [], None, ""
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name, spill = entry.group(1), ""
            t = re.search(r"\d+(td_[a-z_]+_kernel)I(13__nv_bfloat16|f|t|j)(.*)EEv", name)
            if t:
                args = ",".join(re.findall(r"L[bi](\d+)E", t.group(3)))
                name = f"{t.group(1)}<{names[t.group(2)]}{',' + args if args else ''}>"
            elif re.search(r"\d+(td_[a-z_]+_kernel)E", name):  # not a template
                name = re.search(r"\d+(td_[a-z_]+_kernel)E", name).group(1)
            elif (t := re.search(r"\d+(td_(?:schedule|tile)_kernel)I(.*?)EEv", name)):  # <table[, mode]>
                tab = re.search(r"(Tab16|TabRt)", t.group(2))
                args = ",".join(re.findall(r"L[bi](\d+)E", t.group(2)))
                name = f"{t.group(1)}<{tab.group(1) if tab else '?'},{args}>"
            elif (t := re.search(r"\d+(td_[a-z_]+_kernel)I((?:L[bi]\d+E)+)E", name)):  # <bool, ...>
                name = f"{t.group(1)}<{','.join(re.findall(r'L[bi](\d+)E', t.group(2)))}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if name and m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {m.group(1)} registers, {spill or 'no spill report'}, "
                       f"{smem.group(1) if smem else 0} B static smem")
            name = None
    return out


def versus(row) -> str:
    """A row's ratio to its one-call library time and its share of the bound."""
    return (f"{row['ms'] / row['library_ms']:.2f}x torch.matmul, "
            f"{row['bound_ms'] / row['ms']:.0%} of bound")


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


#: the plain versions no main-path run may call on the card: the SpMM
#: executors and the planner's torch chains (in ``kernels/ref.py``), the
#: sampler's (in ``kernels/sample.py``) and the normal fill's (in
#: ``kernels/normal.py``)
PLAIN = ("tensordash_matmul_ref", "tensordash_matmul_fused_ref", "plan_blocks_csr_ref",
         "plan_from_mask_csr_ref", "transpose_plan_csr_ref", "workqueue_ref", "block_any_nonzero")
PLAIN_SAMPLER = "sample_tokens_ref"
PLAIN_NORMAL = "normal_ref"


@contextlib.contextmanager
def no_plain_versions(what: str, allow: tuple = ()):
    """Fail ``what`` if it calls any of :data:`PLAIN` not named in
    ``allow``."""
    from repro_torch.kernels import normal, ref, sample

    mods = {**dict.fromkeys(PLAIN, ref), PLAIN_SAMPLER: sample, PLAIN_NORMAL: normal}
    calls, orig = [], {name: getattr(mods[name], name) for name in mods if name not in allow}

    def guard(name, fn):
        def wrapped(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return wrapped

    for name, fn in orig.items():
        setattr(mods[name], name, guard(name, fn))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(mods[name], name, fn)
    if calls:
        raise AssertionError(f"{what} ran plain versions: {sorted(set(calls))}")


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


def plan_bytes_flops(nnz, idx, a, b, bm, bk, *, out_elems, extra_bytes=0, out_esz=None):
    """Least bytes and operations of a planned product on this data: each
    effectual A block and each needed B row block read once, the output
    (``out_esz`` bytes an element, the operands' by default) and the
    metadata written/read once."""
    esz = a.element_size()
    out_esz = out_esz or esz
    nnz_h, idx_h = nnz.cpu(), idx.cpu()
    eff = int(nnz_h.sum())
    used_k = set()
    for r in range(idx_h.shape[0]):
        used_k.update(idx_h[r, : int(nnz_h[r])].tolist())
    n = b.shape[1]
    meta = 4 * (2 * nnz_h.numel() + 1 + max(eff, nnz_h.numel()))
    bytes_ = eff * bm * bk * esz + len(used_k) * bk * n * esz + out_elems * out_esz + meta + extra_bytes
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
    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref, tensordash_spmm as T

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)  # small operands, drawn on the host
    gdev = torch.Generator(device=dev).manual_seed(1)  # full-width weights, drawn on the card
    rows, calls = [], {}

    def run_case(label, kernel, dtype, a, b, bm, bk, bn, plan, *, bias=None, residual=None,
                 activation="relu", main=False, stage="small"):
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
        calls[f"{label} {row_dtype(dtype)}"] = call
        if stage == "decode":
            for grid in ("v2", "v1"):  # the grid families go through the same wrappers
                calls[f"{label} {grid}"] = family_call(kernel, grid, nnz, idx, a, b, bm, bk, bn,
                                                       bias, residual, activation)
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
            "main_path": main, "stage": stage,
            "tile": T.kernel_tile(bm, bk, bn, esz)._asdict(),
            "splits": T.launch_splits(m, a.shape[1], n, bm, bk, bn, dev, dtype),
        }
        row["ratio"], row["bound_share"] = row["ms"] / row["library_ms"], row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"  {label:<34} {row['dtype']:<8} {row['shape']:<28} kernel {row['ms']:.4f} ms  "
            f"plain {row['plain_ms']:.4f} ms  torch.matmul {row['library_ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})  {versus(row)}  "
            f"max_abs_err {err:.3e}  S {row['splits']}, ring {row['tile']['smem']} B")

    bf16 = torch.bfloat16
    # -- the main path's decode shapes: 4 slots, full deepseek-7b widths ------
    x = torch.randn(SLOTS, 4096, generator=gen).to(dev, bf16)
    w_gate = (torch.randn(4096, 11008, generator=gdev, device=dev) / 64).to(bf16)
    run_case("decode gate (fused relu)", "tensordash_matmul_fused", bf16, x, w_gate, SLOTS, 512, 128,
             T.dense_plan_csr(1, 8, dev), main=True, stage="decode")
    # prefill runs the same kernels at M = g * s rows, bm = M (Runtime.fit)
    for rows_m in PREFILL_ROWS:
        xp = torch.randn(rows_m, 4096, generator=gen).to(dev, bf16)
        run_case(f"prefill gate M={rows_m} (fused relu)", "tensordash_matmul_fused", bf16, xp, w_gate,
                 rows_m, 512, 128, T.dense_plan_csr(1, 8, dev), stage="prefill")
    del w_gate
    h = block_sparse(SLOTS, 11008, SLOTS, 128, 0.4, gen).to(dev, bf16)
    w_down = (torch.randn(11008, 4096, generator=gdev, device=dev) / 105).to(bf16)
    hmask = (h.reshape(1, SLOTS, 86, 128) != 0).any(dim=3).any(dim=1).to(torch.int8)
    run_case("decode w_down (emitted-mask plan)", "tensordash_matmul_planned", bf16, h, w_down,
             SLOTS, 128, 128, T.plan_from_mask_csr(hmask), main=True, stage="decode")
    for rows_m in PREFILL_ROWS:
        hp = block_sparse(rows_m, 11008, rows_m, 128, 0.4, gen).to(dev, bf16)
        pmask = (hp.reshape(1, rows_m, 86, 128) != 0).any(dim=3).any(dim=1).to(torch.int8)
        run_case(f"prefill w_down M={rows_m} (mask plan)", "tensordash_matmul_planned", bf16, hp,
                 w_down, rows_m, 128, 128, T.plan_from_mask_csr(pmask), stage="prefill")
    del w_down
    lm_head = (torch.randn(4096, 102400, generator=gdev, device=dev) / 64).to(bf16)
    hn = torch.randn(SLOTS, 4096, generator=gen).to(dev, bf16)
    a_t, b_t = lm_head.T, hn.T  # strided views, as Runtime.matmul(side="B") passes them
    run_case("decode LM head (side B, strided)", "tensordash_matmul_planned", bf16, a_t, b_t,
             128, 512, SLOTS, T.plan_blocks_csr(a_t, 128, 512), main=True, stage="decode")
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

    # -- block rows taller than a CTA's 256 rows, cut into slices ------------
    for m, bm, dtype in ((1024, 512, torch.float32), (1024, 512, bf16), (600, 300, bf16)):
        a = block_sparse(m, 512, bm, 64, 0.5, gen).to(dev, dtype)
        b = torch.randn(512, 128, generator=gen).to(dev, dtype)
        plan = T.plan_blocks_csr(a, bm, 64)
        bias = torch.randn(128, generator=gen).to(dev)
        run_case(f"tall rows bm={bm} planned", "tensordash_matmul_planned", dtype, a, b, bm, 64, 64, plan)
        run_case(f"tall rows bm={bm} fused relu+bias", "tensordash_matmul_fused", dtype, a, b, bm, 64, 64,
                 plan, bias=bias)

    # -- the MoE experts' w_down at qwen3-moe widths (d 4096, expert d_ff
    #    1536), planned by value at bm = the capacity (Runtime.fit): a routed
    #    decode slot, a prefill group's capacity with 3 pad rows, and an
    #    expert no token reached (its only slot the all-zero pad row)
    w_exp = (torch.randn(1536, 4096, generator=gdev, device=dev) / 39).to(bf16)
    for label, cap, pad, stage in (("moe w_down decode, routed", 1, 0, "moe decode"),
                                   (f"moe w_down prefill cap {MOE_PREFILL_CAP}", MOE_PREFILL_CAP, 3,
                                    "moe prefill"),
                                   ("moe w_down decode, empty plan", 1, 1, "moe decode")):
        he = (torch.clamp_min(torch.randn(cap, 1536, generator=gen), 0) * torch.randn(cap, 1536, generator=gen))
        he[cap - pad:] = 0
        he = he.to(dev, bf16)
        plan = T.plan_blocks_csr(he, cap, 512)
        run_case(label, "tensordash_matmul_planned", bf16, he, w_exp, cap, 512, 128, plan,
                 main=stage == "moe decode", stage=stage)
        if pad == cap:
            out = T.tensordash_matmul_planned(*plan[:2], he, w_exp, bm=cap, bk=512, bn=128, workqueue=plan[2:])
            if int(plan[0].sum()) != 0 or bool(out.any()):
                raise AssertionError(f"{label}: a pad-row expert must plan no block and write zeros")
    del w_exp

    # -- deepseek-v2-236b's decode shapes (d 5120, dense first block d_ff
    #    12288, expert d_ff 1536, vocab 102400) at the runtime's geometry:
    #    the dense gate on the all-effectual plan, its w_down on the gate's
    #    emitted mask coarsened from 128 to bk = 512 columns, each expert's
    #    w_down planned by value at bm = 1 (routed, and the empty plan), the
    #    LM head side B
    v2 = get_config(DSV2_ARCH)
    d, f, fe = v2.d_model, v2.d_ff, v2.moe_d_ff
    xd = torch.randn(SLOTS, d, generator=gen).to(dev, bf16)
    w_gate = (torch.randn(d, f, generator=gdev, device=dev) / d**0.5).to(bf16)
    w_up = (torch.randn(d, f, generator=gdev, device=dev) / d**0.5).to(bf16)
    dplan = T.dense_plan_csr(1, d // 512, dev)
    run_case("dsv2 dense gate (fused relu)", "tensordash_matmul_fused", bf16, xd, w_gate, SLOTS, 512, 128,
             dplan, stage="dsv2 decode")
    g, gmask = T.tensordash_matmul_fused(*dplan[:2], xd, w_gate, activation="relu", bm=SLOTS, bk=512, bn=128,
                                         workqueue=dplan[2:])
    h = g * (xd @ w_up)
    del w_gate, w_up
    w_down = (torch.randn(f, d, generator=gdev, device=dev) / f**0.5).to(bf16)
    run_case("dsv2 dense w_down (emitted-mask plan)", "tensordash_matmul_planned", bf16, h, w_down, SLOTS,
             512, 128, T.plan_from_mask_csr(gmask, coarsen=512 // 128), stage="dsv2 decode")
    del w_down
    w_exp = (torch.randn(fe, d, generator=gdev, device=dev) / fe**0.5).to(bf16)
    for label, pad in (("dsv2 expert w_down, routed", 0), ("dsv2 expert w_down, empty plan", 1)):
        he = torch.clamp_min(torch.randn(1, fe, generator=gen), 0) * torch.randn(1, fe, generator=gen)
        he = (he * (1 - pad)).to(dev, bf16)
        plan = T.plan_blocks_csr(he, 1, 512)
        run_case(label, "tensordash_matmul_planned", bf16, he, w_exp, 1, 512, 128, plan, stage="dsv2 decode")
        if pad and int(plan[0].sum()) != 0:
            raise AssertionError(f"{label}: a pad-row expert must plan no block")
    del w_exp
    lm_head = (torch.randn(d, v2.vocab_size, generator=gdev, device=dev) / d**0.5).to(bf16)
    a_t, b_t = lm_head.T, torch.randn(SLOTS, d, generator=gen).to(dev, bf16).T
    run_case("dsv2 LM head (side B, strided)", "tensordash_matmul_planned", bf16, a_t, b_t, 128, 512, SLOTS,
             T.plan_blocks_csr(a_t, 128, 512), stage="dsv2 decode")
    del lm_head, a_t

    # -- the LM heads side B at the runtime's fitted weight-side block (the
    #    largest divisors of the vocab <= 128 and of d_model <= 512: 120 x 512
    #    for mamba2's 50280 x 1536, 128 x 512 for zamba2's, starcoder2's and
    #    qwen2-vl's (152064 x 8192: 1188 block rows), 128 x 384 for gemma2's
    #    256000 x 2304), dense and with 40% of the head's blocks zeroed, so
    #    the kernel skips them
    for arch in (SSM_ARCH, HYBRID_ARCH, STARCODER_ARCH, GEMMA_ARCH, VL_ARCH):
        c = get_config(arch)
        d, v = c.d_model, c.vocab_size
        fit = rtm.Runtime(backend="cuda", device="cuda").fit((SLOTS, d), (d, v))
        bm, bk = fit.bn, fit.bk  # the side-B plan's blocking (Runtime.plan(side="B"))
        w = torch.randn(v, d, generator=gdev, device=dev) / d**0.5
        for pruned in (False, True):
            if pruned:
                keep = torch.rand(v // bm, d // bk, generator=gdev, device=dev) >= 0.4
                w = (w.reshape(v // bm, bm, d // bk, bk) * keep[:, None, :, None]).reshape(v, d)
            lm_head = w.to(bf16).T.contiguous()  # [d, v], as the model holds it
            a_t, b_t = lm_head.T, torch.randn(SLOTS, d, generator=gen).to(dev, bf16).T
            label = f"{tag_of(c)} LM head {bm}x{bk} (side B){', 40% zero' if pruned else ''}"
            run_case(label, "tensordash_matmul_planned", bf16, a_t, b_t, bm, bk, SLOTS,
                     T.plan_blocks_csr(a_t, bm, bk), stage=f"{tag_of(c)} decode")
            del lm_head, a_t
        del w

    # -- the dense ReLU gates at decode: gemma2-2b's [4,2304]@[2304,9216] on
    #    the all-effectual plan at the fitted bk 384, qwen2-vl-72b's
    #    [4,8192]@[8192,29568] at bk 512; each w_down on the gate's emitted
    #    mask as the runtime plans it (plan_for_fused_output: coarsened from
    #    128 to the fitted bk where that is a multiple of 128 dividing d_ff:
    #    gemma2's 512; qwen2-vl's fitted bk 462 is not, so its plan stays at 128)
    for arch in (GEMMA_ARCH, VL_ARCH):
        c = get_config(arch)
        d, f = c.d_model, c.d_ff
        rt = rtm.Runtime(backend="cuda", device="cuda")
        bk = rt.fit((SLOTS, d), (d, f)).bk
        xg = torch.randn(SLOTS, d, generator=gen).to(dev, bf16)
        w_gate = (torch.randn(d, f, generator=gdev, device=dev) / d**0.5).to(bf16)
        w_up = (torch.randn(d, f, generator=gdev, device=dev) / d**0.5).to(bf16)
        gplan = T.dense_plan_csr(1, d // bk, dev)
        run_case(f"{tag_of(c)} gate bk={bk} (fused relu)", "tensordash_matmul_fused", bf16, xg, w_gate, SLOTS, bk,
                 128, gplan, stage=f"{tag_of(c)} decode")
        g, gmask = T.tensordash_matmul_fused(*gplan[:2], xg, w_gate, activation="relu", bm=SLOTS, bk=bk, bn=128,
                                             workqueue=gplan[2:])
        h = g * (xg @ w_up)
        del w_gate, w_up
        w_down = (torch.randn(f, d, generator=gdev, device=dev) / f**0.5).to(bf16)
        plan = rt.plan_for_fused_output(gmask, h, w_down)
        run_case(f"{tag_of(c)} w_down bk={plan.bk} (emitted-mask plan)", "tensordash_matmul_planned", bf16, h,
                 w_down, SLOTS, plan.bk, 128,
                 (plan.nnz, plan.idx, plan.row_starts, plan.work_row, plan.work_kblk), stage=f"{tag_of(c)} decode")
        del w_down
    return rows, count_launches(calls)


def tag_of(cfg) -> str:
    """A config's short name in phase tags and row labels: the family for
    the SSM and hybrid configs, a frontend config's name without its size
    (``qwen2-vl``, ``musicgen``), else the name's first part."""
    if cfg.family in ("ssm", "hybrid"):
        return cfg.family
    return cfg.name.rsplit("-", 1)[0] if cfg.frontend else cfg.name.split("-")[0]


def row_dtype(dtype) -> str:
    return str(dtype).replace("torch.", "")


def family_call(kernel, grid, nnz, idx, a, b, bm, bk, bn, bias, residual, activation):
    """One wrapper call on the ``grid`` family (v2/v1 read ``idx``)."""
    from repro_torch.kernels import tensordash_spmm as T

    if kernel == "tensordash_matmul_fused":
        return lambda: T.tensordash_matmul_fused(nnz, idx, a, b, bias, residual, activation=activation,
                                                 bm=bm, bk=bk, bn=bn, compact_grid=grid)
    return lambda: T.tensordash_matmul_planned(nnz, idx, a, b, bm=bm, bk=bk, bn=bn, compact_grid=grid)


#: spin-kernel launches that open and close each profiler session, the host
#: pause in seconds inside the session before the first and after the last of
#: them, and the sessions opened before a count gives up
MARKERS, PAUSE_S, TRIES = 64, 0.05, 6


def marker_session(fn, reps: int, pause: float = PAUSE_S):
    """One ``torch.profiler`` session over ``reps`` calls of ``fn``,
    between :data:`MARKERS` spin-kernel launches that open it and as many
    that close it, with the card idle for ``pause`` seconds after the
    session starts and before it stops.  Returns ``(lead, trail, outside,
    counts)``: the opening and closing markers seen, the launches reported
    before the first marker or after the last, and ``{kernel: count}`` of
    the launches between the two runs of markers, or ``None`` when the
    session saw no marker on one side of them."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(pause)
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(pause)
    names = [e.name for e in sorted(
        (e for e in prof.events() if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start)]
    marker = ["spin_kernel" in n for n in names]
    if True not in marker:
        return 0, 0, names, None
    # the opening run of markers starts at the first marker, the closing
    # run ends at the last; what the session reports outside them (a
    # launch of an earlier session delivered late) is not this fn's
    first, last = marker.index(True), len(names) - 1 - marker[::-1].index(True)
    start, end = first, last
    while start < last and marker[start + 1]:
        start += 1
    while end > start + 1 and marker[end - 1]:
        end -= 1
    if start >= end:
        return start - first + 1, 0, names[:first] + names[last + 1:], None
    counts: dict[str, int] = {}
    for n in names[start + 1:end]:
        counts[n] = counts.get(n, 0) + 1
    return start - first + 1, last - end + 1, names[:first] + names[last + 1:], counts


def device_launches(fn, reps: int = LAUNCH_REPS) -> list[tuple[str, int]]:
    """``(kernel, count)`` of the device launches ``torch.profiler`` sees
    over ``reps`` calls of ``fn``, counted by :func:`marker_session`: the
    launches between the opening and the closing run of markers.  On torch
    2.11 a session after the first in a process was seen to drop its first
    launches (up to 12 of 16 opening markers, and once, with eight opening
    markers, two of the counted launches), to report no launch at all, or
    to report a broken closing run with launches after it.  So a count
    stands only when at least one opening and one closing marker came
    through: a dropped run of first (or last) launches then ended (or
    began) among the markers, and none between them was dropped.  With the
    card idle for :data:`PAUSE_S` at each end of the session no session
    reported nothing (150 of 150 against 147 of 150 without), but sessions
    late in a full run still lost their first 11 launches: hence 64
    markers a side.  A session that fails this is opened again, after the
    same pause, at most :data:`TRIES` times."""
    for _ in range(TRIES):
        lead, trail, outside, counts = marker_session(fn, reps)
        if (lead, trail) != (MARKERS, MARKERS) or outside:
            log(f"launches: the profiler saw {lead} of {MARKERS} opening and {trail} of {MARKERS} "
                f"closing marker launches, and {len(outside)} launches outside them "
                f"({sorted(set(n[:60] for n in outside))[:4]})")
        if counts is not None:
            return list(counts.items())
        time.sleep(PAUSE_S)
    raise AssertionError(f"the profiler dropped every opening or closing marker launch in {TRIES} sessions")


def profiler_stress(n: int) -> dict:
    """How often a marker session fails, with the card idle for
    :data:`PAUSE_S` at its ends and without: after the planner's edge
    cases, ``n`` sessions each way, interleaved, over one call of the
    decode gate mask's plain plan chain (38 launches), each after the
    timings the planner phase makes between two counts.  Prints and returns
    per pause the sessions with both runs of markers whole, those with no
    count, and the counts seen."""
    import collections

    import torch
    from repro_torch.kernels import ref, tensordash_spmm as T

    planner_edge_cases()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    mask = (torch.rand(1, 11008 // 128, generator=gen, device=dev) < 0.4).to(torch.int8)

    def call():
        return T.plan_from_mask_csr(mask, coarsen=1)

    def plain():
        return ref.plan_from_mask_csr_ref(mask, coarsen=1)

    seen: dict[float, list] = {0.0: [], PAUSE_S: []}
    for _ in range(n):
        for pause in seen:
            cuda_ms(call), host_ms(call), cuda_ms(plain, iters=5), host_ms(plain, iters=5)
            lead, trail, outside, counts = marker_session(plain, 1, pause=pause)
            seen[pause].append((lead, trail, len(outside), None if counts is None else sum(counts.values())))
    out = {}
    for pause, runs in seen.items():
        out[str(pause)] = {
            "sessions": len(runs), "full_brackets": sum(r[:3] == (MARKERS, MARKERS, 0) for r in runs),
            "no_count": sum(r[3] is None for r in runs),
            "counts": dict(collections.Counter(str(r[3]) for r in runs)),
            "leads": dict(collections.Counter(r[0] for r in runs)),
            "trails": dict(collections.Counter(r[1] for r in runs)),
        }
        log(f"profiler stress, pause {pause} s: {json.dumps(out[str(pause)])}")
    return out


def count_launches(calls: dict, kernel: str = "td_spmm_kernel") -> dict:
    """Exactly one CUDA launch per wrapper call: the profiler counts the
    device work of ``LAUNCH_REPS`` calls of each case (warm: every case ran
    before); all of it must be ``kernel`` launches, one per call (for the
    SpMM wrappers no split-K reduction kernel and no mask fill; for the
    planner no memset, no scatter, no second kernel)."""
    device = device_launches(lambda: [call() for call in calls.values()])
    n_calls = len(calls) * LAUNCH_REPS
    n_device = sum(c for _, c in device)
    others = [k for k, _ in device if kernel not in k]
    log(f"launches: {n_calls} wrapper calls ({len(calls)} cases x {LAUNCH_REPS}) made {n_device} "
        f"device launches, {sum(c for k, c in device if kernel in k)} of them {kernel}")
    if n_device != n_calls or others:
        raise AssertionError(f"wrapper calls {n_calls} != device launches {n_device}: {device}")
    return {"wrapper_calls": n_calls, "device_launches": n_device, "kernels": dict(device)}


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def graph_launch_log():
    """Record, for every decode-graph capture in this extent, the graph and
    the wrapper launches its capture made.  The wrappers count a captured
    launch once, at capture; the card runs it at every replay."""
    from repro_torch.serve import engine as E

    orig, seen = E._DecodeGraph.capture, []

    def capture(self, chunk, head):
        before = serve_launch_counts()
        orig(self, chunk, head)
        after = serve_launch_counts()
        seen.append((self, {k: after[k] - before[k] for k in after}))

    E._DecodeGraph.capture = capture
    try:
        yield seen
    finally:
        E._DecodeGraph.capture = orig


def serve_launch_counts() -> dict:
    """The wrapper launch counts of a serve run: the SpMM and planner
    wrappers' and the sampler's."""
    from repro_torch.kernels import sample, tensordash_spmm as T

    return {**T.launch_counts(), **sample.LAUNCHES}


def wrapper_of(kernel: str) -> str | None:
    """The wrapper a profiled kernel name belongs to (``planner`` for every
    planner mode; the v2 and v1 grids together; the sampler by its kernel's
    name), or None for a kernel of PyTorch or cuBLAS."""
    if "td_plan_kernel" in kernel:
        return "planner"
    if "td_sample_kernel" in kernel:
        return "td_sample_kernel"
    if "td_spmm_kernel<" not in kernel:
        return None
    _, fused, grid = (a.strip() for a in kernel.split("<", 1)[1].split(",")[:3])
    return f"tensordash_matmul_{'fused' if fused == 'true' else 'planned'}{'[v2/v1]' if grid == 'true' else ''}"


def by_wrapper(counts: dict) -> dict:
    """Wrapper counts keyed as :func:`wrapper_of` keys kernel names, zeros left out."""
    out: dict[str, int] = {}
    for k, v in counts.items():
        w = "planner" if k in PLANNER else k.replace("[v2]", "[v2/v1]").replace("[v1]", "[v2/v1]")
        if v:
            out[w] = out.get(w, 0) + v
    return out


def device_launches_of(counted: dict, seen: list) -> dict:
    """A run's device launches from the wrapper counts: each capture's
    launches run once per replay of its graph, not once."""
    out = dict(counted)
    for graph, delta in seen:
        for k, v in delta.items():
            out[k] += v * (graph.replays - 1)
    return out


def drive_serve(params, cfg, prompts, rt, *, cuda_graph=False, fault_plan=None, profile_replay=False,
                max_len=MAX_LEN, temperature=0.0, allow=()):
    """Serve ``prompts`` through a fresh ``ServeEngine`` of ``max_len`` cache
    rows a slot on ``rt`` (with a fresh plan cache) at ``temperature`` (seed
    0), the decode chunk eagerly or (``cuda_graph=True``) as one CUDA graph,
    under ``fault_plan``.
    Returns the tokens, the decode caches' bytes and leaf dtypes, the
    wrapper launch counts of
    the run (set to 0 just before it; a capture counted once), the device
    launches (a capture's times its replays), the launches of the capture,
    stats, wall seconds, prefill group sizes, decode chunks, seconds and
    host syncs (``torch.cuda`` sync debug warnings) by chunk kind (eager,
    warm-up, capture, replay), host syncs in the whole run, the requests
    and the resilience log.  With ``profile_replay`` the profiler then
    counts the device launches of one more replay of the engine's graph
    (``replay_kernels``; the engine is still alive, so are the buffers the
    graph reads).  Fails if a plain version not in ``allow`` ran."""
    import torch
    from repro_torch.kernels import sample, tensordash_spmm as T
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.resilience import ResilienceLog
    from repro_torch.runtime import PlanCache
    from repro_torch.serve.engine import ServeEngine

    rlog = ResilienceLog()
    rt = rt.replace(plan_cache=PlanCache())  # each run builds its LM-head plan once
    eng = ServeEngine(params, cfg, slots=SLOTS, chunk=CHUNK, max_len=max_len, rt=rt, temperature=temperature,
                      cuda_graph=cuda_graph, fault_plan=fault_plan, log=rlog)
    cache_leaves = tree_leaves(eng.caches)
    kinds = ("eager", "warm-up", "capture", "replay")
    groups, chunks, decode_s, decode_syncs = [], dict.fromkeys(kinds, 0), dict.fromkeys(kinds, 0.0), \
        dict.fromkeys(kinds, 0)
    admit, decode = eng._admit_group, eng._decode

    def counted_admit(placements):
        groups.append(len(placements))
        return admit(placements)

    def timed_decode():
        g = eng._graph
        kind = ("eager" if g is None else "replay" if g.graph is not None
                else "capture" if g.warm else "warm-up")
        torch.cuda.set_sync_debug_mode("default")  # the timing's own syncs are not counted
        torch.cuda.synchronize()
        t = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            out = decode()
            torch.cuda.set_sync_debug_mode("default")
        decode_syncs[kind] += sum("synchroniz" in str(w.message) for w in seen)
        torch.cuda.synchronize()
        decode_s[kind] += time.perf_counter() - t
        chunks[kind] += 1
        torch.cuda.set_sync_debug_mode("warn")
        return out

    eng._admit_group, eng._decode = counted_admit, timed_decode
    torch.cuda.reset_peak_memory_stats()
    with no_plain_versions("serve", allow), graph_launch_log() as captures:
        for p in prompts:
            eng.submit(p, max_new=NEW_TOKENS)
        T.reset_launch_counts()
        sample.reset_launch_counts()
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
        launches = serve_launch_counts()
    if len(captures) > 1:
        raise AssertionError(f"serve: {len(captures)} decode-graph captures in one engine")
    replay = dict(device_launches(eng._graph.graph.replay, reps=1)) if profile_replay else None
    return {"replay_kernels": replay, "out": out, "launches": launches, "device_launches": device_launches_of(launches, captures),
            "cache_bytes": sum(t.numel() * t.element_size() for t in cache_leaves),
            "cache_dtypes": sorted({str(t.dtype).replace("torch.", "") for t in cache_leaves}),
            "capture_launches": captures[0][1] if captures else None, "stats": eng.stats(),
            "wall": wall, "groups": groups, "chunks": chunks, "decode_s": decode_s,
            "decode_syncs": decode_syncs,
            "syncs": sum(decode_syncs.values()) + sum("synchroniz" in str(w.message) for w in seen),
            "requests": eng._requests, "log": rlog, "plans": eng.rt.plan_cache.plan_stats()}


def path_launches(cfg, calls: int, head_plans: int = 0, sampled: bool = False) -> dict:
    """The serving path's wrapper launches over ``calls`` model calls and
    ``head_plans`` LM-head plans (``sampled``: one sampler launch a call,
    each prefill group's first tokens and each decode step's).  Each call: per dense block with a ReLU
    gate a fused gate, a planned ``w_down`` and its emitted-mask plan
    (deepseek-7b: 30 each); per MoE block one planned ``w_down`` and one
    plan by value per expert (qwen3-moe: 128 each); the planned LM head (its
    plan cached).  A non-gated or non-ReLU dense FFN (starcoder2) and an SSM
    or hybrid model put no FFN on the runtime: the LM head alone.  The audio
    frontend's codebook heads are a plain einsum, as JAX computes them:
    musicgen (non-gated GELU) puts nothing on the runtime."""
    n_moe = cfg.num_layers - cfg.first_dense_layers if cfg.family == "moe" else 0
    fused = cfg.family in ("dense", "moe") and cfg.mlp_gated and cfg.activation == "relu"
    dense = cfg.num_layers - n_moe if fused else 0
    experts = n_moe * cfg.num_experts
    head = int(cfg.frontend != "audio")
    out = {"tensordash_matmul_fused": dense * calls,
           "tensordash_matmul_planned": (dense + experts + head) * calls,
           "planner[emitted]": dense * calls,
           "planner[values]": experts * calls + head_plans * head}
    if sampled:
        out["td_sample_kernel"] = calls
    return out


def check_eager_run(tag: str, cfg, run, sampled: bool = False) -> int:
    """The checks every eager serve run passes: the wrapper launches equal
    the path's over the run's model calls (prefill groups and decode steps;
    the LM head's plan built once), every request got its tokens, each in
    the vocabulary, and no eager decode chunk synced the host.  Returns the
    model calls."""
    out, launches, st = run["out"], run["launches"], run["stats"]
    calls = len(run["groups"]) + st["steps_run"]
    want = dict.fromkeys(launches, 0)
    want.update(path_launches(cfg, calls, head_plans=1, sampled=sampled))
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != path's {want}")
    if sorted(len(v) for v in out.values()) != [NEW_TOKENS] * REQUESTS:
        raise AssertionError(f"{tag}: tokens per request {[len(v) for v in out.values()]}")
    if any(t < 0 or t >= cfg.vocab_size for v in out.values() for t in v):
        raise AssertionError(f"{tag}: token outside the vocabulary")
    if run["decode_syncs"]["eager"]:
        raise AssertionError(f"{tag}: {run['decode_syncs']['eager']} host syncs inside eager decode chunks")
    return calls


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
    run = drive_serve(params, cfg, prompts, rt)
    out, launches, st, wall, groups = run["out"], run["launches"], run["stats"], run["wall"], run["groups"]
    calls = check_eager_run("serve", cfg, run)
    pc = st["plan_cache"]
    if pc["misses"] != 1 or pc["hits"] != calls - 1:
        raise AssertionError(f"LM-head plan cache {pc}, expected 1 miss and {calls - 1} hits")
    decode_s = run["decode_s"]["eager"]
    summary = {
        "tokens": st["tokens_out"], "wall_s": wall, "tok_per_s": st["tokens_out"] / wall,
        "decode_steps": st["steps_run"], "ms_per_decode_step": decode_s / st["steps_run"] * 1e3,
        "prefill_groups": len(groups), "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "plan_cache": pc,
        "greedy_tokens": out,
    }
    log(f"serve: {REQUESTS} requests x {NEW_TOKENS} new tokens, slots {SLOTS}, chunk {CHUNK}, eager decode "
        f"chunk: {summary['tokens']} tokens in {wall:.3f} s = {summary['tok_per_s']:.2f} tok/s; "
        f"{summary['ms_per_decode_step']:.3f} ms per decode step over {st['steps_run']} steps; "
        f"{len(groups)} prefill groups; peak memory {summary['peak_mem_gb']:.2f} GB; 0 host syncs "
        f"inside decode chunks")
    log(f"serve: kernel launches {launches} == path's (30 fused + 31 planned + 30 emitted-mask "
        f"plans per model call, {calls} calls; 1 values plan for the LM head); plan cache "
        f"{pc['hits']} hits / {pc['misses']} miss; no plain executor or planner chain ran")
    summary["graph"] = serve_graph_phase(params, cfg, prompts, rt, summary)
    summary["faults"] = serve_fault_phase(params, cfg, prompts, rt, summary["graph"])
    return params, cfg, prompts, summary


def first_difference(got: dict, want: dict):
    """The first (rid, token index) where two runs' tokens differ; token
    ``i`` of a request comes from its prefill when ``i == 0``, else from its
    decode step ``i - 1``."""
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        for i in range(max(len(a), len(b))):
            if i >= len(a) or i >= len(b) or a[i] != b[i]:
                return rid, i
    return None


def serve_graph_phase(params, cfg, prompts, rt, eager, tag: str = "serve graph", max_len: int = MAX_LEN,
                      temperature: float = 0.0):
    """The serve phase's requests with the decode chunk as one CUDA graph:
    the eager run's tokens exactly (greedy, or sampled at ``temperature``);
    one capture over a run with backfill; the capture's launches are one
    chunk's; a replay per chunk after the warm-up; no host sync inside a
    replayed chunk."""
    import torch

    sampled = temperature > 0.0
    key = "sampled_tokens" if sampled else "greedy_tokens"
    run = drive_serve(params, cfg, prompts, rt, cuda_graph=True, profile_replay=True, max_len=max_len,
                      temperature=temperature)
    out, st, groups = run["out"], run["stats"], run["groups"]
    diff = first_difference(out, eager[key])
    if diff is not None:
        rid, i = diff
        raise AssertionError(f"{tag}: tokens differ from the eager run's, first at request "
                             f"{rid} token {i} ({'prefill' if i == 0 else f'decode step {i - 1}'})")
    zero = dict.fromkeys(run["launches"], 0)
    want_capture = dict(zero, **path_launches(cfg, CHUNK, sampled=sampled))
    if st["decode_graph_captures"] != 1 or run["capture_launches"] != want_capture:
        raise AssertionError(f"{tag}: {st['decode_graph_captures']} captures, capture launches "
                             f"{run['capture_launches']} != one chunk's {want_capture}")
    # the card runs at each replay what the wrappers counted at capture
    replayed: dict[str, int] = {}
    for k, v in run["replay_kernels"].items():
        w = wrapper_of(k)
        if w is not None:
            replayed[w] = replayed.get(w, 0) + v
    if replayed != by_wrapper(run["capture_launches"]):
        raise AssertionError(f"{tag}: one replay's device launches {replayed} != the capture's "
                             f"{by_wrapper(run['capture_launches'])}")
    replay_total = sum(run["replay_kernels"].values())
    if st["decode_graph_replays"] != st["chunks_run"] - 1 or run["chunks"]["warm-up"] != 1:
        raise AssertionError(f"{tag}: {st['decode_graph_replays']} replays over {st['chunks_run']} "
                             f"chunks, {run['chunks']['warm-up']} warm-up chunks")
    # the wrappers count the prefills, the warm-up chunk and the capture once
    counted = len(groups) + 2 * CHUNK
    want = dict(zero, **path_launches(cfg, counted, head_plans=1, sampled=sampled))
    if run["launches"] != want:
        raise AssertionError(f"{tag}: launches {run['launches']} != path's {want}")
    pc = st["plan_cache"]
    if pc["misses"] != 1 or pc["hits"] != counted - 1:
        raise AssertionError(f"{tag}: LM-head plan cache {pc}, expected 1 miss and {counted - 1} "
                             "hits (the replays look up nothing)")
    if run["decode_syncs"]["replay"] or run["decode_syncs"]["warm-up"]:
        raise AssertionError(f"{tag}: host syncs inside decode chunks {run['decode_syncs']}")
    n_rep, n_warm = run["chunks"]["replay"], run["chunks"]["warm-up"] + run["chunks"]["capture"]
    replay_ms = run["decode_s"]["replay"] / (n_rep * CHUNK) * 1e3
    summary = {
        "tokens": st["tokens_out"], "wall_s": run["wall"], "tok_per_s": st["tokens_out"] / run["wall"],
        "decode_steps": st["steps_run"], "ms_per_decode_step_replayed": replay_ms,
        "ms_per_decode_step_all_chunks": sum(run["decode_s"].values()) / st["steps_run"] * 1e3,
        "ms_warmup_chunk": run["decode_s"]["warm-up"] * 1e3, "ms_capture_chunk": run["decode_s"]["capture"] * 1e3,
        "chunks": run["chunks"], "decode_syncs": run["decode_syncs"], "launches": run["launches"],
        "device_launches": run["device_launches"], "capture_launches": run["capture_launches"],
        "replay_launches": replayed, "replay_device_launches_all": replay_total,
        "captures": st["decode_graph_captures"], "replays": st["decode_graph_replays"], "plan_cache": pc,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "cache_bytes": run["cache_bytes"],
        "cache_dtypes": run["cache_dtypes"],
    }
    log(f"{tag}: {summary['tokens']} tokens in {run['wall']:.3f} s = {summary['tok_per_s']:.2f} tok/s "
        f"(eager {eager['tok_per_s']:.2f}); {replay_ms:.3f} ms per decode step over {n_rep} replayed chunks "
        f"(eager {eager['ms_per_decode_step']:.3f}); warm-up chunk {summary['ms_warmup_chunk']:.1f} ms, "
        f"capture chunk {summary['ms_capture_chunk']:.1f} ms ({n_warm} chunks); {key.replace('_', ' ')} == "
        "eager run's")
    log(f"{tag}: the profiler saw {replay_total} device launches in one replay "
        f"({replay_total / CHUNK:.0f} per decode step), {replayed} of them the port's kernels == the "
        "capture's wrapper launches")
    log(f"{tag}: captured once ({want_capture} launches, one chunk of the path), replayed "
        f"{st['decode_graph_replays']}x over {st['chunks_run']} chunks with backfill; wrapper launches "
        f"{run['launches']} == path's over {len(groups)} prefills + warm-up + capture; device launches "
        f"{run['device_launches']}; host syncs by chunk kind {run['decode_syncs']}; plan cache "
        f"{pc['hits']} hits / {pc['misses']} miss")
    summary[key] = out
    return summary


#: the fault replays through the graph: (plan, the poisoned slot)
SERVE_FAULTS = (("nan_logits@1:slot=0", 0), ("inf_logits@1:slot=2", 2))


def serve_fault_phase(params, cfg, prompts, rt, graph, faults=SERVE_FAULTS, temperature: float = 0.0):
    """Each of ``faults`` through the graph at ``temperature``: the poisoned
    slot's request finishes ``"error"`` by the watchdog, its tokens before
    the fault are the clean graph run's; every other request's tokens equal
    the clean graph run's; one ``retire-slot`` event; no recapture."""
    from repro_torch.resilience import FaultPlan

    clean, runs = graph["sampled_tokens" if temperature > 0.0 else "greedy_tokens"], []
    for spec, slot in faults:
        run = drive_serve(params, cfg, prompts, rt, cuda_graph=True, fault_plan=FaultPlan.parse(spec),
                          temperature=temperature)
        st, reqs = run["stats"], run["requests"]
        errs = [r for r in reqs.values() if r.finish_reason == "error"]
        events = [(e.kind, e.site, e.action, e.detail.get("slot")) for e in run["log"].events]
        if len(errs) != 1 or "watchdog" not in (errs[0].error or ""):
            raise AssertionError(f"serve fault {spec}: errored requests {[(r.rid, r.error) for r in errs]}")
        victim = errs[0]
        if events != [("nonfinite", "serve.decode.watchdog", "retire-slot", slot)]:
            raise AssertionError(f"serve fault {spec}: resilience events {events}")
        if victim.tokens != clean[victim.rid][:len(victim.tokens)] or len(victim.tokens) >= NEW_TOKENS:
            raise AssertionError(f"serve fault {spec}: the victim's tokens are not a clean prefix")
        others = {rid: toks for rid, toks in run["out"].items() if rid != victim.rid}
        if others != {rid: clean[rid] for rid in others} or not all(reqs[rid].ok for rid in others):
            raise AssertionError(f"serve fault {spec}: a healthy request's tokens differ from the clean run's "
                                 f"(first at {first_difference(others, {r: clean[r] for r in others})})")
        if st["decode_graph_captures"] != 1 or run["decode_syncs"]["replay"]:
            raise AssertionError(f"serve fault {spec}: {st['decode_graph_captures']} captures, "
                                 f"{run['decode_syncs']['replay']} host syncs in replayed chunks")
        log(f"serve fault {spec}{f' at temperature {temperature}' if temperature else ''}: request "
            f"{victim.rid} (slot {slot}) retired by the watchdog after "
            f"{len(victim.tokens)} clean tokens; {len(others)} others equal the clean graph run's; 1 retire-slot "
            f"event; captured once, replayed {st['decode_graph_replays']}x; device launches "
            f"{run['device_launches']}")
        runs.append({"spec": spec, "victim": victim.rid, "victim_tokens": len(victim.tokens),
                     "replays": st["decode_graph_replays"], "device_launches": run["device_launches"]})
    return runs


# ---------------------------------------------------------------------------
# the sampler: JAX's per-slot key step and Gumbel-max draw
# ---------------------------------------------------------------------------

#: the sampler phase: SLOTS rows at the vocabularies of the served models
#: (deepseek-7b 102400, qwen3 151936, qwen2-vl 152064, gemma2 256000), at two
#: temperatures, each in both scalings (the decode step's reciprocal, the
#: admission's division), on plain rows and on rows with a NaN, a tie and a
#: slot the step skips
SAMPLE_VOCABS = (102400, 151936, 152064, 256000)
#: the fixed-cost sweep: every vocabulary the port serves at SLOTS rows (the
#: hybrid's 32000, the SSM's 50280 besides the above)
SAMPLE_SWEEP = (32000, 50280, 102400, 151936, 152064, 256000)
SAMPLE_TEMPERATURES = (0.8, 1.0)
SAMPLE_SOURCE = "src/repro_torch/kernels/csrc/sample.cu"
#: the JAX engine's key split and categorical draw in its jitted decode step
SAMPLE_REPLACES = "src/repro/serve/engine.py:180"
#: the sampled serve runs' temperature (the serve_batched example's default)
SERVE_TEMPERATURE = 0.8
#: one draw's int32 operations: 20 Threefry rounds of add, funnel-shift
#: rotate and xor, 5 key injections of two adds, the output xor, the
#: mantissa's shift and or, the pack's 4; and its fp32 operations: two
#: logf (about 12 each as libdevice computes them), subtract, add, max,
#: the scaling and the score's add
SAMPLE_INT_OPS, SAMPLE_FP_OPS = 77, 29
#: int32 lanes of an SM (H100: 16 in each of its four partitions; NVIDIA's
#: Hopper architecture white paper); fp32 instructions a second (the data
#: sheet's 67 TFLOP/s counts a fused multiply-add as two)
INT32_LANES_PER_SM, FP32_OPS = 64, PEAK_FLOPS["torch.float32"] / 2


def sample_bound(good_rows: int, b: int, v: int, bw: float, clock_hz: float) -> tuple[float, str]:
    """``(ms, "bytes" | "operations")``: the least time of one sampler
    launch over ``b`` rows of ``v`` logits, ``good_rows`` of them drawn:
    each drawn row read once, the keys read and written, the flags read,
    the tokens written; each draw's operations at the card's int32 and
    fp32 rates."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    draws = good_rows * v
    bytes_ms = (4 * draws + 16 * b + b + 8 * b) / bw * 1e3
    ops_ms = max(draws * SAMPLE_INT_OPS / (sms * INT32_LANES_PER_SM * clock_hz),
                 draws * SAMPLE_FP_OPS / FP32_OPS) * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sampler_batch(v: int, gen, tricky: bool):
    """SLOTS seeded fp32 logits rows of ``v``, seeded keys and the good
    flags.  ``tricky``: row 1 holds two NaNs (the first, at 7, wins), row 2
    two equal maxima of 1e30 at 5 and ``v - 3`` (``-inf`` elsewhere): no
    Gumbel draw moves a score that large, so the first index wins the tie;
    slot 3 is skipped (pad, its key kept)."""
    import torch

    rows = torch.randn((SLOTS, v), generator=gen, device="cuda") * 3
    good = torch.ones(SLOTS, dtype=torch.bool, device="cuda")
    if tricky:
        rows[1, [7, v // 2]] = float("nan")
        rows[2] = float("-inf")
        rows[2, [5, v - 3]] = 1e30
        good[3] = False
    keys = torch.randint(0, 2**32, (SLOTS, 2), generator=gen, device="cuda", dtype=torch.int64)
    return rows, keys.to(torch.uint32), good


def sampler_fixed_cost(gen, clock_hz: float, bw: float) -> dict:
    """What a sampler launch costs besides its draws, under :func:`cuda_ms`:
    the spin kernel ``cuda_ms`` queues its calls behind, asked to spin for
    no cycles (``torch.cuda._sleep(0)``: a launch that does nothing, the
    floor the measurement puts under every kernel), the sampler with every good flag
    clear (its prologue and completion, no draw) and its time over
    :data:`SAMPLE_SWEEP` at SLOTS rows, with the line through them (ms =
    intercept + slope x draws) and each point's operations bound."""
    import numpy as np
    import torch
    from repro_torch.kernels import sample as SMP

    floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), iters=50)
    rows, keys, good = sampler_batch(SAMPLE_VOCABS[0], gen, False)
    good.zero_()
    skipped_ms = cuda_ms(lambda: SMP.sample_tokens(rows, keys, SERVE_TEMPERATURE, good, -1, reciprocal=True),
                         iters=50)
    sweep = []
    for v in SAMPLE_SWEEP:
        rows, keys, good = sampler_batch(v, gen, False)
        ms = cuda_ms(lambda: SMP.sample_tokens(rows, keys, SERVE_TEMPERATURE, good, -1, reciprocal=True), iters=50)
        sweep.append({"v": v, "ms": ms, "bound_ms": sample_bound(SLOTS, SLOTS, v, bw, clock_hz)[0]})
    draws = np.array([SLOTS * r["v"] for r in sweep], float)
    slope, intercept = np.polyfit(draws, [r["ms"] for r in sweep], 1)
    bound_slope = np.polyfit(draws, [r["bound_ms"] for r in sweep], 1)[0]
    SMP.reset_launch_counts()
    out = {"floor_ms": floor_ms, "skipped_ms": skipped_ms, "sweep": sweep, "ps_a_draw": slope * 1e9,
           "intercept_ms": intercept, "bound_ps_a_draw": bound_slope * 1e9}
    log(f"sampler fixed cost: empty launch {floor_ms:.4f} ms, every slot skipped {skipped_ms:.4f} ms; "
        f"[{SLOTS}, V] over V = {SAMPLE_SWEEP}: "
        + ", ".join(f"{r['ms']:.4f}" for r in sweep)
        + f" ms; line: {out['intercept_ms'] * 1e3:.2f} us + {out['ps_a_draw']:.2f} ps a draw (bound "
        f"{out['bound_ps_a_draw']:.2f} ps a draw)")
    return out


def sampler_phase(bw: float) -> tuple[list, dict]:
    """The sampler kernel against its plain version on the card (bit-equal
    tokens and keys) at each of :data:`SAMPLE_VOCABS` x
    :data:`SAMPLE_TEMPERATURES` x both scalings, plain and tricky rows;
    each vocabulary timed (kernel, plain version, ``torch.multinomial`` on
    the rows' softmax: another stream, the nearest library call) with its
    bound; one device launch a call.  None of it is the main path's: the
    counts are set back to 0."""
    import torch
    from repro_torch.kernels import sample as SMP

    clock_hz = max_sm_clock_hz()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_out, cases, pad = [], 0, -1
    for v in SAMPLE_VOCABS:
        for t in SAMPLE_TEMPERATURES:
            for reciprocal in (True, False):
                for tricky in (False, True):
                    rows, keys, good = sampler_batch(v, gen, tricky)
                    k_kernel, k_plain = keys.clone(), keys.clone()
                    got = SMP.sample_tokens(rows, k_kernel, t, good, pad, reciprocal=reciprocal)
                    want = SMP.sample_tokens_ref(rows, k_plain, t, good, pad, reciprocal=reciprocal)
                    torch.cuda.synchronize()
                    kk, kp, k0 = (k.to(torch.int64) for k in (k_kernel, k_plain, keys))
                    if not torch.equal(got, want) or not torch.equal(kk, kp):
                        raise AssertionError(f"sampler [{SLOTS},{v}] t={t} reciprocal={reciprocal} "
                                             f"tricky={tricky}: tokens {got.tolist()} vs plain {want.tolist()}, "
                                             f"keys equal {torch.equal(kk, kp)}")
                    if tricky and (got[1:].tolist() != [7, 5, pad] or not torch.equal(kk[3], k0[3])):
                        raise AssertionError(f"sampler [{SLOTS},{v}]: NaN/tie/skip rows gave {got.tolist()}")
                    if torch.equal(kk[:3], k0[:3]) or not bool(((got[:3] >= 0) & (got[:3] < v)).all()):
                        raise AssertionError(f"sampler [{SLOTS},{v}]: keys not advanced or token outside the row")
                    cases += 1
        rows, keys, good = sampler_batch(v, gen, False)
        t = SERVE_TEMPERATURE
        ms = cuda_ms(lambda: SMP.sample_tokens(rows, keys, t, good, pad, reciprocal=True))
        plain_ms = cuda_ms(lambda: SMP.sample_tokens_ref(rows, keys, t, good, pad, reciprocal=True), iters=5)
        probs = torch.softmax(rows / t, dim=-1)
        library_ms = cuda_ms(lambda: torch.multinomial(probs, 1))
        bound_ms, bound_by = sample_bound(SLOTS, SLOTS, v, bw, clock_hz)
        row = {"case": f"sampler {SLOTS} slots x {v}, t={t}, the decode step's scaling", "kernel": "td_sample_kernel",
               "shape": f"[{SLOTS},{v}]", "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by, "main_path": v == 102400}
        rows_out.append(row)
        log(f"sampler [{SLOTS},{v}]: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, torch.multinomial on the "
            f"softmax {library_ms:.4f} ms (another stream), bound {bound_ms:.4f} ms by {bound_by} "
            f"({bound_ms / ms:.0%} of it)")
    rows, keys, good = sampler_batch(SAMPLE_VOCABS[0], gen, False)
    launch = count_launches({"sampler": lambda: SMP.sample_tokens(rows, keys, SERVE_TEMPERATURE, good, pad,
                                                                  reciprocal=True)}, kernel="td_sample_kernel")
    fixed = sampler_fixed_cost(gen, clock_hz, bw)
    SMP.reset_launch_counts()
    log(f"sampler: {cases} cases bit-equal to the plain version on the card (tokens and keys; a NaN row's "
        "first NaN, a tie's first index, a skipped slot's pad and kept key)")
    return rows_out, {"cases": cases, "launch_check": launch, "sm_clock_mhz": clock_hz / 1e6, "fixed": fixed}


# ---------------------------------------------------------------------------
# init phase: the normal fill behind init_params
# ---------------------------------------------------------------------------

INIT_SOURCE = "src/repro_torch/kernels/csrc/normal.cu"
#: the JAX function whose draws the fill kernel replays (it replaces no
#: Pallas kernel: XLA computes these draws)
INIT_REPLACES = "src/repro/models/common.py:51"
INIT_ARCH = "deepseek-7b"
#: the bits of jax.random.normal(PRNGKey(0), (8,), float32), as JAX 0.9.0
#: draws them on the CPU (tests/test_torch_init.py holds them to JAX)
JAX_NORMAL_8 = (0x3FCFB2BD, 0x40019DF0, 0xBEDE0017, 0xBDA10222, 0x3E34512C, 0xBF78DAD7, 0xBEFD97CC, 0x3EFD1F31)
#: bf16 bits of entries of JAX's init_params(param_specs(reduce_config(arch)),
#: PRNGKey(0)): the port's path (the layer after "layers"), the index in
#: that layer's tensor, the bits; qwen3-moe's w_gate is an expert leaf
JAX_INIT_ANCHORS = {
    "deepseek-7b": (("embed", (17, 5), 0x3E01), ("layers/1/attn/wq", (3, 40), 0x3DA1),
                    ("layers/0/mlp/w_down", (100, 7), 0xBE55), ("lm_head", (63, 255), 0xBE4A)),
    "qwen3-moe-235b-a22b": (("layers/1/mlp/w_gate", (5, 33, 17), 0x3CA2), ("layers/0/mlp/w_down", (7, 31, 63), 0xBDCA),
                            ("layers/1/attn/wk", (60, 2), 0xBDB4), ("embed", (255, 63), 0x3EBE)),
}
#: (case, stacked leaf shape, block shape, block start) of the fill against
#: its plain version on the card, each at the leaf's std: an odd-sized leaf
#: (``scaled``, 0.02), one layer of deepseek-7b's stacked w_gate, a TP-4
#: rank's columns of it and rows of w_down, and a slice of qwen3-moe's
#: stacked w_gate at layer 7, whose counters pass 2**32
INIT_CASES = (
    ("odd leaf [1000003]", (1000003,), (1000003,), (0,)),
    ("deepseek-7b w_gate layer 3", (30, 4096, 11008), (1, 4096, 11008), (3, 0, 0)),
    ("deepseek-7b w_gate layer 3, TP-4 rank 2's columns", (30, 4096, 11008), (1, 4096, 2752), (3, 0, 5504)),
    ("deepseek-7b w_down layer 3, TP-4 rank 1's rows", (30, 11008, 4096), (1, 2752, 4096), (3, 2752, 0)),
    ("qwen3-moe w_gate layer 7, experts 5:7, rows 100:356", (94, 128, 4096, 1536), (1, 2, 256, 1536), (7, 5, 100, 0)),
)
#: the fill against its plain version: bf16 equal, fp32 within this many ulps
INIT_FP32_ULPS = 4
#: one draw's int32 operations in the hash: 20 Threefry rounds of add,
#: funnel-shift rotate and xor, 5 key injections of two adds, the two adds
#: that start it and the output xor
NORMAL_INT_OPS = 20 * 3 + 5 * 2 + 2 + 1


def normal_bound(n: int, esz: int, bw: float, int_ops_per_s: float) -> tuple[float, str]:
    """``(ms, "bytes" | "operations")``: the least time to fill ``n``
    elements of ``esz`` bytes: the bytes stored at ``bw`` against the
    hash's integer work at the card's int32 rate (the float work, ~60
    operations a draw, issues on the fp32 pipes beside it)."""
    bytes_ms, ops_ms = n * esz / bw * 1e3, n * NORMAL_INT_OPS / int_ops_per_s * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _leaf(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if part.isdigit() else tree[part]
    return tree


def randn_init(specs, dtype):
    """The port's initializer before it replayed JAX's draws, kept as a
    yardstick: one ``torch.Generator`` on the card, ``torch.randn`` in fp32
    a tensor, scaled by the per-layer fan-in and cast.  Not the same
    function as the fill (other numbers, another std for stacked experts)."""
    import math

    import torch
    from repro_torch.models.common import Spec, _fan_in

    gen = torch.Generator(device="cuda").manual_seed(0)

    def make(spec: Spec):
        dt = spec.dtype or dtype
        if spec.init in ("ones", "zeros"):
            return (torch.ones if spec.init == "ones" else torch.zeros)(spec.shape, dtype=dt, device="cuda")
        if spec.init == "embed":
            std = 1.0
        elif spec.scale is not None:
            std = spec.scale
        else:
            std = 0.02 if spec.init == "scaled" else 1.0 / math.sqrt(_fan_in(spec.shape))
        return torch.randn(spec.shape, generator=gen, dtype=torch.float32, device="cuda").mul_(std).to(dt)

    walk = lambda t: make(t) if isinstance(t, Spec) else (
        {k: walk(v) for k, v in t.items()} if isinstance(t, dict) else [walk(v) for v in t])
    return walk(specs)


def events_ms(fn):
    """``(device ms, host s)`` of one call of ``fn``: CUDA events around it
    on the current stream, then a synchronize."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), time.perf_counter() - t0, out


def init_phase(bw: float) -> tuple[list, dict]:
    """The normal fill (``td_normal_kernel``) on the card: (a) against its
    plain version on :data:`INIT_CASES` in bf16 and fp32 (bf16 equal, fp32
    within :data:`INIT_FP32_ULPS` ulps), each timed beside the plain version
    with its bound, one device launch a call; (b) JAX's draws reproduced:
    :data:`JAX_NORMAL_8` and :data:`JAX_INIT_ANCHORS` from reduced
    deepseek-7b's and qwen3-moe's ``init_params`` on the card; (c)
    full-width deepseek-7b's ``init_params`` (the main path: its launches,
    the fill kernels' device time from the profiler, the whole init's
    device and host time, the bound over its draws), with the old
    ``torch.randn`` initializer timed the same way as context."""
    import dataclasses
    import gc
    import math

    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.kernels import normal as NRM
    from repro_torch.models import model as M
    from repro_torch.models.common import Spec, init_params, leaf_std, stacked_leaves

    clock_hz = max_sm_clock_hz()
    int_rate = torch.cuda.get_device_properties(0).multi_processor_count * INT32_LANES_PER_SM * clock_hz
    rows, calls = [], {}
    for i, (case, full, block, starts) in enumerate(INIT_CASES):
        key = prng.fold_in(prng.prng_key(0), i)
        std = leaf_std(Spec(full, init="scaled" if len(full) == 1 else "normal"), full)
        first = prng.block_layout(block, 0, full, starts)[2]
        for dtype in (torch.bfloat16, torch.float32):
            out = torch.empty(block, dtype=dtype, device="cuda")
            fill = lambda out=out, key=key, std=std, full=full, starts=starts: NRM.fill_normal_(
                out, key, std, full=full, starts=starts)
            fill()
            want = NRM.normal_ref(key, block, std, dtype, full=full, starts=starts, device="cuda")
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"init {case} {dtype}: non-finite draws")
            if dtype == torch.bfloat16:
                ulps = int((out.view(torch.int16) != want.view(torch.int16)).sum())
                if ulps:
                    raise AssertionError(f"init {case} bf16: {ulps} elements differ from the plain version")
            else:
                ulps = int((out.view(torch.int32).to(torch.int64) - want.view(torch.int32)).abs().max())
                if ulps > INIT_FP32_ULPS:
                    raise AssertionError(f"init {case} fp32: {ulps} ulps from the plain version")
            err = float((out.float() - want.float()).abs().max())
            ms = cuda_ms(fill)
            plain_ms = cuda_ms(lambda: NRM.normal_ref(key, block, std, dtype, full=full, starts=starts,
                                                      device="cuda"), iters=2, warmup=1)
            n = out.numel()
            bound_ms, bound_by = normal_bound(n, out.element_size(), bw, int_rate)
            row = {"case": f"init {case} {str(dtype)[6:]}", "kernel": "td_normal_kernel",
                   "shape": f"{list(block)} of {list(full)} at {list(starts)}", "dtype": str(dtype),
                   "first_index": first, "max_abs_err": err, "max_ulps": ulps, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                   "main_path": i == 1 and dtype == torch.bfloat16}
            rows.append(row)
            log(f"init {case} {str(dtype)[6:]}: {n} draws from flat index {first}, {ulps} "
                f"{'ulps' if dtype == torch.float32 else 'elements'} from the plain version; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.2f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
                f"({row['bound_ms'] / ms:.0%} of it)")
            calls[f"{case} {dtype}"] = fill
            del want
    if rows[-1]["first_index"] < 2**32:
        raise AssertionError("init: the layer-7 case's counters should pass 2**32")
    launch = count_launches(calls, kernel="td_normal_kernel")
    # (b) JAX's draws
    eight = NRM.fill_normal_(torch.empty(8, device="cuda"), prng.prng_key(0))
    got8 = tuple(int(b) & 0xFFFFFFFF for b in eight.view(torch.int32).tolist())
    if got8 != JAX_NORMAL_8:
        raise AssertionError(f"init: normal(PRNGKey(0), (8,)) bits {[hex(b) for b in got8]}, JAX's "
                             f"{[hex(b) for b in JAX_NORMAL_8]}")
    anchors = 0
    for arch, items in JAX_INIT_ANCHORS.items():
        p = init_params(M.param_specs(reduce_config(get_config(arch))), seed=0, dtype=torch.bfloat16, device="cuda")
        for path, idx, bits in items:
            got = int(_leaf(p, path)[idx].view(torch.int16)) & 0xFFFF
            if got != bits:
                raise AssertionError(f"init: {arch} {path}{list(idx)} bits {got:#06x}, JAX's {bits:#06x}")
            anchors += 1
    log(f"init: the card's fill reproduces JAX's normal(PRNGKey(0), (8,)) bit for bit and {anchors} bf16 entries "
        f"of JAX's init_params(PRNGKey(0)) on reduced {' and '.join(JAX_INIT_ANCHORS)}")
    # (c) full-width deepseek-7b, the main path
    cfg = dataclasses.replace(get_config(INIT_ARCH), activation="relu")
    specs = M.param_specs(cfg)
    leaves = stacked_leaves(specs)
    draws = sum(math.prod(lead + tuple(sp.shape)) for sp, lead in leaves.values() if sp.init not in ("ones", "zeros"))
    want_launches = sum(math.prod(lead) for sp, lead in leaves.values() if sp.init not in ("ones", "zeros"))
    params, _ = init_whole(cfg, "init")  # cold: the allocator's first blocks
    del params
    init = lambda: init_params(specs, seed=0, dtype=torch.bfloat16, device="cuda")
    NRM.reset_launch_counts()
    with no_plain_versions("init"):
        init_ms, init_s, params = events_ms(init)
    launches = NRM.LAUNCHES["td_normal_kernel"]
    if launches != want_launches:
        raise AssertionError(f"init: {launches} fill launches, the path's {want_launches} (one a layer a leaf)")
    del params
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        params = init()
        torch.cuda.synchronize()
    from repro_torch.launch.profile_decode import _device_us

    kernel_ms = sum(_device_us(e) for e in prof.key_averages() if "td_normal_kernel" in e.key) / 1e3
    del params, prof
    randn_init(specs, torch.bfloat16)  # warm
    randn_ms, randn_s, params = events_ms(lambda: randn_init(specs, torch.bfloat16))
    del params
    init_bound, init_bound_by = normal_bound(draws, 2, bw, int_rate)
    gc.collect()
    torch.cuda.empty_cache()
    NRM.reset_launch_counts()
    summary = {"arch": INIT_ARCH, "draws": draws, "launches": launches, "init_ms": init_ms, "init_host_s": init_s,
               "kernel_ms": kernel_ms or None, "bound_ms": init_bound, "bound_by": init_bound_by,
               "randn_init_ms": randn_ms, "randn_init_host_s": randn_s, "launch_check": launch,
               "anchors": anchors, "sm_clock_mhz": clock_hz / 1e6}
    kernel_text = (f"the fill kernels {kernel_ms:.2f} ms on the card (profiler), {init_bound / kernel_ms:.0%} of "
                   "the bound" if kernel_ms else "the fill kernels' time not measured (the profiler saw none)")
    log(f"init: full-width {INIT_ARCH} bf16, {draws} draws in {launches} fill launches (one a layer a leaf): "
        f"{kernel_text}; the whole init {init_ms:.2f} ms device / {init_s:.3f} s host; bound {init_bound:.2f} ms "
        f"by {summary['bound_by']}")
    log(f"init: the torch.randn initializer (another function: context only) {randn_ms:.2f} ms device / "
        f"{randn_s:.3f} s host")
    return rows, summary


def sampled_serve_phase(params, cfg, prompts, greedy) -> dict:
    """The serve phase's requests at temperature :data:`SERVE_TEMPERATURE`:
    eagerly (the path's launches, a sampler launch a model call, no host
    sync in a chunk; tokens other than the greedy run's), again with the
    plain sampler in the kernel's place (the same tokens), then through the
    decode graph (the eager run's tokens, one capture, the sampler replayed
    once a step, no host sync in a replay) and with a poisoned slot through
    the graph.  Prints ms a decode step against the greedy runs'."""
    from repro_torch import runtime as rtm
    from repro_torch.kernels import sample as SMP
    from repro_torch.serve import engine as E

    tag, t = "sampled serve", SERVE_TEMPERATURE
    rt = rtm.Runtime(backend="cuda", device="cuda")
    run = drive_serve(params, cfg, prompts, rt, temperature=t)
    calls = check_eager_run(tag, cfg, run, sampled=True)
    out, st = run["out"], run["stats"]
    if out == greedy["greedy_tokens"]:
        raise AssertionError(f"{tag}: the sampled tokens are the greedy run's")
    eager = {"tokens": st["tokens_out"], "wall_s": run["wall"], "tok_per_s": st["tokens_out"] / run["wall"],
             "decode_steps": st["steps_run"], "ms_per_decode_step": run["decode_s"]["eager"] / st["steps_run"] * 1e3,
             "launches": run["launches"], "model_calls": calls, "sampled_tokens": out}
    orig = E.sample_tokens
    E.sample_tokens = SMP.sample_tokens_ref
    try:
        plain = drive_serve(params, cfg, prompts, rt, temperature=t, allow=(PLAIN_SAMPLER,))
    finally:
        E.sample_tokens = orig
    diff = first_difference(plain["out"], out)
    if diff is not None or plain["launches"]["td_sample_kernel"]:
        raise AssertionError(f"{tag}: the plain sampler's run differs from the kernel's at {diff}")
    log(f"{tag}: {eager['tokens']} tokens at temperature {t}, eager decode chunk: {eager['ms_per_decode_step']:.3f} "
        f"ms per decode step (greedy {greedy['ms_per_decode_step']:.3f}); launches {run['launches']} == path's "
        f"({calls} model calls, a sampler launch each); 0 host syncs inside decode chunks; the plain sampler in "
        "its place gives the same tokens")
    graph = serve_graph_phase(params, cfg, prompts, rt, eager, tag=f"{tag} graph", temperature=t)
    faults = serve_fault_phase(params, cfg, prompts, rt, graph, faults=SERVE_FAULTS[:1], temperature=t)
    g_ms, gg_ms = graph["ms_per_decode_step_replayed"], greedy["graph"]["ms_per_decode_step_replayed"]
    per_step = graph["replay_device_launches_all"] / CHUNK
    greedy_step = greedy["graph"]["replay_device_launches_all"] / CHUNK
    e_ms = eager["ms_per_decode_step"]
    log(f"{tag}: decode step through the graph {g_ms:.3f} ms sampled vs {gg_ms:.3f} ms greedy "
        f"({g_ms / gg_ms - 1:+.2%}); eager sampled {e_ms:.3f} ms ({e_ms / g_ms:.2f}x "
        f"the sampled graph); device launches a replayed step {per_step:.0f} sampled vs {greedy_step:.0f} greedy "
        f"(the sampler {graph['replay_launches'].get('td_sample_kernel', 0) / CHUNK:.0f} a step)")
    return {"eager": eager, "graph": graph, "faults": faults, "plain_tokens_equal": True,
            "ms_per_decode_step_graph": g_ms, "greedy_ms_per_decode_step_graph": gg_ms,
            "device_launches_per_step": per_step, "greedy_device_launches_per_step": greedy_step,
            "launches": {k: run["launches"][k] + graph["device_launches"][k] + sum(f["device_launches"][k]
                                                                                for f in faults)
                         for k in run["launches"]}}


#: the serve launcher's full-width replay on the card
SERVE_LAUNCH_ARGS = ["--arch", "deepseek-7b", "--activation", "relu", "--requests", "8", "--slots", "4",
                     "--prompt-len", "32", "--new", "16", "--max-len", "128",
                     "--inject-faults", "nan_logits@1:slot=0"]


def _serve_launch(tag: str, argv: list) -> dict:
    """One in-process run of ``repro_torch.launch.serve.main``: its stdout,
    seconds, tokens/s, decode-graph captures and device launches (a
    capture's times its replays), the counts set to 0 just before it."""
    import gc
    import io
    import re

    import torch
    from repro_torch.kernels import sample, tensordash_spmm as T
    from repro_torch.launch import serve as LS

    buf = io.StringIO()
    T.reset_launch_counts()
    sample.reset_launch_counts()
    t0 = time.perf_counter()
    with no_plain_versions("launch serve"), graph_launch_log() as captures, contextlib.redirect_stdout(buf):
        try:
            LS.main(argv)
        except SystemExit as e:
            raise AssertionError(f"launch serve ({tag}) exited with {e.code}:\n{buf.getvalue()}") from e
    seconds = time.perf_counter() - t0
    launches = device_launches_of(serve_launch_counts(), captures)
    gc.collect()
    torch.cuda.empty_cache()
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"launch serve ({tag}): {line}")
    reasons = re.search(r"finish reasons: (.*)", out).group(1)
    if not ("error=1" in reasons and "length=" in reasons and "retire-slot" in out):
        raise AssertionError(f"launch serve ({tag}): missing mixed finish reasons or retire-slot:\n{out}")
    tok_s = float(re.search(r"\(([\d.]+) tok/s\)", out).group(1))
    log(f"launch serve ({tag}): exit 0 in {seconds:.1f} s (weights initialised in the run); {tok_s} tok/s; "
        f"device launches {launches}")
    return {"stdout": out, "seconds": seconds, "tok_per_s": tok_s, "launches": launches,
            "captures": len(captures)}


def launch_serve_phase():
    """``repro_torch.launch.serve.main`` in process at full width with a
    poisoned slot, the decode chunk as one CUDA graph and then eagerly
    (``--no-cuda-graph``): exit 0, mixed finish reasons and a
    ``retire-slot`` line each; one capture, then none; the greedy tokens
    are the same (the finish-reason line and the tokens served equal); the
    launches of both runs (a capture's times its replays) and tokens/s."""
    import re

    graph = _serve_launch("graph", SERVE_LAUNCH_ARGS)
    eager = _serve_launch("eager", SERVE_LAUNCH_ARGS + ["--no-cuda-graph"])
    if not ("decode graph captured 1x" in graph["stdout"] and graph["captures"] == 1
            and "decode graph captured 0x" in eager["stdout"] and eager["captures"] == 0):
        raise AssertionError("launch serve: expected one capture with the graph and none with --no-cuda-graph")
    served = [re.search(r"served (\d+) tokens", r["stdout"]).group(1) for r in (graph, eager)]
    reasons = [re.search(r"finish reasons: (.*)", r["stdout"]).group(1) for r in (graph, eager)]
    if served[0] != served[1] or reasons[0] != reasons[1]:
        raise AssertionError(f"launch serve: the graph and eager runs served {served} tokens, reasons {reasons}")
    log(f"launch serve: {graph['tok_per_s']} tok/s with the graph, {eager['tok_per_s']} with --no-cuda-graph")
    launches = {k: graph["launches"][k] + eager["launches"][k] for k in graph["launches"]}
    return {"graph": graph, "eager": eager, "tok_per_s": graph["tok_per_s"],
            "tok_per_s_eager": eager["tok_per_s"], "launches": launches}


def reference_phase(params, cfg, prompts, tag: str = "reference"):
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
    log(f"{tag}: prefill last-token logits, cuda vs reference backend on the card: "
        f"worst relative L2 {worst:.3e} (bound {REF_REL_L2:.3e}); top-1 agreement {agree}/{len(prompts)}")
    if worst > REF_REL_L2:
        raise AssertionError(f"{tag}: cuda vs reference relative L2 {worst} > {REF_REL_L2}")
    return worst, agree


def moe_reference_phase(params, cfg, prompts, tag: str = "moe reference"):
    """Each prompt's prefill logits under ``cuda`` and ``reference`` for a
    MoE model.  Its router's top-k is discontinuous: where a token's k-th and
    (k+1)-th expert probabilities lie within a rounding of each other, a bf16
    rounding that the kernels and the plain executor take differently sends
    the token to the other expert, and every later layer follows from there
    (the ``dense`` backend, cuBLAS's products, parts from ``reference`` the
    same way: its relative L2 is reported beside the kernels').  So the
    reference run is made twice: routing itself (its relative L2, the
    tokens routed apart per layer and, in the first layer where they part,
    their 8th-9th probability margins: reported), and with each MoE
    layer's experts pinned to the cuda run's, so the same products run on
    the same routes: held to :data:`REF_REL_L2`, as the dense model is."""
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod

    route, seen, pinned = moe_mod._route, [], []

    def recording(c, x2, w):
        seen.append(route(c, x2, w))
        return seen[-1]

    def pinning(c, x2, w):
        _, _, probs = route(c, x2, w)
        experts = pinned.pop(0)
        top_p = torch.gather(probs, 1, experts)
        return top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9), experts, probs

    def prefill(toks, backend, fn):
        seen.clear()
        moe_mod._route = fn
        try:
            with torch.inference_mode(), rtm.Runtime(backend=backend, device="cuda").use():
                return M.prefill(params, cfg, {"tokens": toks})[0][0, -1].float(), list(seen)
        finally:
            moe_mod._route = route

    def rel(got, want):
        return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))

    rows = []
    for p in prompts:
        toks = torch.as_tensor(p, device="cuda")[None]
        got, routes = prefill(toks, "cuda", recording)
        want, ref_routes = prefill(toks, "reference", recording)
        pinned[:] = [e for _, e, _ in routes]
        held, _ = prefill(toks, "reference", pinning)
        dense, _ = prefill(toks, "dense", recording)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag}: non-finite cuda logits")
        apart, margins = [], []
        for (_, e_c, _), (_, e_r, probs) in zip(routes, ref_routes):
            moved = (e_c.sort(-1).values != e_r.sort(-1).values).any(-1)
            apart.append(int(moved.sum()))
            if moved.any() and not margins:
                top = probs.sort(-1, descending=True).values
                margins = (top[:, cfg.top_k - 1] - top[:, cfg.top_k])[moved].tolist()
        rows.append({"tokens": len(p), "rel_l2": rel(got, want), "rel_l2_routes_pinned": rel(got, held),
                     "rel_l2_dense": rel(dense, want),
                     "top1": int(got.argmax() == want.argmax()), "routed_apart_per_layer": apart,
                     "first_margins": margins})
    worst = max(r["rel_l2_routes_pinned"] for r in rows)
    free = max(r["rel_l2"] for r in rows)
    margins = [m for r in rows for m in r["first_margins"]]
    log(f"{tag}: prefill last-token logits, cuda vs reference backend on the card, the same routes: "
        f"worst relative L2 {worst:.3e} (bound {REF_REL_L2:.3e}); each routing itself: worst {free:.3e}, "
        f"per prompt {[round(r['rel_l2'], 5) for r in rows]} (dense backend against reference "
        f"{[round(r['rel_l2_dense'], 5) for r in rows]}), top-1 agreement {sum(r['top1'] for r in rows)}/"
        f"{len(rows)}; tokens routed apart per MoE layer {[r['routed_apart_per_layer'] for r in rows]}; "
        f"top-{cfg.top_k} probability margins where the routes first part: max {max(margins) if margins else None}")
    if worst > REF_REL_L2:
        raise AssertionError(f"{tag}: cuda vs reference on the same routes, relative L2 {worst} > "
                             f"{REF_REL_L2}")
    return rows


def moe_serve_phase(arch: str = MOE_ARCH, layers: int = MOE_LAYERS, tag: str = "moe serve"):
    """Full-width ``arch`` with a ReLU gate, cut to ``layers`` layers,
    served as the deepseek-7b serve phase serves (same requests, slots,
    chunk): every expert's ``w_down`` is one planned product on a plan by
    value (one planner launch each), so a decode step launches experts x MoE
    layers planned products and plans (qwen3-moe: 128 x 8; deepseek-v2: 160
    x 5) besides the LM head and, for a dense first block, its fused gate,
    emitted-mask plan and planned ``w_down``.  Eager, then through the
    decode graph (the eager tokens exactly, one capture, a replay's device
    launches the capture's), then prefill logits against ``reference``.
    Launches must be the path's, with no plain version and no host sync in a
    decode chunk; at most slots x top-k experts a MoE layer get a decode
    token, so the plans must skip at least ``1 - slots * top_k /
    num_experts`` of the expert blocks.  Reports decode ms per step,
    tokens/s, peak memory, launches per decode step and the share of expert
    blocks the plans skip."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params
    from repro_torch.runtime import runtime as rt_mod
    from repro_torch.serve.engine import ServeEngine

    full = get_config(arch)
    cfg = dataclasses.replace(full, activation="relu", num_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    param_gb = torch.cuda.memory_allocated() / 1e9 - before_gb
    router = params["layers"][0]["mlp"]["router"]
    if router.dtype != torch.float32 or params["layers"][0]["mlp"]["w_down"].dtype != torch.bfloat16:
        raise AssertionError(f"{tag}: the router must be fp32 and the experts bf16")
    n_moe = cfg.num_layers - cfg.first_dense_layers
    log(f"{tag}: {arch} relu, {cfg.num_layers} of {full.num_layers} layers ({cfg.first_dense_layers} dense, "
        f"{n_moe} MoE), d_model {cfg.d_model}, {'MLA' if cfg.use_mla else 'GQA'} attention, {cfg.num_experts} "
        f"experts top-{cfg.top_k} of d_ff {cfg.moe_d_ff} + {cfg.num_shared_experts} shared, "
        f"{cfg.param_count() / 1e9:.2f} B params ({param_gb:.2f} GB allocated; {before_gb:.2f} GB held before) "
        f"initialised on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(s)) for s in rng.integers(16, 33, size=REQUESTS)]
    rt = rtm.Runtime(backend="cuda", device="cuda")

    # the experts' plans (the only plans made without a key), by the engine
    # call that made them; read after the run, since a read inside a decode
    # chunk would sync the host
    plans, kind = {"prefill": [], "decode": []}, ["prefill"]
    plan_operand, admit, decode = rt_mod.plan_operand, ServeEngine._admit_group, ServeEngine._decode

    def recording(a, *args, **kw):
        plans[kind[0]].append(plan_operand(a, *args, **kw))
        return plans[kind[0]][-1]

    def tagged(method, name):
        def run(self, *args):
            kind[0] = name
            return method(self, *args)
        return run

    rt_mod.plan_operand = recording
    ServeEngine._admit_group, ServeEngine._decode = tagged(admit, "prefill"), tagged(decode, "decode")
    try:
        run = drive_serve(params, cfg, prompts, rt)
    finally:
        rt_mod.plan_operand = plan_operand
        ServeEngine._admit_group, ServeEngine._decode = admit, decode
    out, launches, st, wall, groups = run["out"], run["launches"], run["stats"], run["wall"], run["groups"]
    calls = check_eager_run(tag, cfg, run)
    experts = n_moe * cfg.num_experts
    if (len(plans["decode"]), len(plans["prefill"])) != (experts * st["steps_run"], experts * len(groups)):
        raise AssertionError(f"{tag}: {len(plans['decode'])} decode and {len(plans['prefill'])} prefill "
                             f"expert plans over {st['steps_run']} steps and {len(groups)} prefills")
    skip = {}
    for name, ps in plans.items():
        if any(p.block_rows != 1 for p in ps):  # bm = the capacity (Runtime.fit)
            raise AssertionError(f"{tag}: a {name} expert plan with more than one block row")
        nnz = torch.cat([p.nnz for p in ps])
        blocks = sum(p.total_blocks for p in ps)
        skip[name] = {"plans": len(ps), "blocks": blocks, "effectual": int(nnz.sum()),
                      "skipped_share": 1 - int(nnz.sum()) / blocks, "empty_plans": int((nnz == 0).sum()),
                      "rows": sorted({p.shape[0] for p in ps})}
    least = 1 - SLOTS * cfg.top_k / cfg.num_experts
    if skip["decode"]["skipped_share"] < least:
        raise AssertionError(f"{tag}: decode expert plans skip {skip['decode']['skipped_share']:.4f} of the "
                             f"blocks, below the {least:.4f} that at most {SLOTS} x {cfg.top_k} routed experts leave")
    steps = st["steps_run"]
    eager = {
        "tokens": st["tokens_out"], "wall_s": wall, "tok_per_s": st["tokens_out"] / wall,
        "decode_steps": steps, "ms_per_decode_step": run["decode_s"]["eager"] / steps * 1e3,
        "prefill_groups": groups, "launches": launches,
        "launches_per_model_call": {k: v / calls for k, v in by_wrapper(launches).items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "param_gb": param_gb,
        "plan_cache": st["plan_cache"], "expert_plans": skip, "greedy_tokens": out,
    }
    d = skip["decode"]
    log(f"{tag}: {REQUESTS} requests x {NEW_TOKENS} new tokens, slots {SLOTS}, chunk {CHUNK}, eager decode "
        f"chunk: {eager['tokens']} tokens in {wall:.3f} s = {eager['tok_per_s']:.2f} tok/s; "
        f"{eager['ms_per_decode_step']:.3f} ms per decode step over {steps} steps; prefill groups {groups}; "
        f"peak memory {eager['peak_mem_gb']:.2f} GB; 0 host syncs inside decode chunks")
    dense = (f"; per dense block a fused gate, an emitted-mask plan and a planned w_down"
             if cfg.first_dense_layers else "")
    log(f"{tag}: kernel launches {launches} == path's ({experts} planned expert products and {experts} "
        f"plans by value per model call, {calls} calls, + the LM head{dense}); no plain version ran")
    log(f"{tag}: decode expert plans: {d['plans']} over {steps} steps, rows {d['rows']}, "
        f"{d['effectual']}/{d['blocks']} blocks effectual, skipped share {d['skipped_share']:.4f} "
        f"(at least {least:.4f}); {d['empty_plans'] / (steps * n_moe):.2f} of {cfg.num_experts} experts per layer "
        f"and step plan no block; prefill: skipped share {skip['prefill']['skipped_share']:.4f}, "
        f"capacities {skip['prefill']['rows']}")
    del plans
    graph = serve_graph_phase(params, cfg, prompts, rt, eager, tag=f"{tag} graph")
    per_step = {k: v / CHUNK for k, v in by_wrapper(graph["capture_launches"]).items()}
    log(f"{tag}: device launches per decode step: {graph['replay_device_launches_all'] / CHUNK:.0f} "
        f"(one profiled replay / {CHUNK}), of them the port's kernels {per_step}; decode ms per step "
        f"eager {eager['ms_per_decode_step']:.3f}, graph {graph['ms_per_decode_step_replayed']:.3f}; tokens/s "
        f"eager {eager['tok_per_s']:.2f}, graph {graph['tok_per_s']:.2f}")
    reference = moe_reference_phase(params, cfg, prompts, tag=tag.replace("serve", "reference"))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eager.update(graph=graph, reference=reference, launches_per_decode_step_graph=per_step)
    return eager


def decode_bytes(params, caches, cfg) -> dict:
    """Least bytes a decode step over :data:`SLOTS` rows moves, by part:
    every weight read once (of the embedding only the rows gathered), each
    SSM cache leaf (conv tails, state) read and written, each KV cache leaf
    read (int8 rows and fp32 scales under ``kv_cache_quant``)."""
    from repro_torch.optim.adamw import tree_leaves

    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    embed = params.get("embed")  # a frontend config has none
    gathered = 0 if embed is None else SLOTS * embed.shape[1] * embed.element_size() - nbytes([embed])
    if cfg.family == "ssm":
        ssm, kv = caches, []
    elif cfg.family == "hybrid":
        ssm, kv = [c for g in caches.ssm for c in g], caches.kv
    else:
        ssm, kv = [], [c for stack in caches.values() for c in stack]
    return {"weights": nbytes(tree_leaves(params)) + gathered,
            "ssm_caches_read_and_written": 2 * nbytes(tree_leaves(ssm)),
            "kv_caches_read": nbytes(tree_leaves(kv))}


def init_whole(cfg, tag: str):
    """``cfg``'s bf16 weights from seed 0 on the card (JAX's
    ``PRNGKey(0)`` weights, through the fill kernel), with what they hold."""
    import gc

    import torch
    from repro_torch.kernels import normal as NRM
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params
    from repro_torch.optim.adamw import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    before_gb = torch.cuda.memory_allocated() / 1e9
    NRM.reset_launch_counts()
    t0 = time.perf_counter()
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    fills = NRM.LAUNCHES["td_normal_kernel"]
    NRM.reset_launch_counts()
    leaves = tree_leaves(params)
    param_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    layout = f", {cfg.num_layers // cfg.attn_every} groups of {cfg.attn_every} after the shared block" \
        if cfg.family == "hybrid" else ""
    log(f"{tag}: {cfg.name}, activation {cfg.activation}{', int8 KV cache' if cfg.kv_cache_quant else ''}, "
        f"{cfg.num_layers} layers{layout}, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}; {sum(t.numel() for t in leaves) / 1e9:.3f} B parameters in the tensors "
        f"({param_gb:.3f} GB bf16; param_count() says {cfg.param_count() / 1e9:.3f} B) initialised on the card "
        f"in {time.perf_counter() - t0:.1f} s by {fills} fill launches ({before_gb:.2f} GB held before)")
    return params, param_gb


#: the dry run's phase: (a) the full pass's result file, (b) the train phase's
#: cell held to a real step, (c) item 14e at full width
DRY_RUN_OUT = ROOT / "chiprun_out" / "dryrun_torch.json"
#: (a)'s processes at once: the card's host has 8 cores, the card phases use one or two
DRY_RUN_JOBS = 5
PEAK_REL = 0.10
SEQ_ROWS, SEQ_RANKS, SEQ_REL_L2 = 524288, 16, 2**-7
#: (b)'s prediction, made in a process of its own (the fake process group)
DRY_CELL = """
import dataclasses, json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun as D
D.fake_process_group(1)
cfg = dataclasses.replace(get_config("deepseek-7b"), activation="relu", num_layers={layers})
shape = InputShape("train_phase", {seq}, {batch}, "train")
rec = D.record("deepseek-7b", cfg, shape, D.fake_mesh((1, 1), ("data", "model")), microbatches={micro})
print(json.dumps(rec))
"""


def start_dry_run():
    """(a): the full dry run in the background, niced, its output logged to
    ``chiprun_out/dryrun_torch.log``; ``(process, start time)``."""
    import os

    DRY_RUN_OUT.parent.mkdir(exist_ok=True)
    logf = open(DRY_RUN_OUT.with_suffix(".log"), "w")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--mesh", "both", "--force",
           "--jobs", str(DRY_RUN_JOBS), "--out", str(DRY_RUN_OUT)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    try:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT),
                                preexec_fn=lambda: os.nice(10), start_new_session=True)
    finally:
        logf.close()
    return proc, time.perf_counter()


def stop_dry_run(run) -> None:
    """Kill (a)'s process group if it is still running (a phase failed)."""
    import os
    import signal

    proc = run[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def dry_run_collect(run) -> dict:
    """(a): wait for the dry run; every cell ``ok`` (ROADMAP lists no cell
    as a limit of the port), each record complete; the cells that do not fit 80 GB a rank, the
    wall time."""
    proc, t0 = run
    rc = proc.wait(timeout=900)
    wall = time.perf_counter() - t0
    tail = DRY_RUN_OUT.with_suffix(".log").read_text()[-3000:]
    if rc:
        raise AssertionError(f"dry run (a): exit {rc}\n{tail}")
    res = json.loads(DRY_RUN_OUT.read_text())
    bad = {k: r.get("error") for k, r in res.items() if not r.get("ok")}
    if len(res) != 64 or bad:
        raise AssertionError(f"dry run (a): {len(res)} cells, failed {bad}\n{tail}")
    need = ("argument_bytes", "peak_bytes")
    for k, r in res.items():
        rf = r.get("roofline", {})
        if not (all(r["mem"].get(n) for n in need) and rf.get("flops") and rf.get("hbm_bytes")
                and set(r["collectives"]) >= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
                and all(x in rf for x in ("compute_s", "memory_s", "collective_s")) and "fits_80gb" in r):
            raise AssertionError(f"dry run (a): record {k} lacks a field: {sorted(r)}")
    no_fit = sorted(k for k, r in res.items() if r.get("ok") and not r["fits_80gb"])
    slowest = max(res.values(), key=lambda r: r.get("compile_s", 0))
    log(f"dry run (a): {sum(r['ok'] for r in res.values())}/{len(res)} cells ok on 16x16 and 2x16x16 in "
        f"{wall:.1f} s (niced, beside the card phases; slowest cell {slowest['arch']}|{slowest['shape']}|"
        f"{slowest['mesh']} {slowest['compile_s']} s); {len(no_fit)} do not fit 80 GB a rank: {no_fit}")
    for k in sorted(res):
        r = res[k]
        if r["mesh"] == "16x16":
            rf = r["roofline"]
            log(f"dry run (a): {k}: {rf['dominant']} {rf['bound_s'] * 1e3:.3f} ms (compute "
                f"{rf['compute_s'] * 1e3:.3f}, memory {rf['memory_s'] * 1e3:.3f}, collective "
                f"{rf['collective_s'] * 1e3:.3f}), peak {r['mem']['peak_bytes'] / 1e9:.2f} GB a rank")
    return {"cells": len(res), "ok": sum(r["ok"] for r in res.values()), "seconds": wall, "no_fit_80gb": no_fit,
            "file": str(DRY_RUN_OUT.relative_to(ROOT))}


def dry_run_check_phase(bw: float) -> dict:
    """(b): the dry run's record of the train phase's step (deepseek-7b-ReLU
    cut to TRAIN_LAYERS layers, TRAIN_BATCH x TRAIN_SEQ tokens in
    TRAIN_MICRO microbatches, a 1x1 mesh) against a real step on an NCCL
    group of one rank: argument bytes exactly, the peak within PEAK_REL of
    ``max_memory_allocated`` on ``dense``, FLOPs equal to
    ``FlopCounterMode``'s, and a ``cuda``-backend step's time against the
    roofline bound."""
    import dataclasses
    import os

    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding as S
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_config("deepseek-7b"), activation="relu", num_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    code = DRY_CELL.format(src=str(SRC), layers=TRAIN_LAYERS, seq=TRAIN_SEQ, batch=TRAIN_BATCH, micro=TRAIN_MICRO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    if proc.returncode:
        raise AssertionError(f"dry run (b): the prediction failed\n{proc.stderr[-3000:]}")
    pred = json.loads(proc.stdout.strip().splitlines()[-1])
    t_pred = time.perf_counter() - t0
    free()
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            policy = S.ShardingPolicy(mesh=make_local_mesh())
            dense = rtm.Runtime(backend="dense", device="cuda", sharding=policy)
            base = torch.cuda.memory_allocated()
            params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device="cuda", policy=policy)
            opt = init_opt_state(params)
            batch = data.batch_at(0, device="cuda")
            held = nbytes(tree_leaves(params) + tree_leaves(opt.m) + tree_leaves(opt.v) + list(batch.values()))
            with dense.use():
                step = make_train_step(cfg, OptConfig(), microbatches=TRAIN_MICRO)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with dense.use():
                params, opt, _ = step(params, opt, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            with dense.use(), FlopCounterMode(display=False) as fc:
                params, opt, _ = step(params, opt, batch)
            flops = fc.get_total_flops()
            with rtm.Runtime(backend="cuda", device="cuda", sharding=policy).use():
                cstep = make_train_step(cfg, OptConfig(), microbatches=TRAIN_MICRO)
                params, opt, _ = cstep(params, opt, batch)  # the first step plans and warms
                walls = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    params, opt, _ = cstep(params, opt, batch)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t1)
        finally:
            dist.destroy_process_group()
    del params, opt, batch
    free()
    p_args, p_peak = pred["mem"]["argument_bytes"], pred["mem"]["peak_bytes"]
    p_flops, rf = pred["roofline"]["flops"], pred["roofline"]
    peak_rel = abs(p_peak - peak) / peak
    step_s = min(walls)
    share = rf["bound_s"] / step_s
    log(f"dry run (b): deepseek-7b relu cut to {TRAIN_LAYERS} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
        f"{TRAIN_MICRO} microbatches, 1x1 mesh: argument bytes predicted {p_args} vs real {held}; peak "
        f"predicted {p_peak / 1e9:.3f} GB vs max_memory_allocated {peak / 1e9:.3f} GB on dense (relative "
        f"{peak_rel:.4f}, bound {PEAK_REL}); FLOPs predicted {p_flops:.6e} vs FlopCounterMode {flops:.6e}; "
        f"prediction {t_pred:.1f} s (its run {pred['compile_s']} s)")
    log(f"dry run (b): a cuda-backend step {step_s * 1e3:.1f} ms (steps {[round(w * 1e3, 1) for w in walls]}) "
        f"against the roofline bound {rf['bound_s'] * 1e3:.2f} ms ({rf['dominant']}; compute "
        f"{rf['compute_s'] * 1e3:.2f} ms of {rf['flops_by_dtype']}, memory {rf['memory_s'] * 1e3:.2f} ms of "
        f"{rf['hbm_bytes'] / 1e9:.2f} GB unfused, collective {rf['collective_s'] * 1e3:.2f} ms): share "
        f"{share:.3f}; adjusted memory term {pred['memory_adj_s'] * 1e3:.2f} ms")
    if p_args != held:
        raise AssertionError(f"dry run (b): argument bytes {p_args} predicted, {held} real")
    if peak_rel > PEAK_REL:
        raise AssertionError(f"dry run (b): peak {p_peak} predicted, {peak} real ({peak_rel:.3f})")
    if p_flops != flops:
        raise AssertionError(f"dry run (b): FLOPs {p_flops} predicted, {flops} counted on the card")
    return {"argument_bytes": {"predicted": p_args, "real": held},
            "peak_bytes": {"predicted": p_peak, "max_memory_allocated": peak, "relative": peak_rel},
            "flops": {"predicted": p_flops, "flop_counter": flops, "by_dtype": rf["flops_by_dtype"]},
            "step_ms": step_s * 1e3, "steps_ms": [w * 1e3 for w in walls], "bound_ms": rf["bound_s"] * 1e3,
            "roofline": rf, "share": share, "memory_adj_ms": pred["memory_adj_s"] * 1e3,
            "prediction_s": t_pred}


def seq_decode_phase(bw: float) -> dict:
    """(c) item 14e at full width: zamba2-2.7b, batch 1, SEQ_ROWS cache rows
    of seeded random K/V (and SSM states).  With bf16 weights: one shared
    attention over the whole cache split as SEQ_RANKS data ranks' parts in
    turn and combined by ``seq_combine`` (``SeqSplit(parts=SEQ_RANKS)``)
    against the unsplit attention, within SEQ_REL_L2; the whole decode step
    both ways: the same argmax, its logits' distance beside the model's own
    bf16 noise (the unsplit step against the same weights in fp32); the
    whole step, the last rank's part (its rows, ``SeqSplit(rank=...)``) and
    one invocation of each timed beside their byte bounds.  With the same
    weights in fp32: the step's logits split against unsplit within
    SEQ_REL_L2, the same argmax."""
    import torch

    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models import hybrid as H
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SM
    from repro_torch.models.common import init_params
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_config(HYBRID_ARCH)
    dev = "cuda"
    free()
    t0 = time.perf_counter()
    caches = M.init_cache(cfg, 1, SEQ_ROWS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    chunk = 32768
    for kv in caches.kv:
        for t in kv[:2]:
            for i in range(0, SEQ_ROWS, chunk):
                t[:, i:i + chunk].copy_(torch.randn(t[:, i:i + chunk].shape, generator=gen, device=dev))
    for group in caches.ssm:
        for c in group:
            for t in c:
                t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.1)
    kv_bytes = sum(t.numel() * t.element_size() for kv in caches.kv for t in kv[:2])
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    pos = torch.tensor(SEQ_ROWS - 1, device=dev)
    tok = {"tokens": torch.randint(0, cfg.vocab_size, (1, 1), generator=gen, device=dev)}
    x = torch.randn(1, 1, cfg.d_model, generator=gen, device=dev)
    snap = [[SM.SSMCache(*(t.clone() for t in c)) for c in g] for g in caches.ssm]

    def restore():
        for g, sg in zip(caches.ssm, snap):
            for c, sc in zip(g, sg):
                for t, st in zip(c, sc):
                    t.copy_(st)

    def both_ways(params):
        """The step's logits unsplit and split (from the same SSM states)."""
        restore()
        want, _ = M.decode_step(params, cfg, caches, tok, pos)
        restore()
        got, _ = M.decode_step(params, cfg, caches, tok, pos, seq=A.SeqSplit(parts=SEQ_RANKS))
        restore()
        return want, got

    rows = SEQ_ROWS // SEQ_RANKS
    rank = SEQ_RANKS - 1
    part = H.HybridCache(ssm=caches.ssm, kv=[A.KVCache(k=kv.k[:, rank * rows:(rank + 1) * rows],
                                                       v=kv.v[:, rank * rows:(rank + 1) * rows]) for kv in caches.kv])
    acfg = H.shared_attn_config(cfg)
    rope = A.rope_tables(acfg, A.decode_positions(pos, 1, dev))
    argmax = lambda t: t.float().argmax(-1)
    out = {"rows": SEQ_ROWS, "ranks": SEQ_RANKS, "kv_bytes": kv_bytes, "fill_s": t_fill}
    with rtm.Runtime(backend="dense", device=dev).use(), torch.no_grad():
        params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device=dev)
        w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        attn_p, xb = params["shared"]["attn"], x.to(torch.bfloat16)
        whole, _ = A.attention_decode(attn_p, acfg, xb, caches.kv[0], pos, rope)
        split, _ = A.attention_decode(attn_p, acfg, xb, caches.kv[0], pos, rope, seq=A.SeqSplit(parts=SEQ_RANKS))
        attn_rel = _rel_l2(split, whole)
        want, got = both_ways(params)
        step_rel, step_same = _rel_l2(got, want), bool(torch.equal(argmax(got), argmax(want)))
        out["step_ms"] = cuda_ms(lambda: M.decode_step(params, cfg, caches, tok, pos), iters=5, warmup=1)
        out["part_ms"] = cuda_ms(lambda: M.decode_step(params, cfg, part, tok, pos, seq=A.SeqSplit(rank=rank)),
                                 iters=10, warmup=2)
        out["attn_ms"] = cuda_ms(lambda: A.attention_decode(attn_p, acfg, xb, caches.kv[0], pos, rope), iters=10,
                                 warmup=2)
        out["attn_part_ms"] = cuda_ms(lambda: A.attention_decode(attn_p, acfg, xb, part.kv[0], pos, rope,
                                                                 seq=A.SeqSplit(rank=rank)), iters=20, warmup=3)
        del params, attn_p
        free()
        params32 = init_params(M.param_specs(cfg), seed=0, dtype=torch.float32, device=dev)
        want32, got32 = both_ways(params32)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    rel32, same32 = _rel_l2(got32, want32), bool(torch.equal(argmax(got32), argmax(want32)))
    noise = _rel_l2(want, want32)
    n_inv = len(caches.kv)
    bounds = {"step": (kv_bytes + w_bytes) / bw * 1e3, "part": (kv_bytes / SEQ_RANKS + w_bytes) / bw * 1e3,
              "attn": kv_bytes / n_inv / bw * 1e3, "attn_part": kv_bytes / n_inv / SEQ_RANKS / bw * 1e3}
    del params32, caches, part, snap
    free()
    log(f"seq decode (c): {HYBRID_ARCH} whole, batch 1, {SEQ_ROWS} cache rows ({kv_bytes / 1e9:.2f} GB of KV, "
        f"{w_bytes / 1e9:.2f} GB of bf16 weights, filled in {t_fill:.1f} s; peak {peak / 1e9:.2f} GB), "
        f"{SEQ_RANKS} ranks' parts combined against unsplit: one shared attention relative L2 {attn_rel:.3e} "
        f"(bound {SEQ_REL_L2:.3e}); the bf16 step's logits {step_rel:.3e}, argmax {'equal' if step_same else 'DIFFERS'} "
        f"(the model's own bf16 noise: the unsplit step {noise:.3e} from its fp32 weights); the fp32-weight step's "
        f"logits {rel32:.3e} (bound {SEQ_REL_L2:.3e}), argmax {'equal' if same32 else 'DIFFERS'}")
    log(f"seq decode (c): the whole step {out['step_ms']:.3f} ms (bound {bounds['step']:.3f} ms bytes), one rank's "
        f"part ({rows} rows) {out['part_ms']:.3f} ms (bound {bounds['part']:.3f}); one shared-attention invocation "
        f"{out['attn_ms']:.3f} ms (bound {bounds['attn']:.3f}), its rank part {out['attn_part_ms']:.3f} ms (bound "
        f"{bounds['attn_part']:.3f}); {n_inv} invocations a step")
    if not (attn_rel <= SEQ_REL_L2 and step_same and rel32 <= SEQ_REL_L2 and same32):
        raise AssertionError(f"seq decode (c): split against unsplit: attention {attn_rel}, bf16 step argmax equal "
                             f"{step_same}, fp32-weight step {rel32}, argmax equal {same32}")
    out.update(weight_bytes=w_bytes, attn_rel_l2=attn_rel, rel_l2=step_rel, argmax_equal=step_same,
               bf16_noise_rel_l2=noise, fp32_rel_l2=rel32, fp32_argmax_equal=same32, bound_ms=bounds,
               peak_bytes=peak)
    return out


def dry_run_phase(bw: float, run=None) -> dict:
    """(a)-(c) of the dry-run phase; ``run`` is (a)'s background process
    (:func:`start_dry_run`), started here when not given."""
    run = run or start_dry_run()
    try:
        log("dry run (b): the dry run's record of the train phase's step against a real step on the card")
        check = dry_run_check_phase(bw)
        log(f"seq decode (c): item 14e at full width, {HYBRID_ARCH} with a {SEQ_ROWS}-row cache")
        seq = seq_decode_phase(bw)
        log("dry run (a): waiting for the full pass")
        full = dry_run_collect(run)
    finally:
        stop_dry_run(run)
    return {"full": full, "check": check, "seq_decode": seq}


def free() -> None:
    """Return the card's cached blocks once the caller dropped its tensors."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def whole_serve_phase(cfg, tag: str, *, max_len: int = MAX_LEN, then=None):
    """``cfg`` at full width and full depth (bf16 weights from seed 0),
    served as the deepseek-7b serve phase serves (same requests, slots,
    chunk) at ``max_len`` cache rows a slot: eager, then through the decode
    graph (the eager tokens exactly, one capture, a replay's device launches
    the capture's), then prefill logits against ``reference``.  Launches
    must be the path's (:func:`path_launches`: the LM head's alone where no
    FFN is on the runtime), the head's ``values`` plan built once an engine
    at the runtime's fitted block and replayed, no plain version, no host
    sync in a decode chunk.  Reports decode ms per step, tokens/s, peak
    memory, the caches' bytes, device launches per decode step and the
    step's bound from the bytes it moves.  ``then(params, cfg, summary,
    prompts, rt)`` runs the phase's own checks on the same weights before
    they are freed."""
    import numpy as np
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.models import model as M
    from repro_torch.runtime.plan import _fit_block

    params, param_gb = init_whole(cfg, tag)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(s)) for s in rng.integers(16, 33, size=REQUESTS)]
    rt = rtm.Runtime(backend="cuda", device="cuda")
    run = drive_serve(params, cfg, prompts, rt, max_len=max_len)
    out, launches, st, wall, groups = run["out"], run["launches"], run["stats"], run["wall"], run["groups"]
    calls = check_eager_run(tag, cfg, run)
    pc = st["plan_cache"]
    if pc["misses"] != 1 or pc["hits"] != calls - 1:
        raise AssertionError(f"{tag}: LM-head plan cache {pc}, expected 1 miss and {calls - 1} hits")
    head = run["plans"]
    block = (_fit_block(128, cfg.vocab_size), _fit_block(512, cfg.d_model))
    if len(head) != 1 or head[0]["block"] != block or head[0]["shape"] != (cfg.vocab_size, cfg.d_model):
        raise AssertionError(f"{tag}: plans {head}, expected the LM head's alone at block {block}")
    steps = st["steps_run"]
    step_bytes = decode_bytes(params, M.init_cache(cfg, SLOTS, max_len, device="meta"), cfg)
    bound_ms = sum(step_bytes.values()) / mem_bandwidth(torch.cuda.get_device_name(0)) * 1e3
    eager = {
        "tokens": st["tokens_out"], "wall_s": wall, "tok_per_s": st["tokens_out"] / wall,
        "decode_steps": steps, "ms_per_decode_step": run["decode_s"]["eager"] / steps * 1e3,
        "prefill_groups": groups, "launches": launches,
        "launches_per_model_call": {k: v / calls for k, v in by_wrapper(launches).items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "param_gb": param_gb, "max_len": max_len,
        "cache_bytes": run["cache_bytes"], "cache_dtypes": run["cache_dtypes"],
        "decode_bytes": step_bytes, "decode_bound_ms": bound_ms, "plan_cache": pc, "head_plan": head[0],
        "greedy_tokens": out,
    }
    log(f"{tag}: {REQUESTS} requests x {NEW_TOKENS} new tokens, slots {SLOTS}, chunk {CHUNK}, max_len {max_len}, "
        f"eager decode chunk: {eager['tokens']} tokens in {wall:.3f} s = {eager['tok_per_s']:.2f} tok/s; "
        f"{eager['ms_per_decode_step']:.3f} ms per decode step over {steps} steps (bound {bound_ms:.4f} ms "
        f"from the bytes a step moves, GB: { {k: round(v / 1e9, 3) for k, v in step_bytes.items()} }); "
        f"prefill groups {groups}; decode caches {run['cache_bytes'] / 1e9:.4f} GB {run['cache_dtypes']}; peak "
        f"memory {eager['peak_mem_gb']:.2f} GB; 0 host syncs inside decode chunks")
    ffn = path_launches(cfg, 1)["tensordash_matmul_fused"]
    log(f"{tag}: kernel launches {launches} == path's ({ffn} fused gates, {ffn} emitted-mask plans and "
        f"{ffn + 1} planned products (w_down and the LM head) a model call, {calls} calls; one values plan, "
        f"the head's: block {block}, {head[0]['blocks']} blocks); plan cache {pc['hits']} hits / "
        f"{pc['misses']} miss; no plain version ran")
    graph = serve_graph_phase(params, cfg, prompts, rt, eager, tag=f"{tag} graph", max_len=max_len)
    per_step = {k: v / CHUNK for k, v in by_wrapper(graph["capture_launches"]).items()}
    log(f"{tag}: device launches per decode step: {graph['replay_device_launches_all'] / CHUNK:.0f} "
        f"(one profiled replay / {CHUNK}), of them the port's kernels {per_step}; decode ms per step "
        f"eager {eager['ms_per_decode_step']:.3f}, graph {graph['ms_per_decode_step_replayed']:.3f} (bound "
        f"{bound_ms:.4f}); tokens/s eager {eager['tok_per_s']:.2f}, graph {graph['tok_per_s']:.2f}; peak "
        f"memory {max(eager['peak_mem_gb'], graph['peak_mem_gb']):.2f} GB")
    ref_l2, top1 = reference_phase(params, cfg, prompts, tag=tag.replace("serve", "reference"))
    eager.update(graph=graph, reference_rel_l2=ref_l2, reference_top1=top1,
                 launches_per_decode_step_graph=per_step)
    if then is not None:
        eager.update(then(params, cfg, eager, prompts, rt))
    del params
    free()
    return eager


def decode_logits(params, cfg, prompt, tokens, rt, max_len: int):
    """One request's logits along ``tokens`` (its greedy tokens), decoded as
    the engine decodes: the prompt's prefill (the first token's logits),
    its caches grown to ``max_len`` rows, then ``tokens[:-1]`` fed back one
    decode step each at a per-row position.  ``[len(tokens), V]`` fp32."""
    import torch
    from repro_torch.models import model as M

    toks = torch.as_tensor(prompt, device=rt.device)[None]
    with torch.inference_mode(), rt.use():
        first, caches = M.prefill(params, cfg, {"tokens": toks})
        caches = rt.grow_caches(cfg, caches, 1, max_len)
        out, pos = [first[0, -1].float()], torch.tensor([toks.shape[1]], device=rt.device)
        for t in tokens[:-1]:
            logits, caches = M.decode_step(params, cfg, caches, {"tokens": torch.tensor([[t]], device=rt.device)},
                                           pos)
            out.append(logits[0, -1].float())
            pos += 1
    return torch.stack(out)


def row_rel_l2(got, want) -> list:
    """Relative L2 of each row of ``got`` against the same row of ``want``."""
    import torch

    return (torch.linalg.vector_norm(got - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1)).tolist()


def gemma2_long_request(params, cfg, summary, prompts, rt) -> dict:
    """One LONG_PROMPT-token request and LONG_NEW new tokens through an
    engine of ``LONG_PROMPT + LONG_NEW`` cache rows (the decode chunk as one
    CUDA graph): prefill runs 5 query chunks, and every local layer masks
    keys more than ``sliding_window`` positions back at every decode step.
    Its decode logits (:func:`decode_logits`, along the engine's greedy
    tokens, which they must give back) are held against a teacher-forced
    ``M.forward`` over prompt + tokens on the card (``dense`` backend: one
    unchunked pass) within ``REF_REL_L2`` per position; top-1 agreement is
    reported.  Logs the cache GB, the prefill and decode times and the peak
    memory."""
    import numpy as np
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.models import model as M
    from repro_torch.runtime import PlanCache
    from repro_torch.serve.engine import ServeEngine

    max_len = LONG_PROMPT + LONG_NEW
    if not (cfg.local_global_alternate and LONG_PROMPT - cfg.sliding_window >= 1024 and
            LONG_PROMPT % cfg.q_chunk == 0 and LONG_PROMPT // cfg.q_chunk > 1):
        raise AssertionError("gemma2 long: the prompt must run chunked prefill and reach past the window")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=LONG_PROMPT)
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, slots=1, chunk=CHUNK, max_len=max_len,
                      rt=rt.replace(plan_cache=PlanCache()), cuda_graph=True)
    cache_gb = sum(t.numel() * t.element_size() for c in eng.caches["layers"] for t in c if t is not None) / 1e9
    eng.submit(prompt, max_new=LONG_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()  # admission: the 5120-token prefill, then the eager warm-up chunk
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tokens = eng.run()[0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    st = eng.stats()
    del eng
    free()
    if len(tokens) != LONG_NEW or st["decode_graph_captures"] != 1:
        raise AssertionError(f"gemma2 long: {len(tokens)} tokens, {st['decode_graph_captures']} captures")
    got = decode_logits(params, cfg, prompt, tokens, rt, max_len)
    decode_top1 = int((got.argmax(-1).cpu() == torch.tensor(tokens)).sum())
    if decode_top1 != LONG_NEW:
        raise AssertionError(f"gemma2 long: decode_logits gives back {decode_top1}/{LONG_NEW} of the engine's tokens")
    seq = torch.as_tensor(np.concatenate([prompt, tokens[:-1]]), device="cuda")[None]
    with torch.inference_mode(), rtm.Runtime(backend="dense", device="cuda").use():
        want = M.forward(params, cfg, {"tokens": seq})[0, LONG_PROMPT - 1:].float()
    rel = row_rel_l2(got, want)
    top1 = int((want.argmax(-1) == got.argmax(-1)).sum())
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = {"prompt": LONG_PROMPT, "new": LONG_NEW, "max_len": max_len, "cache_gb": cache_gb,
           "prefill_and_warmup_s": t1 - t0, "rest_s": t2 - t1, "steps": st["steps_run"],
           "rel_l2_per_position": rel, "worst_rel_l2": max(rel), "top1_vs_forward": top1, "peak_mem_gb": peak}
    log(f"gemma2 long: {LONG_PROMPT}-token prompt + {LONG_NEW} new tokens, max_len {max_len}, decode caches "
        f"{cache_gb:.3f} GB (bf16, 1 slot); admission (prefill, {LONG_PROMPT // cfg.q_chunk} query chunks) and the "
        f"warm-up chunk {t1 - t0:.3f} s, the rest {t2 - t1:.3f} s; captured once; decode logits against a "
        f"teacher-forced forward over {seq.shape[1]} tokens (dense backend, local layers windowed at "
        f"{cfg.sliding_window}): worst relative L2 {max(rel):.3e} (bound {REF_REL_L2:.3e}), per position "
        f"{[round(r, 5) for r in rel]}; top-1 agreement {top1}/{LONG_NEW}; peak memory {peak:.2f} GB")
    if max(rel) > REF_REL_L2:
        raise AssertionError(f"gemma2 long: decode against forward relative L2 {max(rel)} > {REF_REL_L2}")
    return {"long_request": res}


def kv_int8_checks(params, cfg8, summary, prompts, rt) -> dict:
    """The int8 KV cache against the bf16 one on the same weights and
    requests: the served caches hold int8 K/V and fp32 scales at
    ``(128 + 4) / 256`` of the bf16 cache's bytes; the bf16-cache engine's
    decode ms per step under the graph at the same ``max_len``, beside the
    int8 one's; then each request's decode logits along the int8 run's
    greedy tokens (:func:`decode_logits`) with either cache, within
    ``KV_REL_L2`` relative L2 per step, top-1 agreement reported."""
    import dataclasses

    import torch
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves

    cfg16 = dataclasses.replace(cfg8, kv_cache_quant=False)
    layer = M.init_cache(cfg8, SLOTS, KV_MAX_LEN, device="meta")["layers"][0]
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in tree_leaves(c))
    bytes8, bytes16 = (nbytes(M.init_cache(c, SLOTS, KV_MAX_LEN, device="meta")) for c in (cfg8, cfg16))
    want_ratio = (cfg8.resolved_head_dim + 4) / (2 * cfg8.resolved_head_dim)
    served = (summary["cache_dtypes"], summary["graph"]["cache_dtypes"])
    if not (layer.k.dtype == torch.int8 and layer.k_scale.dtype == torch.float32 and
            served == (["float32", "int8"], ["float32", "int8"]) and summary["cache_bytes"] == bytes8 and
            abs(bytes8 / bytes16 - want_ratio) < 1e-12):
        raise AssertionError(f"kv-int8: cache dtypes {served}, bytes {summary['cache_bytes']} / {bytes8} / {bytes16}")
    bf16 = drive_serve(params, cfg16, prompts, rt, cuda_graph=True, max_len=KV_MAX_LEN)
    ms16 = bf16["decode_s"]["replay"] / (bf16["chunks"]["replay"] * CHUNK) * 1e3
    ms8 = summary["graph"]["ms_per_decode_step_replayed"]
    tokens = summary["graph"]["greedy_tokens"]
    rel, top1, n, given = [], 0, 0, 0
    for rid, p in enumerate(prompts):
        got = decode_logits(params, cfg8, p, tokens[rid], rt, KV_MAX_LEN)
        want = decode_logits(params, cfg16, p, tokens[rid], rt, KV_MAX_LEN)
        # batch 1 here against the engine's 4 rows: other block rows, other
        # bf16 roundings, so a near-tie may pick another token
        given += int((got.argmax(-1).cpu() == torch.tensor(tokens[rid])).sum())
        rel += row_rel_l2(got[1:], want[1:])  # the decode steps (row 0 is the prefill's, cache-free)
        top1 += int((got[1:].argmax(-1) == want[1:].argmax(-1)).sum())
        n += got.shape[0] - 1
    res = {"cache_bytes_int8": bytes8, "cache_bytes_bf16": bytes16, "cache_ratio": bytes8 / bytes16,
           "ms_per_decode_step_int8": ms8, "ms_per_decode_step_bf16": ms16,
           "bf16_greedy_tokens_equal": bf16["out"] == tokens, "decode_rel_l2_worst": max(rel),
           "decode_rel_l2_mean": sum(rel) / len(rel), "decode_top1": top1, "decode_steps": n,
           "engine_tokens_given_back": given}
    log(f"kv-int8: caches int8 K/V + fp32 scales, {bytes8 / 1e9:.4f} GB against {bytes16 / 1e9:.4f} GB in bf16 "
        f"({bytes8 / bytes16:.4f}x, (128 + 4) / 256 = {want_ratio:.4f}) at {SLOTS} slots x {KV_MAX_LEN} rows; "
        f"graph decode {ms8:.3f} ms per step against {ms16:.3f} ms with the bf16 cache (the whole cache is "
        f"dequantized every step, as JAX does); greedy tokens {'equal' if res['bf16_greedy_tokens_equal'] else 'differ'}")
    log(f"kv-int8: decode logits int8 against bf16 cache along the int8 run's tokens, {n} steps: relative L2 "
        f"worst {max(rel):.3e}, mean {res['decode_rel_l2_mean']:.3e} (bound {KV_REL_L2}); top-1 agreement {top1}/{n}; "
        f"batch-1 int8 decode gives back {given}/{n + len(prompts)} of the 4-slot engine's tokens")
    if max(rel) > KV_REL_L2:
        raise AssertionError(f"kv-int8: int8 against bf16 cache relative L2 {max(rel)} > {KV_REL_L2}")
    return {"kv_int8": res}


# ---------------------------------------------------------------------------
# frontend phases: qwen2-vl (M-RoPE, vision embeddings), musicgen (audio)
# ---------------------------------------------------------------------------


def vl_positions(b: int):
    """Qwen2-VL's rope index ``[b, 3, S]`` of the frontend prompt: text
    ``i`` at (i, i, i), patch (r, c) of the 1 x VL_GRID image at (VL_TEXT,
    VL_TEXT + r, VL_TEXT + c), the trailing text from VL_TEXT + max(VL_GRID)."""
    import numpy as np

    gh, gw = VL_GRID
    rows = [(i, i, i) for i in range(VL_TEXT)]
    rows += [(VL_TEXT, VL_TEXT + r, VL_TEXT + c) for r in range(gh) for c in range(gw)]
    start = VL_TEXT + max(gh, gw)
    rows += [(start + i,) * 3 for i in range(VL_TEXT)]
    return np.broadcast_to(np.asarray(rows, np.int32).T, (b, 3, len(rows))).copy()


def frontend_inputs(cfg, b: int, device, dtype):
    """The frontend prompt ``{"inputs_embeds": [b, S, d], "positions": [b,
    3, S] under M-RoPE}`` and ``FRONTEND_NEW`` one-position step embeddings
    ``[n, b, 1, d]``, from numpy seed 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    s = 2 * VL_TEXT + VL_GRID[0] * VL_GRID[1]
    emb = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
    batch = {"inputs_embeds": emb(b, s, cfg.d_model)}
    if cfg.mrope_sections is not None:
        batch["positions"] = torch.from_numpy(vl_positions(b)).to(device)
    return batch, emb(FRONTEND_NEW, b, 1, cfg.d_model)


def frontend_decode(params, cfg, batch, steps, rt):
    """``M.prefill`` over ``batch``, its caches grown to the prompt plus the
    steps, then one ``M.decode_step`` per step embedding at the sequence
    index (M-RoPE: text mode).  Returns each model call's last-position
    logits ``[b, ...]`` in fp32 (the prefill's first), the caches, the
    prefill's and each step's seconds (the card synchronized before each
    clock read)."""
    import torch
    from repro_torch.models import model as M

    s = batch["inputs_embeds"].shape[1]
    with torch.inference_mode(), rt.use():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, caches = M.prefill(params, cfg, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        caches = rt.grow_caches(cfg, caches, steps.shape[1], s + steps.shape[0])
        logits, step_s = [first[:, -1].float()], []
        for t, x in enumerate(steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, caches = M.decode_step(params, cfg, caches, {"inputs_embeds": x}, s + t)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            logits.append(out[:, -1].float())
    return logits, caches, prefill_s, step_s


def teacher_forced(params, cfg, batch, steps, rt):
    """``M.forward`` over the prompt and the step embeddings (M-RoPE: the
    steps in text mode at their sequence index, as decode rotates them):
    the logits at the prompt's last position and each step's, ``[n + 1, b,
    ...]`` fp32."""
    import torch
    from repro_torch.models import model as M

    b, s = batch["inputs_embeds"].shape[:2]
    n = steps.shape[0]
    full = {"inputs_embeds": torch.cat([batch["inputs_embeds"], steps[:, :, 0].transpose(0, 1)], dim=1)}
    if "positions" in batch:
        text = torch.arange(s, s + n, device=steps.device).expand(b, 3, n)
        full["positions"] = torch.cat([batch["positions"], text.to(batch["positions"].dtype)], dim=2)
    with torch.inference_mode(), rt.use():
        return M.forward(params, cfg, full)[:, s - 1:].float().transpose(0, 1)


def frontend_phase(cfg, tag: str) -> dict:
    """``cfg`` (a frontend config, bf16 weights from seed 0) through the
    model entry points on ``cuda``: the frontend prompt's prefill, then
    FRONTEND_NEW eager decode steps.  The wrapper launches of the run (set
    to 0 just before it) must be the path's (:func:`path_launches` over 1 +
    FRONTEND_NEW model calls, the head's ``values`` plan built once: for
    qwen2-vl-ReLU per call a fused gate, an emitted plan and a planned
    ``w_down`` per layer and the planned head; musicgen none), no plain
    version may run; prefill logits within ``REF_REL_L2`` of the
    ``reference`` backend on the card, and the prefill's and every step's
    logits within ``REF_REL_L2`` of a teacher-forced ``M.forward`` on
    ``dense`` (per row and position).  Reports prefill ms (after one
    untimed prefill), decode ms per step (eager, a host clock around each
    synchronized step) against the bound from the bytes a step moves, peak
    memory and
    device launches per step (one more step at the last position, which
    rewrites the same cache row, profiled)."""
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.models import model as M
    from repro_torch.runtime import PlanCache
    from repro_torch.runtime.plan import _fit_block

    params, param_gb = init_whole(cfg, tag)
    batch, steps = frontend_inputs(cfg, SLOTS, "cuda", torch.bfloat16)
    s, n = batch["inputs_embeds"].shape[1], steps.shape[0]
    rt = rtm.Runtime(backend="cuda", device="cuda", plan_cache=PlanCache())
    with torch.inference_mode(), rt.replace(plan_cache=PlanCache()).use():
        M.prefill(params, cfg, batch)  # untimed, on another plan cache: the timed prefill runs warm
    torch.cuda.reset_peak_memory_stats()
    with no_plain_versions(tag):
        T.reset_launch_counts()
        logits, caches, prefill_s, step_s = frontend_decode(params, cfg, batch, steps, rt)
        launches = T.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.inference_mode(), rt.use():
            last = lambda: M.decode_step(params, cfg, caches, {"inputs_embeds": steps[-1]}, s + n - 1)
            device = device_launches(last, reps=1)
    calls = 1 + n
    want = dict.fromkeys(launches, 0)
    want.update(path_launches(cfg, calls, head_plans=1))
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches} != path's {want}")
    plans = rt.plan_cache.plan_stats()
    block = (_fit_block(128, cfg.vocab_size), _fit_block(512, cfg.d_model))
    head_plans = [] if cfg.frontend == "audio" else [(block, (cfg.vocab_size, cfg.d_model))]
    if [(p["block"], p["shape"]) for p in plans] != head_plans:
        raise AssertionError(f"{tag}: plans {plans}, expected {head_plans}")
    if not all(bool(torch.isfinite(x).all()) for x in logits):
        raise AssertionError(f"{tag}: non-finite logits")
    got = torch.stack(logits)  # [n + 1, b, ...]
    want_tf = teacher_forced(params, cfg, batch, steps, rtm.Runtime(backend="dense", device="cuda"))
    rows = lambda x: x.flatten(2).flatten(0, 1)  # [n + 1, b, ...] -> one row per call and sequence
    tf_rel = row_rel_l2(rows(got), rows(want_tf))
    with torch.inference_mode(), rtm.Runtime(backend="reference", device="cuda").use():
        ref = M.prefill(params, cfg, batch)[0][:, -1].float()
    ref_rel = row_rel_l2(got[0].flatten(1), ref.flatten(1))
    top1 = int((rows(got).argmax(-1) == rows(want_tf).argmax(-1)).sum())
    step_bytes = decode_bytes(params, M.init_cache(cfg, SLOTS, s + n, device="meta"), cfg)
    bound_ms = sum(step_bytes.values()) / mem_bandwidth(torch.cuda.get_device_name(0)) * 1e3
    ms = sum(step_s) / n * 1e3
    per_call = {k: v / calls for k, v in by_wrapper(launches).items()}
    n_device = sum(c for _, c in device)
    res = {"prefill_positions": s, "batch": SLOTS, "decode_steps": n, "prefill_ms": prefill_s * 1e3,
           "ms_per_decode_step": ms, "decode_step_ms": [t * 1e3 for t in step_s], "decode_bound_ms": bound_ms,
           "decode_bytes": step_bytes, "peak_mem_gb": peak, "param_gb": param_gb, "launches": launches,
           "launches_per_model_call": per_call, "device_launches_per_decode_step": n_device,
           "device_kernels_per_decode_step": dict(device), "plans": plans,
           "reference_rel_l2": ref_rel, "teacher_forced_rel_l2": tf_rel, "teacher_forced_top1": top1,
           "logits_shape": list(logits[-1].shape)}
    prompt = (f"{VL_TEXT} text, 1 x {VL_GRID[0]} x {VL_GRID[1]} image patches, {VL_TEXT} text at M-RoPE "
              "positions" if "positions" in batch else "frame embeddings")
    log(f"{tag}: {SLOTS} x {s} positions ({prompt}) then {n} eager decode steps; "
        f"logits {res['logits_shape']} a step; prefill {res['prefill_ms']:.3f} ms; decode {ms:.3f} ms per step "
        f"(bound {bound_ms:.4f} ms from the bytes a step moves, GB: "
        f"{ {k: round(v / 1e9, 3) for k, v in step_bytes.items()} }); peak memory {peak:.2f} GB")
    log(f"{tag}: kernel launches {launches} == path's over {calls} model calls ({per_call} a call; "
        f"plans {[(p['block'], p['shape']) for p in plans]}); no plain version ran; {n_device} device launches "
        f"per decode step (one profiled step)")
    log(f"{tag}: prefill logits against reference on the card, worst relative L2 {max(ref_rel):.3e}; prefill "
        f"and decode logits against a teacher-forced forward over {s + n} positions (dense backend): worst "
        f"{max(tf_rel):.3e} (bound {REF_REL_L2:.3e}) over {len(tf_rel)} rows x positions, top-1 agreement "
        f"{top1}/{len(tf_rel)}")
    if max(ref_rel) > REF_REL_L2 or max(tf_rel) > REF_REL_L2:
        raise AssertionError(f"{tag}: relative L2 against reference {max(ref_rel)} / teacher-forced forward "
                             f"{max(tf_rel)} > {REF_REL_L2}")
    del params, caches
    free()
    return res


# ---------------------------------------------------------------------------
# grid-family kernel phase (v2/v1) and block_zero_mask
# ---------------------------------------------------------------------------


def mask_row(label, x, bm, bk, bw, main=False, stage=None):
    """``block_zero_mask`` of ``x`` exactly equal to its plain version,
    timed beside ``torch.count_nonzero`` of the same blocks and its bound."""
    import torch
    from repro_torch.kernels import block_zero_mask, ref

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
        "main_path": main, "stage": stage,
    }
    log(f"  block_zero_mask {label:<21} {row['dtype']:<8} {row['shape']:<34} kernel "
        f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  torch.count_nonzero "
        f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']})  "
        f"{row['zero_blocks']}/{mb * kb} zero blocks, exact")
    return row


def grid_kernel_phase(bw: float):
    """v2/v1 planned and fused at the decode and small shapes: bit-equal to
    the ragged kernel at the same geometry, within tolerance of the plain
    version, masks equal; then ``block_zero_mask`` exactly equal to its
    plain version.  Each case is timed beside its bound and one torch call."""
    import torch
    from repro_torch.kernels import ref, tensordash_spmm as T

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
            row["ratio"], row["bound_share"] = row["ms"] / library_ms, row["bound_ms"] / row["ms"]
            rows.append(row)
            log(f"  {label + ' ' + grid:<37} {row['dtype']:<8} {row['shape']:<28} kernel "
                f"{row['ms']:.4f} ms  plain {plain_ms:.4f} ms  torch.matmul {library_ms:.4f} ms  "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})  {versus(row)}  "
                f"max_abs_err {err:.3e}  == ragged")

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

    xw = torch.randn(4096, 11008, generator=gdev, device=dev).to(bf16)
    planted = torch.rand(32, 86, generator=gdev, device=dev) < 0.3  # 128 x 128 zero blocks
    xw = (xw.reshape(32, 128, 86, 128) * ~planted[:, None, :, None]).reshape(4096, 11008)
    rows.append(mask_row("planted zero blocks", xw, 128, 128, bw))
    del xw
    lm_head = (torch.randn(4096, 102400, generator=gdev, device=dev) / 64).to(bf16)
    rows.append(mask_row("LM head lm_head.T", lm_head.T, 128, 512, bw, main=True))
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
        run = drive_serve(params, cfg, prompts, rt)
        out, launches, st, wall, groups = run["out"], run["launches"], run["stats"], run["wall"], run["groups"]
        decode_s, decode_syncs, syncs = run["decode_s"]["eager"], run["decode_syncs"]["eager"], run["syncs"]
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


# ---------------------------------------------------------------------------
# training: the backward products at training shapes, then train steps
# ---------------------------------------------------------------------------


def train_kernel_phase(bw: float):
    """The planned kernel at the training step's backward shapes: one
    microbatch of TRAIN_TOKENS tokens at full deepseek-7b widths, fp32
    operands (transposed views where the backward takes them) and a bf16
    output, as ``runtime.autodiff`` runs them for a bf16 model.  Each row's
    arithmetic is held against the plain version in fp32 (the kernel's own
    fp32 output, rtol = atol = 2e-4), its bf16 output equal bit for bit to
    that fp32 output rounded once to bf16 (the store), and v2/v1 bit-equal
    to ragged on two rows; timed beside one ``torch.matmul`` of the same
    fp32 product and its bound.  Then ``block_zero_mask`` on the two fp32
    cotangents planned by value, and a launch count: one device launch per
    wrapper call of the fp32-in, bf16-out instantiation."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref, tensordash_spmm as T
    from repro_torch.runtime.plan import _fit_block

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    f32, bf16 = torch.float32, torch.bfloat16
    t, d, f, v = TRAIN_TOKENS, 4096, 11008, 102400
    rows, calls = [], {}

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def planted(m, n, bm, bn, density):
        keep = torch.rand(m // bm, n // bn, generator=gen, device=dev) < density
        return keep.to(torch.int8)

    def masked(x, mask):  # zero the 128 x 128 blocks of x that mask drops
        m, n = x.shape
        return (x.reshape(m // 128, 128, n // 128, 128) * mask[:, None, :, None]).reshape(m, n)

    def bwd_case(label, a, b, bm, bk, bn, plan, *, grids=False):
        nnz, idx, rs, wr, wk = plan
        m, k, n = a.shape[0], a.shape[1], b.shape[1]
        call = lambda: T.tensordash_matmul_planned(nnz, idx, a, b, bm=bm, bk=bk, bn=bn, out_dtype=bf16,
                                                   workqueue=(rs, wr, wk))
        out, out32 = call(), T.tensordash_matmul_planned(nnz, idx, a, b, bm=bm, bk=bk, bn=bn,
                                                         workqueue=(rs, wr, wk))
        plain = lambda: ref.tensordash_matmul_ref(nnz, idx, a, b, bm=bm, bk=bk, bn=bn)
        err = check_close(label, out32, plain())
        if out.dtype != bf16 or not torch.equal(out, out32.to(bf16)):
            raise AssertionError(f"{label}: the bf16 store is not one rounding of the fp32 accumulator")
        if grids:
            for grid in ("v2", "v1"):
                got = T.tensordash_matmul_planned(nnz, idx, a, b, bm=bm, bk=bk, bn=bn, out_dtype=bf16,
                                                  compact_grid=grid)
                if not torch.equal(got, out):
                    raise AssertionError(f"{label} {grid}: not bit-equal to the ragged kernel")
        del out32
        calls[label] = call
        nbytes, flops = plan_bytes_flops(nnz, idx, a, b, bm, bk, out_elems=m * n, out_esz=2)
        t_bytes, t_ops = nbytes / bw * 1e3, flops / PEAK_FLOPS["torch.float32"] * 1e3
        row = {
            "case": label, "kernel": "tensordash_matmul_planned", "dtype": "float32->bfloat16",
            "shape": f"[{m},{k}]@[{k},{n}]", "strides": (tuple(a.stride()), tuple(b.stride())),
            "block": (bm, bk, bn), "density": float(nnz.sum()) / idx.numel(), "max_abs_err": err,
            "ms": cuda_ms(call, iters=5, warmup=1), "plain_ms": cuda_ms(plain, iters=2, warmup=1),
            "library_ms": cuda_ms(lambda: torch.matmul(a, b), iters=5, warmup=1),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "main_path": True, "stage": "train", "v2_v1_equal": grids,
            "tile": T.kernel_tile(bm, bk, bn, 4)._asdict(),
            "splits": T.launch_splits(m, k, n, bm, bk, bn, dev, f32),
        }
        row["ratio"], row["bound_share"] = row["ms"] / row["library_ms"], row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"  {label:<30} f32->bf16 {row['shape']:<26} density {row['density']:.2f}  kernel "
            f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  torch.matmul {row['library_ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})  {versus(row)}  max_abs_err {err:.3e}  "
            f"S {row['splits']}{'  v2/v1 == ragged' if grids else ''}")

    # the FFN gate (fused ReLU): g_pre [T, d_ff] behind a 40% emitted mask
    gmask = planted(t, f, 128, 128, 0.4)
    g_pre = masked(rand(t, f), gmask)
    w_gate = rand(d, f, scale=1 / 64).to(bf16)
    bwd_case("gate da = g @ w_gate.T", g_pre, w_gate.float().T, 128, 128, 512,
             T.plan_from_mask_csr(gmask))
    del w_gate
    x2 = rand(t, d).to(bf16)
    dnnz, didx = T.dense_plan(t // 128, d // 512, dev)
    bwd_case("gate db = x.T @ g", x2.float().T, g_pre, 512, 128, 128,
             T.transpose_plan_csr(dnnz, didx), grids=True)
    del x2
    # w_down: the cotangent planned by value (planted zero blocks), h2 by its mask
    g = masked(rand(t, d), planted(t, d, 128, 128, 0.4))
    w_down = rand(f, d, scale=1 / 105).to(bf16)
    bwd_case("w_down da = g @ w_down.T", g, w_down.float().T, 128, 128, 128,
             T.plan_blocks_csr(g, 128, 128), grids=True)
    del w_down
    h2 = g_pre.to(bf16)  # the gate's blocks: h = relu(gate) * up keeps them
    hnnz, hidx = T.plan_from_mask(gmask)
    bwd_case("w_down db = h.T @ g", h2.float().T, g, 128, 128, 128, T.transpose_plan_csr(hnnz, hidx))
    mask_rows = [mask_row("w_down cotangent", g, 128, 128, bw, main=True, stage="train")]
    del h2, g_pre, g
    # the LM head, side B: g' = dlogits.T [V, T], a strided view
    dlogits = rand(t, v, scale=1e-4)
    gt = dlogits.T
    h = rand(t, d).to(bf16)
    bwd_case("LM head da = g'.T-view @ h", gt, h.float(), 128, 128, 512, T.plan_blocks_csr(gt, 128, 128))
    lm_head = rand(d, v, scale=1 / 64).to(bf16)
    wnnz, widx = T.plan_blocks(lm_head.T, 128, 512)
    bwd_case("LM head db = lm_head @ g'", lm_head.T.float().T, gt, 512, 128, 128,
             T.transpose_plan_csr(wnnz, widx))
    mask_rows.append(mask_row("LM head cotangent", gt, 128, 128, bw, main=True, stage="train"))
    del lm_head, h, dlogits, gt
    # the mamba2 head's (SSM train phase): vocab 50280 at block 120, the
    # weight gradient's K blocks 120 wide
    c = get_config(SSM_ARCH)
    sv, sd, sb = c.vocab_size, c.d_model, _fit_block(128, c.vocab_size)
    gt = rand(t, sv, scale=1e-4).T
    h = rand(t, sd).to(bf16)
    bwd_case("ssm LM head da = g'.T-view @ h", gt, h.float(), sb, 128, 512, T.plan_blocks_csr(gt, sb, 128))
    lm_head = rand(sd, sv, scale=sd**-0.5).to(bf16)
    wnnz, widx = T.plan_blocks(lm_head.T, sb, 512)
    bwd_case(f"ssm LM head db = lm_head @ g' (bk {sb})", lm_head.T.float().T, gt, 512, sb, 128,
             T.transpose_plan_csr(wnnz, widx))
    del lm_head, h, gt
    # qwen2-vl-ReLU's (the frontend train phase, one layer): the head at
    # vocab 152064 x d 8192 (1188 block rows; the weight gradient's rows of
    # 1188 K blocks) and w_down at d_ff 29568 on the gate's mask at bk 128
    c = get_config(VL_ARCH)
    vv, vd, vf = c.vocab_size, c.d_model, c.d_ff
    gt = rand(t, vv, scale=1e-4).T
    h = rand(t, vd).to(bf16)
    bwd_case("qwen2-vl LM head da = g'.T-view @ h", gt, h.float(), 128, 128, 512, T.plan_blocks_csr(gt, 128, 128))
    lm_head = rand(vd, vv, scale=vd**-0.5).to(bf16)
    wnnz, widx = T.plan_blocks(lm_head.T, 128, 512)
    bwd_case("qwen2-vl LM head db = lm_head @ g'", lm_head.T.float().T, gt, 512, 128, 128,
             T.transpose_plan_csr(wnnz, widx))
    del lm_head, h, gt
    vmask = planted(t, vf, 128, 128, 0.4)
    g = masked(rand(t, vd), planted(t, vd, 128, 128, 0.4))
    w_down = rand(vf, vd, scale=vf**-0.5).to(bf16)
    bwd_case("qwen2-vl w_down da = g @ w_down.T", g, w_down.float().T, 128, 128, 128, T.plan_blocks_csr(g, 128, 128))
    del w_down
    h2 = masked(rand(t, vf), vmask).to(bf16)
    hnnz, hidx = T.plan_from_mask(vmask)
    bwd_case("qwen2-vl w_down db = h.T @ g (bk 128)", h2.float().T, g, 128, 128, 128,
             T.transpose_plan_csr(hnnz, hidx))
    del h2, g
    launch = count_launches(calls)
    torch.cuda.empty_cache()
    return rows + mask_rows, launch


# ---------------------------------------------------------------------------
# the one-launch planner at the path's shapes
# ---------------------------------------------------------------------------


def host_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Host wall ms per call of ``fn``, ``iters`` calls back to back and a
    synchronize at the end: what a caller on the path waits per plan."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def planner_edge_cases() -> int:
    """Every planner mode on shapes the path does not give it, each plan
    bit-equal to the plain chain on the card: one block row, one K block,
    86 and 800 K blocks, rows and K blocks past one shared-memory stage,
    all-zero rows and masks, dense masks, fp32 and bf16, transposed views and
    views off the 16-byte grid, NaN and -0 in zero blocks, bool and int8
    masks, coarsen 2, 4 and Nb, and at qwen2-vl's 231 gate-mask blocks
    (d_ff 29568) every coarsening that divides them: 1 (what the runtime
    fits for its ``w_down``, whose bk 462 is no multiple of 128), 3, 7, 11
    and 231.  Returns the number of plans checked."""
    import torch
    from repro_torch.kernels import block_mask, ref, tensordash_spmm as T

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    n = [0]

    def same(label, got, want):
        torch.cuda.synchronize()
        if len(got) != len(want) or any(g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w)
                                        for g, w in zip(got, want)):
            raise AssertionError(f"planner edge case {label}: differs from the plain chain")
        n[0] += 1

    def mask_of(mb, kb, kind):
        if kind in ("zero", "dense"):
            return torch.full((mb, kb), int(kind == "dense"), dtype=torch.int8)
        m = (torch.rand(mb, kb, generator=gen) < 0.35).to(torch.int8)
        if kind == "zero_rows":
            m[::2] = 0
        return m

    for mb, kb, bm, bk in ((1, 5, 4, 8), (6, 1, 4, 8), (1, 1, 4, 8), (3, 86, 2, 2), (2, 800, 2, 1),
                           (5000, 8, 2, 16), (9, 7, 4, 8), (1, 231, 4, 2), (8, 231, 2, 2)):
        for kind in ("mixed", "zero_rows", "zero", "dense"):
            mask = mask_of(mb, kb, kind)
            keep = torch.rand(mb * bm, kb * bk, generator=gen) < 0.3
            keep.view(mb, bm, kb, bk)[:, 0, :, 0] = True
            blocks = mask.bool().repeat_interleave(bm, 0).repeat_interleave(bk, 1)
            a = torch.randn(mb * bm, kb * bk, generator=gen) * (keep & blocks)
            for dtype in (torch.float32, torch.bfloat16):
                x = a.to(dev, dtype)
                label = f"values [{mb},{kb}] {bm}x{bk} {kind} {row_dtype(dtype)}"
                same(label, T.plan_blocks_csr(x, bm, bk), ref.plan_blocks_csr_ref(x, bm, bk))
                same(label + " .T", T.plan_blocks_csr(x.T, bk, bm), ref.plan_blocks_csr_ref(x.T, bk, bm))
                same(label + " mask", (block_mask.block_zero_mask(x.T, bm=bk, bk=bm),),
                     (ref.block_any_nonzero(x.T, bk, bm),))
            for dt in (torch.int8, torch.bool):
                m = mask.to(dev, dt)
                for c in sorted({1, 2, 3, 4, 7, 11, kb}):
                    if kb % c == 0:
                        label = f"emitted [{mb},{kb}] {kind} {dt} coarsen {c}"
                        same(label, T.plan_from_mask_csr(m, coarsen=c), ref.plan_from_mask_csr_ref(m, coarsen=c))
                        mt = m.T.contiguous().T  # a strided view
                        same(label + " view", T.plan_from_mask_csr(mt, coarsen=c),
                             ref.plan_from_mask_csr_ref(mt, coarsen=c))
            nnz, idx = ref.mask_to_plan_ref(mask.to(dev))
            same(f"transpose [{mb},{kb}] {kind}", T.transpose_plan_csr(nnz, idx),
                 ref.transpose_plan_csr_ref(nnz, idx))
    # views off the 16-byte grid (element loads), NaN and -0 in zero blocks
    base = torch.zeros(64, 257)
    base[5, 17] = float("nan")
    base[40, 3] = -0.0
    base[33, 200] = 1.0
    for dtype in (torch.float32, torch.bfloat16):
        x = base.to(dev, dtype)[:, 1:]  # base pointer and row stride off the grid
        for bm, bk in ((8, 32), (64, 256), (1, 1)):
            same(f"unaligned {row_dtype(dtype)} {bm}x{bk}", T.plan_blocks_csr(x, bm, bk),
                 ref.plan_blocks_csr_ref(x, bm, bk))
        same(f"unaligned {row_dtype(dtype)} .T", T.plan_blocks_csr(x.T, 32, 8), ref.plan_blocks_csr_ref(x.T, 32, 8))
    m = (torch.rand(2, 24576, generator=gen) < 0.5).to(dev, torch.int8)  # the widest row the kernel stages
    same("emitted [2,24576]", T.plan_from_mask_csr(m), ref.plan_from_mask_csr_ref(m))
    return n[0]


def planner_phase(bw: float):
    """Every planner mode at the shapes the serve and train paths give it:
    the five int32 arrays bit-equal to the plain chain on the card (the
    mask mode is checked by ``mask_row``); timed (device ms and host wall
    per call) beside the plain chain, the unfused path on the card (for
    ``values``: the mask kernel, then the chain's compaction), and
    ``torch.count_nonzero`` of the same blocks; its bound (bytes this data
    needs: each zero block read whole, one element of each effectual block
    or each mask byte or effectual forward entry, the plan written once);
    the profiler's device launches of one chain call; then one device
    launch per planner call."""
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.kernels import block_mask, ref, tensordash_spmm as T
    from repro_torch.runtime.plan import _fit_block

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    t, d, f, v = TRAIN_TOKENS, 4096, 11008, 102400
    rows, calls = [], {}

    def plan_bytes(r, c):
        return 4 * (3 * r * c + 2 * r + 1)

    def chained(mask):  # the unfused path's compaction: the torch chain after a mask
        nnz, idx = ref.mask_to_plan_ref(mask)
        return (nnz, idx) + ref.workqueue_ref(nnz, idx)

    def case(label, mode, call, plain, *, before=None, library=None, nbytes, compares, shape,
             stage, main=True):
        got, want = call(), plain()
        torch.cuda.synchronize()
        if len(got) != 5 or any(g.dtype != torch.int32 or g.shape != w.shape or not torch.equal(g, w)
                                for g, w in zip(got, want)):
            raise AssertionError(f"planner {label}: differs from the plain chain")
        calls[label] = call
        before = before or plain
        t_bytes, t_ops = nbytes / bw * 1e3, compares / COMPARE_RATE * 1e3
        row = {
            "case": label, "kernel": block_mask.COUNTERS[mode], "mode": mode, "shape": shape,
            "plan": tuple(got[1].shape), "effectual": int(got[0].sum()), "max_abs_err": 0.0,
            "ms": cuda_ms(call), "host_ms": host_ms(call),
            "plain_ms": cuda_ms(plain, iters=5), "plain_host_ms": host_ms(plain, iters=5),
            "before_ms": cuda_ms(before, iters=5), "before_host_ms": host_ms(before, iters=5),
            "before_launches": sum(c for _, c in device_launches(before, reps=1)),
            "library_ms": cuda_ms(library) if library else None,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "main_path": main, "stage": stage,
        }
        rows.append(row)
        lib = f"{row['library_ms']:.4f} ms" if library else "none"
        log(f"  planner {mode:<9} {label:<34} {shape:<40} plan {row['plan']} kernel {row['ms']:.4f} ms "
            f"(host {row['host_ms']:.4f})  chain {row['plain_ms']:.4f} ms (host {row['plain_host_ms']:.4f})  "
            f"unfused path {row['before_ms']:.4f} ms (host {row['before_host_ms']:.4f}, "
            f"{row['before_launches']} launches)  torch.count_nonzero {lib}  bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}), exact")

    def values_case(label, x, bm, bk, stage):
        r, c = x.shape[0] // bm, x.shape[1] // bk
        zero = int((ref.block_any_nonzero(x, bm, bk) == 0).sum())
        reads = zero * bm * bk + (r * c - zero)
        case(label, "values", lambda: T.plan_blocks_csr(x, bm, bk), lambda: ref.plan_blocks_csr_ref(x, bm, bk),
             before=lambda: chained(block_mask.block_zero_mask(x, bm=bm, bk=bk)),
             library=lambda: torch.count_nonzero(x.reshape(r, bm, c, bk), dim=(1, 3)),
             nbytes=reads * x.element_size() + plan_bytes(r, c), compares=reads,
             shape=f"[{x.shape[0]},{x.shape[1]}] {row_dtype(x.dtype)} {bm}x{bk}, {zero}/{r * c} zero",
             stage=stage)

    def emitted_case(label, mask, coarsen, stage, main=True):
        r, n = mask.shape
        case(label, "emitted", lambda: T.plan_from_mask_csr(mask, coarsen=coarsen),
             lambda: ref.plan_from_mask_csr_ref(mask, coarsen=coarsen),
             library=lambda: torch.count_nonzero(mask.reshape(r, n // coarsen, coarsen), dim=2),
             nbytes=r * n + plan_bytes(r, n // coarsen), compares=r * n,
             shape=f"[{r},{n}] {row_dtype(mask.dtype)} coarsen {coarsen}", stage=stage, main=main)

    def transpose_case(label, nnz, idx, stage):
        r, c = idx.shape[1], idx.shape[0]
        eff = int(nnz.sum())
        case(label, "transpose", lambda: T.transpose_plan_csr(nnz, idx),
             lambda: ref.transpose_plan_csr_ref(nnz, idx),
             nbytes=4 * (c + eff) + plan_bytes(r, c), compares=eff,
             shape=f"forward plan [{c},{r}], {eff} effectual", stage=stage)

    n_edge = planner_edge_cases()
    log(f"planner: {n_edge} edge cases bit-equal to the plain chain on the card")
    # emitted masks: the decode gate's (4 slots, bm 4, 86 blocks of 128) and the
    # training gate's at one microbatch (8 block rows); coarsened bool off the path
    dmask = (torch.rand(1, f // 128, generator=gen, device=dev) < 0.4).to(torch.int8)
    emitted_case("decode gate mask", dmask, 1, "decode")
    gmask = (torch.rand(t // 128, f // 128, generator=gen, device=dev) < 0.4).to(torch.int8)
    emitted_case("train gate mask", gmask, 1, "train")
    emitted_case("train gate mask, bool view, coarsen 2", (gmask != 0).T.contiguous().T, 2, "off path",
                 main=False)
    # by value: the LM-head weight (serve and train), the two fp32 cotangents
    lm_head = (torch.randn(d, v, generator=gen, device=dev) / 64).to(torch.bfloat16)
    values_case("LM head weight lm_head.T", lm_head.T, 128, 512, "decode")
    keep = (torch.rand(t // 128, d // 128, generator=gen, device=dev) < 0.4)[:, None, :, None]
    g = (torch.randn(t, d, generator=gen, device=dev).reshape(t // 128, 128, d // 128, 128)
         * keep).reshape(t, d)
    values_case("w_down cotangent", g, 128, 128, "train")
    dlogits = torch.randn(t, v, generator=gen, device=dev) * 1e-4
    values_case("LM head cotangent dlogits.T", dlogits.T, 128, 128, "train")
    # each MoE expert's h[e] at qwen3-moe widths, bm = its capacity: a routed
    # decode slot, a prefill capacity with 3 pad rows, a pad row alone
    for label, cap, pad in (("moe h[e] decode, routed", 1, 0), (f"moe h[e] prefill cap {MOE_PREFILL_CAP}",
                                                                MOE_PREFILL_CAP, 3),
                            ("moe h[e] decode, pad row", 1, 1)):
        he = torch.clamp_min(torch.randn(cap, 1536, generator=gen, device=dev), 0)
        he[cap - pad:] = 0
        values_case(label, he.to(torch.bfloat16), cap, 512, "moe prefill" if cap > 1 else "moe decode")
    # the SSM, hybrid, starcoder2, gemma2 and qwen2-vl LM heads at their
    # fitted blocks (120 x 512 for mamba2's vocab 50280, 128 x 384 for
    # gemma2's d_model 2304, 128 x 512 and 1188 block rows for qwen2-vl's
    # 152064 x 8192), the mamba2 head also with 40% of its blocks zero
    for arch in (SSM_ARCH, HYBRID_ARCH, STARCODER_ARCH, GEMMA_ARCH, VL_ARCH):
        c = get_config(arch)
        hv, hd = c.vocab_size, c.d_model
        bm, bk = _fit_block(128, hv), _fit_block(512, hd)
        w = torch.randn(hv, hd, generator=gen, device=dev) / hd**0.5
        as_view = lambda w: w.to(torch.bfloat16).T.contiguous().T  # lm_head.T of the [d, V] head
        values_case(f"{tag_of(c)} LM head weight lm_head.T", as_view(w), bm, bk, f"{tag_of(c)} decode")
        if c.family == "ssm":
            keep = torch.rand(hv // bm, hd // bk, generator=gen, device=dev) >= 0.4
            w = (w.reshape(hv // bm, bm, hd // bk, bk) * keep[:, None, :, None]).reshape(hv, hd)
            values_case("ssm LM head weight, 40% zero", as_view(w), bm, bk, "ssm decode")
        del w
    # gemma2-ReLU's decode gate mask (72 blocks of 128), coarsened to w_down's bk 512
    c = get_config(GEMMA_ARCH)
    emitted_case("gemma2 gate mask, coarsen 4", (torch.rand(1, c.d_ff // 128, generator=gen, device=dev) < 0.4)
                 .to(torch.int8), 4, "gemma2 decode")
    # qwen2-vl-ReLU's decode gate mask (231 blocks of 128) at the coarsening
    # the runtime fits for w_down (1: the fitted bk 462 is no multiple of 128)
    c = get_config(VL_ARCH)
    vmask = (torch.rand(1, c.d_ff // 128, generator=gen, device=dev) < 0.4).to(torch.int8)
    h, w = (torch.empty(shape, dtype=torch.bfloat16, device="meta") for shape in ((SLOTS, c.d_ff),
                                                                                   (c.d_ff, c.d_model)))
    coarsen = rtm.Runtime(backend="cuda", device="cuda").plan_for_fused_output(vmask, h, w).bk // 128
    emitted_case(f"qwen2-vl gate mask, coarsen {coarsen}", vmask, coarsen, "qwen2-vl decode")
    # a tensor-parallel rank's gate mask (d_ff / SM_TP columns at the lanes
    # the runtime fits them) at the coarsening its w_down rows take:
    # deepseek-v2's [1,24] at bk 512, qwen2-vl-ReLU's [1,66] at bk 112
    for arch in (DSV2_ARCH, VL_ARCH):
        c = get_config(arch)
        f_rank = c.d_ff // SM_TP
        lanes = rtm.Runtime(backend="cuda", device="cuda").lane(f_rank)
        rmask = (torch.rand(1, f_rank // lanes, generator=gen, device=dev) < 0.4).to(torch.int8)
        h, w = (torch.empty(shape, dtype=torch.bfloat16, device="meta") for shape in ((SLOTS, f_rank),
                                                                                       (f_rank, c.d_model)))
        coarsen = rtm.Runtime(backend="cuda", device="cuda").plan_for_fused_output(rmask, h, w).bk // lanes
        emitted_case(f"{tag_of(c)} TP rank gate mask, coarsen {coarsen}", rmask, coarsen, "sharded family decode")
    # the weight-gradient products' transposed forward plans
    transpose_case("gate db (dense gate plan)", *T.dense_plan(t // 128, d // 512, dev), "train")
    transpose_case("w_down db (gate mask plan)", *T.plan_from_mask(gmask), "train")
    transpose_case("LM head db (weight plan)", *T.plan_blocks(lm_head.T, 128, 512), "train")
    calls["block_zero_mask lm_head.T"] = lambda: block_mask.block_zero_mask(lm_head.T, bm=128, bk=512)
    del g, dlogits
    launch = count_launches(calls, kernel="td_plan_kernel")
    del lm_head
    torch.cuda.empty_cache()
    return rows, launch


def _rel_l2(got, want) -> float:
    import torch

    den = float(torch.linalg.vector_norm(want.float()))
    return float(torch.linalg.vector_norm(got.float() - want.float())) / max(den, 1e-30)


def train_path_launches(cfg, mb: int, first: bool = False) -> dict:
    """The wrapper launches of one ``make_train_step`` step on ``cuda`` over
    ``mb`` microbatches (``first``: the run's first step).  A dense model
    with a ReLU gate and a planned LM head (deepseek-7b-ReLU, qwen2-vl-ReLU;
    L layers, ``r`` = 2 forwards a layer under remat): per microbatch r x L
    fused gates; planned, r x L ``w_down`` forwards, the head's forward and
    the backward's two products of each gate, ``w_down`` and the head; plans,
    one planner launch each: by value the cotangents of each ``w_down`` and
    the head, from emitted masks each ``w_down``'s (r) and each gate
    cotangent's, transposed each ``w_down``'s forward plan (fresh masks);
    once a step the head's weight by value after its update and its
    transpose; on the first step the gate's (dense, then cached) transposed
    plan.  The audio frontend (musicgen: a non-gated GELU FFN, codebook
    heads as a plain einsum) puts nothing on the runtime."""
    from repro_torch.kernels import tensordash_spmm as T

    want = dict.fromkeys(T.launch_counts(), 0)
    if cfg.frontend == "audio" and not cfg.mlp_gated:
        return want
    if not (cfg.family == "dense" and cfg.mlp_gated and cfg.activation == "relu"):
        raise ValueError(f"{cfg.name}: no train-path launch count for family {cfg.family!r}, "
                         f"activation {cfg.activation!r}")
    L, r = cfg.num_layers, 2 if cfg.remat else 1
    want.update({"tensordash_matmul_fused": r * L * mb,
                 "tensordash_matmul_planned": (r * L + 1 + 4 * L + 2) * mb,
                 "planner[values]": (L + 1) * mb + 1,
                 "planner[emitted]": (r + 1) * L * mb,
                 "planner[transpose]": L * mb + 1 + int(first)})
    return want


def train_plan_cache(cfg, mb: int, first: bool = False) -> tuple[int, int]:
    """``(hits, misses)`` of the plan cache over the step
    :func:`train_path_launches` counts.  Hits: the head's weight plan and
    its transpose on each microbatch but the first, the gate's transposed
    plan on every gate but the run's first.  Misses: the head's weight plan
    (replanned after the update) and its transpose once, the gate's
    transposed plan on the first step, each microbatch's ``w_down``
    transposed plans (fresh masks) and cotangent plans (each ``w_down``'s
    and the head's)."""
    if cfg.frontend == "audio" and not cfg.mlp_gated:
        return 0, 0
    L = cfg.num_layers
    return (mb - 1) + (L * mb - int(first)) + (mb - 1), 1 + int(first) + L * mb + 1 + L * mb + mb


def train_phase():
    """Train full-width deepseek-7b-ReLU, cut to TRAIN_LAYERS layers, on the
    ``cuda`` backend through ``make_train_step``: step 1's loss and
    gradients against the ``dense`` backend on the card, TRAIN_STEPS timed
    steps with their launch and plan-cache counts held to what the path
    implies, two profiled steps, a poisoned step that must be skipped, and
    the same steps on the ``dense`` backend as a yardstick."""
    import dataclasses

    import torch
    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params
    from repro_torch.optim import OptConfig, global_norm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as S

    cfg = dataclasses.replace(get_config("deepseek-7b"), activation="relu", num_layers=TRAIN_LAYERS)
    L, mb = cfg.num_layers, TRAIN_MICRO
    t0 = time.perf_counter()
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device="cuda")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    opt_cfg = OptConfig(lr=1e-4, warmup_steps=1)
    rt = rtm.Runtime(backend="cuda", device="cuda")
    with rt.use():
        opt = S.init_train_state(cfg, params)
        step = S.make_train_step(cfg, opt_cfg, microbatches=mb, sparsity_taps=True)
    torch.cuda.synchronize()
    log(f"train: deepseek-7b relu cut to {L} layers (d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, remat {cfg.remat}), {cfg.param_count() / 1e9:.3f} B bf16 params and fp32 "
        f"AdamW moments on the card in {time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in {mb} microbatches")

    # step 1's loss and gradients: cuda against dense, on the card
    loss_fn, batch0 = S.make_loss_fn(cfg), data.batch_at(0)
    got = {}
    for backend in ("cuda", "dense"):
        with rtm.Runtime(backend=backend, device="cuda").use():
            loss, grads, _ = S.accumulate_grads(loss_fn, cfg, params, batch0, microbatches=mb)
        got[backend] = (float(loss), grads)
    (lc, gc), (ld, gd) = got["cuda"], got["dense"]
    loss_rel = abs(lc - ld) / abs(ld)
    names = [f"leaf{i}:{tuple(p.shape)}" for i, p in enumerate(tree_leaves(params))]
    rels = {n: _rel_l2(a, b) for n, a, b in zip(names, gc, gd)}
    worst = max(rels, key=rels.get)
    del got, gc, gd
    torch.cuda.empty_cache()
    log(f"train: step 1 on cuda vs dense: loss {lc:.6f} vs {ld:.6f} (relative {loss_rel:.3e}, bound "
        f"{LOSS_REL:.3e}); gradients worst relative L2 {rels[worst]:.3e} at {worst} (bound "
        f"{GRAD_REL_L2:.3e}), over {len(rels)} leaves")
    if not (loss_rel <= LOSS_REL and rels[worst] <= GRAD_REL_L2):
        raise AssertionError(f"train: cuda disagrees with dense (loss {loss_rel}, grads {rels[worst]})")

    # TRAIN_STEPS timed steps: every planned product through the kernels
    r = 2 if cfg.remat else 1  # remat runs each layer's forward again in the backward
    want = train_path_launches(cfg, mb)
    steps, prev = [], rt.plan_cache.stats()
    torch.cuda.reset_peak_memory_stats()
    with no_plain_versions("train"):
        with rt.use():
            for i in range(TRAIN_STEPS):
                T.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, data.batch_at(i))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches, pc = T.launch_counts(), rt.plan_cache.stats()
                hits, misses = pc["hits"] - prev["hits"], pc["misses"] - prev["misses"]
                prev = pc
                steps.append({
                    "step": i + 1, "ms": wall * 1e3, "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
                    "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
                    "A_density": m["A_density"].tolist(), "G_density": m["G_density"].tolist(),
                    "modeled_speedup": float(m["modeled_speedup"]), "launches": launches,
                    "plan_cache_hits": hits, "plan_cache_misses": misses,
                })
                st = steps[-1]
                log(f"train: step {i + 1}: {st['ms']:.1f} ms, {st['tok_per_s']:.1f} tok/s, loss "
                    f"{st['loss']:.6f}, grad_norm {st['grad_norm']:.6f}, plan cache +{hits} hits / "
                    f"+{misses} misses, launches {launches}")
                want_i = train_path_launches(cfg, mb, first=i == 0)
                want_hits, want_misses = train_plan_cache(cfg, mb, first=i == 0)
                if launches != want_i:
                    raise AssertionError(f"train step {i + 1}: launches {launches} != path's {want_i}")
                if (hits, misses) != (want_hits, want_misses):
                    raise AssertionError(f"train step {i + 1}: plan cache +{hits}/+{misses}, path "
                                         f"implies +{want_hits}/+{want_misses}")
                if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
                    raise AssertionError(f"train step {i + 1}: non-finite loss or gradient norm")
    peak = torch.cuda.max_memory_allocated() / 1e9
    sim = S.modeled_speedup(m, cfg, max_t=32, sample_groups=1)
    # the last update changed the LM head in place: its cached plan is stale
    # now and must not be found (the next step replans it)
    lm_head = params["lm_head"]
    if rt.plan_cache.lookup(("lm_head", id(lm_head)), lm_head, 128, 512, side="B") is not None:
        raise AssertionError("train: the LM-head plan of the updated weight was hit stale")
    log(f"train: {TRAIN_STEPS} steps; launches per step {want} == path's (gates {r} x {L} x {mb}, "
        f"planned ({r} x {L} + 1 + 4 x {L} + 2) x {mb}, planner values ({L} + 1) x {mb} + 1, "
        f"emitted ({r} + 1) x {L} x {mb}, transpose {L} x {mb} + 1, +1 on step 1); "
        f"no plain executor ran; the updated LM head's stale plan is not found; peak memory "
        f"{peak:.2f} GB; step 1 loss {steps[0]['loss']:.6f} (its checked gradient pass: {lc:.6f})")
    log(f"train: last step A_density {steps[-1]['A_density']}, G_density {steps[-1]['G_density']}, "
        f"modeled_speedup {steps[-1]['modeled_speedup']:.4f} (ideal), perf model {sim}")

    # two profiled steps: where the device time goes, by kernel
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with rt.use(), torch.profiler.profile(activities=acts) as prof:
        for i in range(2):
            params, opt, _ = step(params, opt, data.batch_at(TRAIN_STEPS + i))
        torch.cuda.synchronize()
    from repro_torch.launch.profile_decode import _device_us

    dev_events = [(e.key, e.count, _device_us(e) / 1e3) for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA and e.count]
    busy = sum(ms for _, _, ms in dev_events) / 2
    top = sorted(dev_events, key=lambda e: -e[2])[:12]
    log(f"train profile: device busy {busy:.3f} ms per step, "
        f"{sum(c for _, c, _ in dev_events) / 2:.0f} device launches per step")
    for key, count, ms in top:
        log(f"train profile:   {ms / 2:9.3f} ms/step  {count / 2:6.0f} calls/step  {key[:110]}")

    # a poisoned step under guard_nonfinite leaves params and optimizer state unchanged
    with rt.use():
        gstep = S.make_train_step(cfg, opt_cfg, microbatches=mb, guard_nonfinite=True)
        before = [p.detach().clone() for p in tree_leaves(params)]
        norms = (float(global_norm(opt.m)), float(global_norm(opt.v)))
        params, opt2, gm = gstep(params, opt, data.batch_at(0), poison=2)
    same = all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    if not (gm["nonfinite"] == 1 and same and opt2.step == opt.step
            and norms == (float(global_norm(opt2.m)), float(global_norm(opt2.v)))):
        raise AssertionError("train: a poisoned guard_nonfinite step changed params or optimizer state")
    log("train: guard_nonfinite step with poison=2 skipped: params and optimizer state unchanged")
    del before, params, opt, opt2, m, gm, rt, step, gstep, prof
    torch.cuda.empty_cache()

    # the same steps from the same seed on the dense backend (cuBLAS bf16
    # products, plain autograd): the step's library yardstick and the loss
    # trajectory beside the cuda run's; reported, not gated
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device="cuda")
    with rtm.Runtime(backend="dense", device="cuda").use():
        opt = S.init_train_state(cfg, params)
        step = S.make_train_step(cfg, opt_cfg, microbatches=mb, sparsity_taps=True)
        dense = []
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, dm = step(params, opt, data.batch_at(i))
            torch.cuda.synchronize()
            dense.append({"step": i + 1, "ms": (time.perf_counter() - t0) * 1e3, "loss": float(dm["loss"]),
                          "grad_norm": float(dm["grad_norm"])})
    log("train dense: " + "; ".join(f"step {d['step']}: {d['ms']:.1f} ms, loss {d['loss']:.6f}, grad_norm "
                                    f"{d['grad_norm']:.6f}" for d in dense))
    del params, opt, step
    torch.cuda.empty_cache()
    return {
        "layers": L, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": mb, "remat": cfg.remat,
        "params_b": cfg.param_count() / 1e9, "steps": steps, "peak_mem_gb": peak,
        "launches_per_step": steps[-1]["launches"], "loss_rel_vs_dense": loss_rel, "grad_rel_l2_vs_dense": rels,
        "perf_model": sim, "profile": {"busy_ms_per_step": busy,
                                       "top": [(k, c / 2, ms / 2) for k, c, ms in top]},
        "dense_steps": dense,
    }


def spec_numel(specs) -> int:
    """Parameters a spec tree declares."""
    import math

    from repro_torch.models.common import Spec

    if isinstance(specs, Spec):
        return math.prod(specs.shape)
    return sum(spec_numel(v) for v in (specs.values() if isinstance(specs, dict) else specs))


def train_cut(cfg):
    """The deepest cut of ``cfg`` that trains within TRAIN_BUDGET_GB at
    TRAIN_BYTES_PER_PARAM, reckoned from its tensors before the run: whole
    groups of ``attn_every`` layers for a hybrid config, and ``cfg`` itself
    where the whole model fits."""
    import dataclasses

    from repro_torch.models import model as M

    step = cfg.attn_every if cfg.family == "hybrid" else 1
    for layers in range(cfg.num_layers, 0, -step):
        cut = dataclasses.replace(cfg, num_layers=layers)
        n = spec_numel(M.param_specs(cut))
        if n * TRAIN_BYTES_PER_PARAM <= TRAIN_BUDGET_GB * 1e9:
            return cut, n
    raise AssertionError(f"{cfg.name}: not even {step} layers train within {TRAIN_BUDGET_GB} GB")


def ssm_train_phase(arch: str, tag: str):
    """Train ``arch`` (an SSM or hybrid config) through ``make_train_step``
    on the ``cuda`` backend, at the deepest cut :func:`train_cut` reckons to
    fit, on TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_MICRO microbatches (256
    tokens: two SSD chunks of 128, so ``ssd_chunked`` runs its chunked path
    at full width): taps refused as in JAX; step 1's loss and gradient
    norm against the ``dense`` backend on the card (the worst leaf's relative
    L2 reported); TRAIN_STEPS timed steps whose launches and plan-cache
    counts equal the path's (the LM head is the one planned product: its
    forward and two backward products a microbatch, its cotangent planned by
    value a microbatch, its weight planned by value once a step after the
    update and that plan transposed once), every loss finite, no plain
    version run; then one chunked prefill of a TRAIN_SEQ-token prompt, its
    logits ``cuda`` against ``reference``."""
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params
    from repro_torch.optim import OptConfig, global_norm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as S

    full = get_config(arch)
    cfg, n = train_cut(full)
    mb = TRAIN_MICRO
    if TRAIN_SEQ % cfg.ssm_chunk or TRAIN_SEQ // cfg.ssm_chunk < 2:
        raise AssertionError(f"{tag}: {TRAIN_SEQ} tokens do not run ssd_chunked's chunked path")
    free()
    t0 = time.perf_counter()
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device="cuda")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=0)
    opt_cfg = OptConfig(lr=1e-4, warmup_steps=1)
    rt = rtm.Runtime(backend="cuda", device="cuda")
    with rt.use():
        opt = S.init_train_state(cfg, params)
        step = S.make_train_step(cfg, opt_cfg, microbatches=mb)
        try:
            S.make_train_step(cfg, opt_cfg, microbatches=mb, sparsity_taps=True)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{tag}: sparsity taps must be refused for family {cfg.family!r}")
    torch.cuda.synchronize()
    unit = "groups" if cfg.family == "hybrid" else "layers"
    per = cfg.attn_every if cfg.family == "hybrid" else 1
    log(f"{tag}: {arch} at {cfg.num_layers // per} of {full.num_layers // per} {unit} ({cfg.num_layers} layers; "
        f"{n / 1e9:.3f} B parameters in the tensors x {TRAIN_BYTES_PER_PARAM} B = "
        f"{n * TRAIN_BYTES_PER_PARAM / 1e9:.1f} GB reckoned against {TRAIN_BUDGET_GB} GB), remat {cfg.remat}, "
        f"bf16 params and fp32 AdamW moments on the card in {time.perf_counter() - t0:.1f} s; batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {mb} microbatches ({TRAIN_SEQ // cfg.ssm_chunk} SSD chunks of "
        f"{cfg.ssm_chunk}); taps refused")

    loss_fn, batch0 = S.make_loss_fn(cfg), data.batch_at(0)
    got = {}
    for backend in ("cuda", "dense"):
        with rtm.Runtime(backend=backend, device="cuda").use():
            loss, grads, _ = S.accumulate_grads(loss_fn, cfg, params, batch0, microbatches=mb)
        got[backend] = (float(loss), grads, float(global_norm(grads)))
    (lc, gc_, nc), (ld, gd, nd) = got["cuda"], got["dense"]
    loss_rel, norm_rel = abs(lc - ld) / abs(ld), abs(nc - nd) / abs(nd)
    names = [f"leaf{i}:{tuple(p.shape)}" for i, p in enumerate(tree_leaves(params))]
    rels = {k: _rel_l2(a, b) for k, a, b in zip(names, gc_, gd)}
    worst = max(rels, key=rels.get)
    del got, gc_, gd
    free()
    log(f"{tag}: step 1 on cuda vs dense: loss {lc:.6f} vs {ld:.6f} (relative {loss_rel:.3e}, bound "
        f"{LOSS_REL:.3e}); gradient norm {nc:.6f} vs {nd:.6f} (relative {norm_rel:.3e}, bound "
        f"{GRAD_REL_L2:.3e}); worst leaf relative L2 {rels[worst]:.3e} at {worst}, over {len(rels)} leaves")
    if not (loss_rel <= LOSS_REL and norm_rel <= GRAD_REL_L2):
        raise AssertionError(f"{tag}: cuda disagrees with dense (loss {loss_rel}, grad norm {norm_rel})")

    want = dict.fromkeys(T.launch_counts(), 0)
    want.update({"tensordash_matmul_planned": 3 * mb, "planner[values]": mb + 1, "planner[transpose]": 1})
    steps, prev = [], rt.plan_cache.stats()
    torch.cuda.reset_peak_memory_stats()
    with no_plain_versions(tag), rt.use():
        for i in range(TRAIN_STEPS):
            T.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, data.batch_at(i))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, pc = T.launch_counts(), rt.plan_cache.stats()
            hits, misses = pc["hits"] - prev["hits"], pc["misses"] - prev["misses"]
            prev = pc
            steps.append({"step": i + 1, "ms": wall * 1e3, "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
                          "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "launches": launches,
                          "plan_cache_hits": hits, "plan_cache_misses": misses})
            log(f"{tag}: step {i + 1}: {wall * 1e3:.1f} ms, {TRAIN_BATCH * TRAIN_SEQ / wall:.1f} tok/s, loss "
                f"{float(m['loss']):.6f}, grad_norm {float(m['grad_norm']):.6f}, plan cache +{hits} hits / "
                f"+{misses} misses, launches {by_wrapper(launches)}")
            if launches != want:
                raise AssertionError(f"{tag} step {i + 1}: launches {launches} != path's {want}")
            # the head's weight plan (replanned after the update) and its
            # transpose miss on the first microbatch and hit on the others;
            # each microbatch's cotangent plan misses
            if (hits, misses) != (2 * (mb - 1), 2 + mb):
                raise AssertionError(f"{tag} step {i + 1}: plan cache +{hits}/+{misses}, path implies "
                                     f"+{2 * (mb - 1)}/+{2 + mb}")
            if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
                raise AssertionError(f"{tag} step {i + 1}: non-finite loss or gradient norm")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del opt, step, m
    free()
    log(f"{tag}: {TRAIN_STEPS} steps, launches per step {by_wrapper(want)} == path's (LM head planned "
        f"3 x {mb}, its cotangent by value {mb} + its weight 1, one transpose); no plain version ran; peak "
        f"memory {peak:.2f} GB ({peak / (n * 1e-9):.1f} B a parameter)")

    # one chunked prefill over TRAIN_SEQ tokens, cuda against reference
    prompt = data.batch_at(TRAIN_STEPS)["tokens"][:1]
    logits, ms = {}, {}
    with torch.inference_mode():
        for backend in ("cuda", "reference"):
            with rtm.Runtime(backend=backend, device="cuda").use():
                run = lambda: M.prefill(params, cfg, {"tokens": prompt})[0][0, -1].float()
                logits[backend] = run()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                ms[backend] = (time.perf_counter() - t0) * 1e3
    ref_l2 = _rel_l2(logits["cuda"], logits["reference"])
    finite = bool(torch.isfinite(logits["cuda"]).all())
    log(f"{tag}: chunked prefill of a {TRAIN_SEQ}-token prompt ({TRAIN_SEQ // cfg.ssm_chunk} chunks): "
        f"{ms['cuda']:.1f} ms on cuda, {ms['reference']:.1f} ms on reference; last-token logits relative L2 "
        f"{ref_l2:.3e} (bound {REF_REL_L2:.3e}), top-1 "
        f"{'equal' if int(logits['cuda'].argmax()) == int(logits['reference'].argmax()) else 'differs'}")
    if not finite or ref_l2 > REF_REL_L2:
        raise AssertionError(f"{tag}: prefill cuda vs reference relative L2 {ref_l2}, finite {finite}")
    del params
    free()
    return {"layers": cfg.num_layers, "of_layers": full.num_layers, "params_b": n / 1e9,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "microbatches": mb, "remat": cfg.remat, "steps": steps,
            "peak_mem_gb": peak, "launches_per_step": want, "loss_rel_vs_dense": loss_rel,
            "grad_norm_rel_vs_dense": norm_rel, "grad_rel_l2_vs_dense": rels, "prefill_ms": ms,
            "prefill_rel_l2": ref_l2}


def frontend_train_batch(cfg, step: int, device="cuda", dtype=None) -> dict:
    """Training batch ``step`` of a frontend config: TRAIN_BATCH x TRAIN_SEQ
    embeddings (bf16; from a torch generator seeded with ``step`` on the
    card, unseeded on ``meta``, where nothing is allocated), under M-RoPE
    Qwen2-VL's rope index of the frontend prompt (:func:`vl_positions`: VL_TEXT
    text, the 1 x VL_GRID image, VL_TEXT text, TRAIN_SEQ positions), and
    labels from numpy seed ``step``: ``[B, S]``, ``[B, S, K]`` under the
    audio frontend."""
    import numpy as np
    import torch

    dtype = dtype or torch.bfloat16
    device = torch.device(device)
    gen = None if device.type == "meta" else torch.Generator(device).manual_seed(step)
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)
    batch = {"inputs_embeds": torch.randn(shape, generator=gen, device=device).to(dtype)}
    if cfg.mrope_sections is not None:
        pos = vl_positions(TRAIN_BATCH)
        if pos.shape[-1] != TRAIN_SEQ:
            raise AssertionError(f"the frontend prompt has {pos.shape[-1]} positions, a train row {TRAIN_SEQ}")
        batch["positions"] = torch.from_numpy(pos).to(device)
    labels = (TRAIN_BATCH, TRAIN_SEQ) + ((cfg.num_codebooks,) if cfg.frontend == "audio" else ())
    batch["labels"] = torch.from_numpy(
        np.random.default_rng(step).integers(0, cfg.vocab_size, size=labels).astype(np.int32)).to(device)
    return batch


def frontend_train_phase(cfg, tag: str) -> dict:
    """Train ``cfg`` (a frontend config) through ``make_train_step`` on the
    ``cuda`` backend at the deepest cut :func:`train_cut` reckons to fit, on
    :func:`frontend_train_batch`'s TRAIN_BATCH x TRAIN_SEQ embeddings in
    TRAIN_MICRO microbatches (each microbatch its rows of ``positions``): step
    1's loss and every gradient against the ``dense`` backend on the card
    (LOSS_REL, GRAD_REL_L2; the worst leaf reported); TRAIN_STEPS timed steps
    whose launches and plan-cache counts equal the path's
    (:func:`train_path_launches`, :func:`train_plan_cache`: qwen2-vl-ReLU's
    fused gate, emitted plan, planned ``w_down`` and head, their backward
    products and plans; musicgen none), every loss finite, no plain version
    run; ms a step, tokens/s and peak memory."""
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as S

    full = cfg
    cfg, n = train_cut(full)
    mb = TRAIN_MICRO
    free()
    t0 = time.perf_counter()
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device="cuda")
    opt_cfg = OptConfig(lr=1e-4, warmup_steps=1)
    rt = rtm.Runtime(backend="cuda", device="cuda")
    with rt.use():
        opt = S.init_train_state(cfg, params)
        step = S.make_train_step(cfg, opt_cfg, microbatches=mb)
    batches = [frontend_train_batch(cfg, i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    heads = f" x {cfg.num_codebooks} codebooks" if cfg.frontend == "audio" else ""
    log(f"{tag}: {full.name}, activation {cfg.activation}, at {cfg.num_layers} of {full.num_layers} layers "
        f"(d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}{heads}; "
        f"{n / 1e9:.3f} B parameters in the tensors x {TRAIN_BYTES_PER_PARAM} B = "
        f"{n * TRAIN_BYTES_PER_PARAM / 1e9:.1f} GB reckoned against {TRAIN_BUDGET_GB} GB), remat {cfg.remat}, "
        f"bf16 params and fp32 AdamW moments on the card in {time.perf_counter() - t0:.1f} s; batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} {'M-RoPE image-prompt' if cfg.mrope_sections else 'frame'} embeddings in "
        f"{mb} microbatches")

    loss_fn = S.make_loss_fn(cfg)
    got = {}
    for backend in ("cuda", "dense"):
        with rtm.Runtime(backend=backend, device="cuda").use():
            loss, grads, _ = S.accumulate_grads(loss_fn, cfg, params, batches[0], microbatches=mb)
        got[backend] = (float(loss), grads)
    (lc, gc_), (ld, gd) = got["cuda"], got["dense"]
    loss_rel = abs(lc - ld) / abs(ld)
    names = [f"leaf{i}:{tuple(p.shape)}" for i, p in enumerate(tree_leaves(params))]
    rels = {k: _rel_l2(a, b) for k, a, b in zip(names, gc_, gd)}
    worst = max(rels, key=rels.get)
    del got, gc_, gd, grads
    free()
    log(f"{tag}: step 1 on cuda vs dense: loss {lc:.6f} vs {ld:.6f} (relative {loss_rel:.3e}, bound "
        f"{LOSS_REL:.3e}); gradients worst relative L2 {rels[worst]:.3e} at {worst} (bound {GRAD_REL_L2:.3e}), "
        f"over {len(rels)} leaves")
    if not (loss_rel <= LOSS_REL and rels[worst] <= GRAD_REL_L2):
        raise AssertionError(f"{tag}: cuda disagrees with dense (loss {loss_rel}, grads {rels[worst]})")

    steps, prev = [], rt.plan_cache.stats()
    torch.cuda.reset_peak_memory_stats()
    with no_plain_versions(tag), rt.use():
        for i, batch in enumerate(batches):
            T.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, pc = T.launch_counts(), rt.plan_cache.stats()
            hits, misses = pc["hits"] - prev["hits"], pc["misses"] - prev["misses"]
            prev = pc
            steps.append({"step": i + 1, "ms": wall * 1e3, "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
                          "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "launches": launches,
                          "plan_cache_hits": hits, "plan_cache_misses": misses})
            log(f"{tag}: step {i + 1}: {wall * 1e3:.1f} ms, {TRAIN_BATCH * TRAIN_SEQ / wall:.1f} tok/s, loss "
                f"{float(m['loss']):.6f}, grad_norm {float(m['grad_norm']):.6f}, plan cache +{hits} hits / "
                f"+{misses} misses, launches {by_wrapper(launches)}")
            want = train_path_launches(cfg, mb, first=i == 0)
            if launches != want:
                raise AssertionError(f"{tag} step {i + 1}: launches {launches} != path's {want}")
            if (hits, misses) != train_plan_cache(cfg, mb, first=i == 0):
                raise AssertionError(f"{tag} step {i + 1}: plan cache +{hits}/+{misses}, path implies "
                                     f"{train_plan_cache(cfg, mb, first=i == 0)}")
            if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
                raise AssertionError(f"{tag} step {i + 1}: non-finite loss or gradient norm")
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = by_wrapper(train_path_launches(cfg, mb))
    log(f"{tag}: {TRAIN_STEPS} steps, launches per step {per_step or 'none'} == path's (+1 transpose on step 1 "
        f"where planned); no plain version ran; every loss finite; peak memory {peak:.2f} GB "
        f"({peak / (n * 1e-9):.1f} B a parameter)")
    del params, opt, step, m, batches
    free()
    return {"layers": cfg.num_layers, "of_layers": full.num_layers, "params_b": n / 1e9, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "microbatches": mb, "remat": cfg.remat, "steps": steps, "peak_mem_gb": peak,
            "launches_per_step": steps[-1]["launches"], "loss_rel_vs_dense": loss_rel,
            "grad_rel_l2_vs_dense": rels, "worst_leaf": worst}


# ---------------------------------------------------------------------------
# the examples: the port's entry points for users
# ---------------------------------------------------------------------------

#: planned products, plans, cycle-model tiles, codec schedules
_SPMM, _PLAN, _TILE, _SCHED = "tensordash_matmul_planned", "planner[values]", "td_tile_kernel", "td_schedule_kernel"
_SAMPLE = "td_sample_kernel"


def example_runs(ckpt_dir: str) -> list:
    """``(tag, example, argv, kernels its path must launch)``: each of the
    port's examples at its documented command on the card, ``train_lm``
    twice into ``ckpt_dir`` (the second run resumes at the last step)."""
    lm = ["--preset", "100m", "--steps", "300", "--relu-ffn", "--ckpt-dir", ckpt_dir]
    serve = ["--arch", "qwen3-4b", "--backend", "cuda"]
    return [("quickstart", "quickstart", [], (_TILE, _SCHED, _SPMM, _PLAN)),
            ("serve_batched greedy", "serve_batched", [*serve, "--temperature", "0"], (_SPMM, _PLAN)),
            ("serve_batched sampled", "serve_batched", serve, (_SPMM, _PLAN, _SAMPLE)),
            ("train_lm", "train_lm", lm, ("tensordash_matmul_fused", _SPMM, _PLAN, "planner[emitted]",
                                          "planner[transpose]", _TILE)),
            ("train_lm resume", "train_lm", lm, (_TILE,)),
            ("train_pruned", "train_pruned", [], (_SPMM, _PLAN, _TILE, _SCHED)),
            ("train_cnn_sparsity", "train_cnn_sparsity", [], (_TILE,))]


def example_losses(name: str, res: dict) -> list:
    """The training losses an example's ``main`` returned."""
    if name == "train_lm":
        return [h["loss"] for h in res["history"]]
    if name == "train_pruned":
        return [r["loss"] for r in res["rows"]]
    if name == "train_cnn_sparsity":
        return [e["loss"] for e in res["epochs"]]
    return []


def examples_phase() -> dict:
    """Each of the port's examples (``repro_torch.examples``) through its
    ``main`` in this process on the card, at its documented command
    (:func:`example_runs`), its wrapper launches counted from 0: each run
    returns, launches every kernel its path reaches (the SpMM and planner
    kernels for the serve runs and the train steps, the tile kernel for the
    cycle-model projections, the schedule kernel for the codec, the sampler
    for the sampled serve) and runs no plain version; every training loss
    is finite; each serve run, greedy and sampled, captures its decode
    chunk once, every request emits its budget; the second
    ``train_lm`` run resumes at step 300.  Prints each run's table and wall
    seconds."""
    import math

    import torch
    from repro_torch.examples import quickstart, serve_batched, train_cnn_sparsity, train_lm, train_pruned
    from repro_torch.kernels import sample as SMP, schedule as S, tensordash_spmm as T

    mods = {m.__name__.rsplit(".", 1)[-1]: m
            for m in (quickstart, serve_batched, train_lm, train_pruned, train_cnn_sparsity)}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, name, argv, needs in example_runs(str(Path(tmp) / "train_lm")):
            free()
            T.reset_launch_counts()
            S.reset_launch_counts()
            SMP.reset_launch_counts()
            log(f"examples: {tag}: python -m repro_torch.examples.{name} {' '.join(argv)}")
            with no_plain_versions(f"examples {tag}"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = mods[name].main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = {k: v for k, v in {**T.launch_counts(), **S.LAUNCHES, **SMP.LAUNCHES}.items() if v}
            idle = [k for k in needs if not launches.get(k)]
            if idle:
                raise AssertionError(f"examples {tag}: its path never launched {idle} (launches {launches})")
            losses = example_losses(name, res)
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"examples {tag}: non-finite losses {losses}")
            if name == "serve_batched":
                st = res["stats"]
                if {rid: len(t) for rid, t in res["tokens"].items()} != res["budgets"]:
                    raise AssertionError(f"examples {tag}: a request did not emit its budget")
                if st["decode_graph_captures"] != 1:
                    raise AssertionError(f"examples {tag}: {st['decode_graph_captures']} decode graph captures")
            if tag == "train_lm resume" and (res["resumed_from"] != 300 or res["history"]):
                raise AssertionError(f"examples {tag}: resumed from {res['resumed_from']}, "
                                     f"{len(res['history'])} steps run")
            out[tag] = {"seconds": wall, "launches": launches, "losses": losses[-3:]}
            log(f"examples: {tag}: {wall:.1f} s; kernel launches {launches}; no plain version ran"
                + (f"; {len(losses)} finite losses, last {losses[-1]:.4f}" if losses else ""))
    free()
    return out


# ---------------------------------------------------------------------------
# the train launcher: checkpoint, resume, dynamic sparse training
# ---------------------------------------------------------------------------

#: the launcher phase: qwen3-4b at full width cut from 36 to LAUNCH_LAYERS
#: layers (4.41 B parameters of bf16 weights and fp32 AdamW moments would need
#: ~120 GB; 8 layers make 1.585 B), the train cell's batch, LAUNCH_STEPS steps
LAUNCH_LAYERS, LAUNCH_STEPS, LAUNCH_SAVE_AT = 8, 6, 4
LAUNCH_ARGS = ["--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--microbatches", str(TRAIN_MICRO),
               "--steps", str(LAUNCH_STEPS), "--sparsity-taps", "--backend", "cuda", "--device", "cuda"]
#: run (c): RigL to 50% by the last step, a refresh every 2 steps, a NaN loss at step 1
LAUNCH_DST = ["--dynamic-sparsity", f"target=0.5,update_every=2,end={LAUNCH_STEPS}",
              "--inject-faults", "nan_loss@1", "--fault-backoff", "0.01"]


def tree_checksums(tree) -> dict:
    """Per leaf of a checkpoint tree: the sum of its bit patterns and their
    position-weighted sum (int64, on the leaf's device), to hold a restored
    tree bit for bit against the saved one without a host copy."""
    import torch
    from repro_torch.checkpoint.manager import _flatten

    views = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for name, leaf in _flatten(tree).items():
        if not isinstance(leaf, torch.Tensor):
            out[name] = leaf
            continue
        x = leaf.detach().contiguous().view(-1).view(views[leaf.element_size()])
        total = weighted = 0
        for at in range(0, x.numel(), 1 << 26):
            chunk = x[at:at + (1 << 26)].to(torch.int64)
            pos = torch.arange(at, at + chunk.numel(), device=x.device, dtype=torch.int64) % 65521 + 1
            total += int(chunk.sum())
            weighted += int((chunk * pos).sum())
        out[name] = (total, weighted)
    return out


#: the LM head's planned products, by the dimension the vocabulary takes:
#: the forward (side B, ``lm_head.T @ h.T``), the weight gradient ``dW``
#: (``g' @ h``, over the cotangent plan) and the activation gradient ``dx``
#: (``lm_head @ g'``, over the transposed weight plan, the vocabulary on K)
LM_HEAD_PRODUCTS = ("fwd", "dW", "dx")


def _spmm_split(calls: list, cfg) -> dict:
    """Device ms of one step's ``td_spmm_kernel`` launches, from the CUDA
    events around each: the LM head's three products (summed over
    microbatches, with the skipped share of the plan each ran) and the
    rest together."""
    import torch

    out = {"other_ms": 0.0}
    for start, end, m, k, n, nnz, bk in calls:
        ms = start.elapsed_time(end)
        if cfg.vocab_size not in (m, k, n):
            out["other_ms"] += ms
            continue
        kind = "dx" if k == cfg.vocab_size else "dW" if cfg.d_model in (m, n) else "fwd"
        nnz = torch.as_tensor(nnz)
        row = out.setdefault(kind, {"ms": 0.0, "calls": 0, "skipped": []})
        row["ms"] += ms
        row["calls"] += 1
        row["skipped"].append(1.0 - int(nnz.sum()) / (nnz.numel() * (k // bk)))
    return out


def _launcher_run(tag: str, argv: list, hooks: dict) -> dict:
    """One in-process ``repro_torch.launch.train.main(argv)`` under the
    plain-version guard: its stdout, seconds, per-step launches, ms, losses
    and SpMM device ms (:func:`_spmm_split`), and peak memory.
    ``SystemExit`` (a checkpoint-abort) fails."""
    import contextlib
    import gc
    import io

    import torch
    from repro_torch import configs
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.launch import train as LT

    cfg = configs.get_config(argv[argv.index("--arch") + 1])
    steps, calls, orig = [], [], {"make_train_step": LT.make_train_step}
    orig_launch = T._launch

    def timed_launch(wrapper, nnz, idx, a, b, bm, bk, *rest, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_launch(wrapper, nnz, idx, a, b, bm, bk, *rest, **kw)
        end.record()
        calls.append((start, end, a.shape[0], a.shape[1], b.shape[1], nnz, bk))
        return out

    def timed_step_factory(*args, **kw):
        fn = orig["make_train_step"](*args, **kw)

        def step(*a, **k):
            before = T.launch_counts()
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = T.launch_counts()
            m = out[2]
            steps.append({"ms": wall * 1e3, "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
                          "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "nonfinite": int(m.get("nonfinite", 0)),
                          "launches": {c: after[c] - before[c] for c in after},
                          "spmm": _spmm_split(calls, cfg)})
            calls.clear()
            return out
        return step

    T._launch = timed_launch
    patched = {"make_train_step": timed_step_factory, **hooks}
    for name, fn in patched.items():
        orig.setdefault(name, getattr(LT, name))
        setattr(LT, name, fn)
    buf = io.StringIO()
    T.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with no_plain_versions(f"launch train ({tag})"), contextlib.redirect_stdout(buf):
            LT.main(argv)
    except SystemExit as e:
        raise AssertionError(f"launch train ({tag}) exited with {e.code}:\n{buf.getvalue()}") from e
    finally:
        T._launch = orig_launch
        for name in patched:
            setattr(LT, name, orig[name])
    seconds = time.perf_counter() - t0
    launches = T.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    out = buf.getvalue()
    for line in out.splitlines():
        if not line.startswith("plan key=('dst'"):
            log(f"launch ({tag}): {line}")
    return {"stdout": out, "seconds": seconds, "steps": steps, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _step_line(out: str, step: int) -> str:
    """The launcher's ``step N loss ...`` line without its seconds field."""
    import re

    line = next(x for x in out.splitlines() if x.startswith(f"step {step:5d} loss"))
    return re.sub(r" \d+\.\d+s ", " ", line + " ").strip()


def launch_train_phase():
    """Drive ``repro_torch.launch.train.main`` in process on full-width
    qwen3-4b cut to LAUNCH_LAYERS layers: (a) train LAUNCH_STEPS steps with a
    checkpoint at LAUNCH_SAVE_AT; (b) resume from it, the restored tree bit
    for bit the saved one and step LAUNCH_SAVE_AT + 1's line run (a)'s; (c)
    the ReLU variant under dynamic sparse training with a NaN step, its
    plans with skipped blocks through the kernels, each edited plan bit-equal
    to the planner's fresh plan of the controller's mask, and the LM-head
    plan the kernel built from the masked weight bit-equal to the
    controller's forward plan."""
    import dataclasses
    import shutil

    import torch
    from repro_torch import configs
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.launch import train as LT
    from repro_torch.sparse_train import controller as SC

    base = configs.get_config("qwen3-4b")
    silu = configs.register(dataclasses.replace(base, name=f"qwen3-4b-L{LAUNCH_LAYERS}", num_layers=LAUNCH_LAYERS))
    relu = configs.register(dataclasses.replace(base, name=f"qwen3-4b-relu-L{LAUNCH_LAYERS}",
                                                num_layers=LAUNCH_LAYERS, activation="relu"))
    ckpt = ROOT / "chiprun_out" / "ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    log(f"launch: qwen3-4b (d_model {base.d_model}, {base.num_heads} heads of {base.head_dim} over "
        f"{base.num_kv_heads} KV heads, qk-norm, d_ff {base.d_ff}, vocab {base.vocab_size}) cut from "
        f"{base.num_layers} to {LAUNCH_LAYERS} layers: {silu.param_count() / 1e9:.3f} B params")
    saved, restored = {}, {}

    def save_hook(directory, step, tree, **kw):
        free = shutil.disk_usage(directory).free
        sums = tree_checksums(tree)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = LT_save(directory, step, tree, **kw)
        secs = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        saved.update(step=step, seconds=secs, bytes=size, free_before=free, sums=sums)
        log(f"saved step {step}: {size} bytes in {secs:.2f} s "
            f"({size / secs / 1e9:.2f} GB/s); free disk before the save {free / 1e9:.1f} GB")
        return path

    def restore_hook(directory, like, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, tree = LT_restore(directory, like, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        restored.update(step=step, seconds=secs, sums=tree_checksums(tree) if tree is not None else None)
        if step is not None:
            log(f"restored step {step} in {secs:.2f} s")
        return step, tree

    LT_save, LT_restore = LT.save, LT.restore_latest
    common = LAUNCH_ARGS + ["--ckpt-dir", str(ckpt)]
    try:
        a = _launcher_run("a", ["--arch", silu.name, "--ckpt-every", str(LAUNCH_SAVE_AT)] + common,
                          {"save": save_hook})
        if saved.get("step") != LAUNCH_SAVE_AT:
            raise AssertionError(f"launch (a): no checkpoint at step {LAUNCH_SAVE_AT} ({saved})")
        b = _launcher_run("b", ["--arch", silu.name, "--ckpt-every", "100"] + common,
                          {"restore_latest": restore_hook})
    finally:
        shutil.rmtree(ckpt)
    if f"resumed at step {LAUNCH_SAVE_AT}" not in b["stdout"] or restored.get("step") != LAUNCH_SAVE_AT:
        raise AssertionError(f"launch (b) did not resume at step {LAUNCH_SAVE_AT}")
    diff = [k for k in saved["sums"] if saved["sums"][k] != restored["sums"].get(k)]
    if diff or set(saved["sums"]) != set(restored["sums"]):
        raise AssertionError(f"launch (b): restored tree differs from the saved one at {diff[:5]}")
    line_a, line_b = _step_line(a["stdout"], LAUNCH_SAVE_AT + 1), _step_line(b["stdout"], LAUNCH_SAVE_AT + 1)
    loss_a, loss_b = a["steps"][LAUNCH_SAVE_AT]["loss"], b["steps"][0]["loss"]
    if line_a != line_b or loss_a != loss_b:
        raise AssertionError(f"launch (b): step {LAUNCH_SAVE_AT + 1} differs from run (a):\n{line_a}\n{line_b}")
    log(f"launch (b): restored tree bit-equal to the saved one ({len(saved['sums'])} leaves checksummed); "
        f"step {LAUNCH_SAVE_AT + 1} loss {loss_b!r} and line equal to run (a)'s")

    # (c): dynamic sparse training with a NaN step
    checks, ctrls = [], []
    orig_update = SC.DynamicSparsityController.update

    def update(self, step, w_scores, g_scores=None):
        # the LM-head plan td_plan_kernel built this step from the masked
        # weight, against the controller's forward plan of that mask
        if not ctrls:
            ctrls.append(self)
        fwd = self.plans("['lm_head']")[0]
        heads = [p for k, (_, _, p) in self.rt.plan_cache._entries.items()
                 if isinstance(k[0], tuple) and k[0][:1] == ("lm_head",)]
        for head in heads:
            if (head.bm, head.bk, head.shape) != (fwd.bm, fwd.bk, fwd.shape):
                continue
            same = all(torch.equal(x, y) for x, y in zip((head.nnz, head.idx, *head.workqueue()),
                                                         (fwd.nnz, fwd.idx, *fwd.workqueue())))
            checks.append({"step": step, "equal": same, "skipped": head.skipped_fraction()})
            if not same:
                raise AssertionError(f"launch (c) step {step}: the LM-head plan of the masked weight "
                                     "differs from the controller's forward plan")
        return orig_update(self, step, w_scores, g_scores)

    SC.DynamicSparsityController.update = update
    try:
        c = _launcher_run("c", ["--arch", relu.name] + LAUNCH_ARGS + LAUNCH_DST, {})
    finally:
        SC.DynamicSparsityController.update = orig_update
    out = c["stdout"]
    refreshes = [x for x in out.splitlines() if x.startswith("dst refresh step")]
    wdens = [float(x.split("Wdens=")[1].split()[0]) for x in out.splitlines() if "Wdens=" in x]
    if not ("update skipped (1/3 consecutive)" in out and "nonfinite -> skip-step x1" in out
            and len(refreshes) == 3 and all("plan-edit" in x for x in refreshes) and min(wdens) < 1.0):
        raise AssertionError(f"launch (c): missing skip, refresh, Wdens or summary lines:\n{out}")
    if not checks or not any(ch["skipped"] > 0 for ch in checks):
        raise AssertionError(f"launch (c): no LM-head plan with skipped blocks was checked ({checks})")
    (ctrl,) = ctrls
    stats = ctrl.rt.plan_cache.plan_stats()
    value_plans = [ps for ps in stats if ps["key"][0] != "dst"]
    if not any(ps["skipped_fraction"] > 0 for ps in value_plans):
        raise AssertionError("launch (c): no plan the kernels ran with skips a block")
    widest = max(p.k_blocks for _, _, p in ctrl.rt.plan_cache._entries.values())
    # every edited plan against the planner's fresh plan of the mask (one
    # td_plan_kernel launch each, outside the counted run)
    T.reset_launch_counts()
    n_plans = n_sparse = 0
    for path, u in ctrl.units.items():
        for l in range(u.layers):
            m = torch.from_numpy(u.mask[l]).cuda()
            for plan, mask in ((u.bwd[l], m), (u.fwd[l], m.T.contiguous())):
                fresh = T.plan_from_mask_csr(mask)
                if not all(torch.equal(x, y) for x, y in zip((plan.nnz, plan.idx, *plan.workqueue()), fresh)):
                    raise AssertionError(f"launch (c): edited plan {path}[{l}] differs from the planner's")
                n_plans += 1
                n_sparse += int(plan.skipped_fraction() > 0)
    replans = T.launch_counts()["planner[emitted]"]
    if replans != n_plans:
        raise AssertionError(f"launch (c): {replans} planner launches for {n_plans} fresh plans")
    del ctrl, ctrls
    torch.cuda.empty_cache()
    log(f"launch (c): {len(refreshes)} refreshes; the LM-head value plan equals the controller's at steps "
        f"{[ch['step'] for ch in checks]} (skipped {[round(ch['skipped'], 4) for ch in checks]}); "
        f"{n_plans} edited plans ({n_sparse} with skipped blocks) bit-equal to the planner's fresh plans; "
        f"widest planned row {widest} K blocks (the planner takes 24576)")

    # launches per step: (a) the LM head's products and plans alone (the
    # SiLU FFN runs on cuBLAS); (c) the ReLU path of the train phase
    L, mb, r = LAUNCH_LAYERS, TRAIN_MICRO, 2
    zero = dict.fromkeys(T.launch_counts(), 0)
    want_a = dict(zero, **{"tensordash_matmul_planned": 3 * mb, "planner[values]": 1 + mb,
                           "planner[transpose]": 1})
    want_c = dict(zero, **{"tensordash_matmul_fused": r * L * mb,
                           "tensordash_matmul_planned": (r * L + 1 + 4 * L + 2) * mb,
                           "planner[values]": (L + 1) * mb + 1, "planner[emitted]": (r + 1) * L * mb,
                           "planner[transpose]": L * mb + 1})
    for tag, run, want in (("a", a, want_a), ("b", b, want_a), ("c", c, want_c)):
        for i, st in enumerate(run["steps"]):
            w = dict(want, **{"planner[transpose]": want["planner[transpose]"] + int(i == 0 and tag == "c")})
            if st["launches"] != w:
                raise AssertionError(f"launch ({tag}) step {i + 1}: launches {st['launches']} != path's {w}")
        log(f"launch ({tag}): {run['seconds']:.1f} s; ms per step {[round(st['ms'], 1) for st in run['steps']]}; "
            f"tokens/s {[round(st['tok_per_s'], 1) for st in run['steps']]}; peak {run['peak_mem_gb']:.2f} GB; "
            f"launches on the last step {run['steps'][-1]['launches']} (== the path's)")
        for i, st in enumerate(run["steps"]):
            sp = st["spmm"]
            head = "; ".join(f"{p} {sp[p]['ms']:.3f} ms ({sp[p]['calls']} calls, skipped "
                             f"{[round(x, 4) for x in sp[p]['skipped']]})" for p in LM_HEAD_PRODUCTS if p in sp)
            log(f"launch ({tag}) step {i + 1} td_spmm device ms: LM head {head}; other {sp['other_ms']:.3f} ms")
    return {"layers": LAUNCH_LAYERS, "params_b": silu.param_count() / 1e9,
            "a": a, "b": b, "c": c,
            "checkpoint": {k: v for k, v in saved.items() if k != "sums"}, "restore_seconds": restored["seconds"],
            "lm_head_checks": checks, "edited_plans": n_plans, "edited_plans_sparse": n_sparse,
            "plan_stats": [dict(ps, key=repr(ps["key"])) for ps in stats], "widest_row_k_blocks": widest,
            "launches_per_step": {"a": a["steps"][-1]["launches"], "c": c["steps"][-1]["launches"],
                                  "c step 1": c["steps"][0]["launches"]}}


# ---------------------------------------------------------------------------
# the sharded phase: each rank's local step of the sharded SpMM on the card
# ---------------------------------------------------------------------------


def powerlaw_keep(mb: int, kb: int, zero_share: float, seed: int):
    """bool ``[mb, kb]`` block mask: block row ``r`` keeps ``round(d_r *
    kb)`` blocks (at least one) at random, ``d_r`` falling as ``(r + 1) **
    -0.5`` and scaled so that ``zero_share`` of all blocks are zero on
    average; the densest rows first, the worst case for a contiguous split."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fall = np.arange(1, mb + 1, dtype=np.float64) ** -0.5
    lo, hi = 0.0, float(mb)
    for _ in range(100):  # the scale whose clipped mean density is 1 - zero_share
        c = (lo + hi) / 2
        lo, hi = (c, hi) if np.clip(c * fall, 1 / kb, 1).mean() < 1 - zero_share else (lo, c)
    nnz = np.clip(np.round(np.clip(c * fall, 1 / kb, 1) * kb), 1, kb).astype(int)
    keep = np.zeros((mb, kb), bool)
    for r in range(mb):
        keep[r, rng.permutation(kb)[: nnz[r]]] = True
    return keep


def sharded_phase(bw: float) -> dict:
    """Each rank's local step of the sharded planned SpMM, for every rank in
    turn on the one card (a process group of several ranks needs several
    cards; NCCL refuses two ranks on one), put together as the collective
    would by ``parallel.spmm.assemble``:

    * M: the deepseek-7b LM head side B ``[102400,4096]@[4096,4]`` at 128 x
      512, :data:`SHARD_LM_ZERO` of its blocks zero with a power-law skew
      over the vocab's block rows, 4 shards, dealt serpentine and
      contiguous: bit-equal to the unsharded kernel, the shards' work and
      its imbalance (max over mean) each way;
    * N: the decode ``w_down`` ``[4,11008]@[11008,4096]`` on its emitted
      mask, 4 shards, and the fused ReLU gate ``[4,4096]@[4096,11008]`` at
      ``bn`` 128 (86 column blocks), 2 shards, out and mask: bit-equal;
    * K: ``w_down``'s 86 K blocks at ``bk`` 128 over 2 shards, bf16 operands
      and fp32 partials (the kernel's bf16-in, fp32-out store), summed in
      fp32 and cast: within the kernel tolerance of the unsharded kernel;
    * the backward of the train ``w_down`` at TRAIN_TOKENS tokens, fp32
      operands, bf16 output, 4 shards: ``ShardedVJP``'s ``da`` (M over the
      cotangent's rows) and ``db`` (N over its columns) bit-equal to the
      unsharded products;
    * the expert-parallel decode branch of one qwen3-moe-235b-a22b-ReLU MoE
      layer at full width (128 experts, about 4.8 GB of bf16 experts), 4
      tokens, expert-parallel size 4: each rank's ``decode_local_step``
      runs its 32 experts; the sum of the four against the unsharded
      ``moe_ffn`` within :data:`REF_REL_L2`, the planner and SpMM launches
      per rank; the int8 rows of the all-to-all's dispatch payload ``[E, C,
      d]`` against numpy's;
    * an NCCL group of world size 1 on the card: ``ef_compress_grads``, an
      int8 ``all_to_all_single`` and the quantized all-to-all, each equal to
      the local computation.

    Every local step runs once with the launch counts reset just before and
    read just after (no shard falls back to one); then the checks, and each
    shard's kernel timed beside the unsharded kernel, its plain version, one
    ``torch.matmul`` and its bound."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref, tensordash_spmm as T
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import moe_config
    from repro_torch.optim import compress
    from repro_torch.parallel import spmm
    from repro_torch.runtime.autodiff import _cot_plan, _lhs_t_plan
    from repro_torch.runtime.backends import KernelRequest, get_backend

    dev = torch.device("cuda")
    gdev = torch.Generator(device=dev).manual_seed(11)
    bf16, f32 = torch.bfloat16, torch.float32
    be = get_backend("cuda")

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gdev, device=dev) * scale

    def request(plan, a, b, bm, bk, bn, **kw):
        nnz, idx, rs, wr, wk = plan
        return KernelRequest(nnz=nnz, idx=idx, a=a, b=b, bm=bm, bk=bk, bn=bn, workqueue=(rs, wr, wk), **kw)

    # -- the cases: (label, axis, shards, deal, request, fused, stage) ---------
    cases = []
    keep = torch.from_numpy(powerlaw_keep(102400 // 128, 4096 // 512, SHARD_LM_ZERO, seed=3)).to(dev)
    w = rand(102400, 4096, scale=4096**-0.5).reshape(800, 128, 8, 512) * keep[:, None, :, None]
    lm_head = w.reshape(102400, 4096).to(bf16).T.contiguous()  # [d, V], as the model holds it
    del w
    a_t, b_t = lm_head.T, rand(SLOTS, 4096).to(bf16).T  # strided views, as Runtime.matmul(side="B")
    lm_req = request(T.plan_blocks_csr(a_t, 128, 512), a_t, b_t, 128, 512, SLOTS)
    for balance in (True, False):
        cases.append(("LM head side B", "M", 4, balance, lm_req, False, "decode"))
    hmask = (torch.rand(1, 86, generator=gdev, device=dev) < 0.4).to(torch.int8)
    h = (rand(SLOTS, 11008) * hmask.repeat_interleave(128, 1)).to(bf16)
    w_down = rand(11008, 4096, scale=11008**-0.5).to(bf16)
    down_req = request(T.plan_from_mask_csr(hmask), h, w_down, SLOTS, 128, 128)
    cases.append(("decode w_down", "N", 4, True, down_req, False, "decode"))
    x = rand(SLOTS, 4096).to(bf16)
    w_gate = rand(4096, 11008, scale=4096**-0.5).to(bf16)
    gate_req = request(T.dense_plan_csr(1, 8, dev), x, w_gate, SLOTS, 512, 128, activation="relu")
    cases.append(("decode gate (fused relu) bn 128", "N", 2, True, gate_req, True, "decode"))
    cases.append(("decode w_down bk 128", "K", 2, True, down_req, False, "decode"))
    # the train w_down backward: g [T, d] planned by value, h [T, d_ff] behind
    # the gate's mask, through ShardedVJP's plans as its backward builds them
    t = TRAIN_TOKENS
    gkeep = (torch.rand(t // 128, 4096 // 128, generator=gdev, device=dev) < 0.4).to(f32)
    g32 = (rand(t, 4096).reshape(t // 128, 128, 32, 128) * gkeep[:, None, :, None]).reshape(t, 4096)
    hkeep = (torch.rand(t // 128, 86, generator=gdev, device=dev) < 0.4).to(torch.int8)
    ht = (rand(t, 11008).reshape(t // 128, 128, 86, 128) * hkeep[:, None, :, None]).reshape(t, 11008).to(bf16)
    ctx = spmm.ShardedVJP(backend="cuda", bm=128, bk=128, bn=128)
    pg = _cot_plan(ctx, g32)
    hnnz, hidx = T.plan_from_mask(hkeep)
    pt = _lhs_t_plan(ctx, hnnz, hidx, ht)
    da_req = KernelRequest(nnz=pg.nnz, idx=pg.idx, a=g32, b=w_down.float().T, bm=128, bk=128, bn=128,
                           out_dtype=bf16, workqueue=pg.workqueue())
    db_req = KernelRequest(nnz=pt.nnz, idx=pt.idx, a=ht.float().T, b=g32, bm=128, bk=128, bn=128,
                           out_dtype=bf16, workqueue=pt.workqueue())
    cases.append((f"train w_down da = g @ w_down.T ({t} tokens)", "M", 4, True, da_req, False, "train"))
    cases.append((f"train w_down db = h.T @ g ({t} tokens)", "N", 4, True, db_req, False, "train"))

    def run_whole(req, fused):
        return be.execute_fused(req) if fused else be.execute_planned(req)

    wholes = [run_whole(req, fused) for _, _, _, _, req, fused, _ in cases]

    # -- the main path: every rank's local step, once, counted ---------------
    torch.cuda.synchronize()
    T.reset_launch_counts()
    pieces = []
    with no_plain_versions("the sharded local steps", allow=("workqueue_ref",)):
        for label, axis, n, balance, req, fused, _ in cases:
            if not spmm._divides(req, axis, n):
                raise AssertionError(f"sharded {label}: {axis} does not divide into {n} shards (would run unsharded)")
            pieces.append([spmm.local_step("cuda", req, axis, s, n, balance=balance, fused=fused)
                           for s in range(n)])
    torch.cuda.synchronize()
    launches = T.launch_counts()

    # -- checks and times -----------------------------------------------------
    rows, summary = [], []
    for (label, axis, n, balance, req, fused, stage), whole, parts in zip(cases, wholes, pieces):
        order = spmm.shard_order(req, n, balance) if axis == "M" else None
        got = spmm.assemble(axis, parts, req, order=order, fused=fused)
        deal = "" if axis != "M" else (" balanced" if balance else " contiguous")
        tag = f"sharded {axis}{deal} x{n} {label}"
        if axis == "K":
            err = check_close(tag, got, whole)
        else:
            same = (torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])) if fused \
                else torch.equal(got, whole)
            if not same:
                raise AssertionError(f"{tag}: not bit-equal to the unsharded kernel")
            err = 0.0
        m, k, nn = req.a.shape[0], req.a.shape[1], req.b.shape[1]
        esz, out_esz = req.a.element_size(), torch.empty((), dtype=req.out_dtype or req.a.dtype).element_size()
        whole_ms = cuda_ms(lambda: run_whole(req, fused), iters=10)
        shard_ms, work, shard_rows = [], [], []
        for s in range(n):
            req_l = spmm.local_request(req, axis, s, n, order=order)
            call = lambda: run_whole(req_l, fused)
            plain_fn = ref.tensordash_matmul_fused_ref if fused else ref.tensordash_matmul_ref
            plain = lambda: plain_fn(req_l.nnz, req_l.idx, req_l.a, req_l.b, bm=req_l.bm, bk=req_l.bk, bn=req_l.bn,
                                     out_dtype=req_l.out_dtype, **({"activation": "relu"} if fused else {}))
            out_l, want_l = call(), plain()
            shard_err = check_close(f"{tag} shard {s}", out_l[0] if fused else out_l, want_l[0] if fused else want_l,
                                    *((out_l[1], want_l[1]) if fused else ()))
            ms = cuda_ms(call, iters=10)
            ml, kl, nl = req_l.a.shape[0], req_l.a.shape[1], req_l.b.shape[1]
            nbytes, flops = plan_bytes_flops(req_l.nnz, req_l.idx, req_l.a, req_l.b, req_l.bm, req_l.bk,
                                             out_elems=ml * nl, out_esz=4 if axis == "K" else out_esz,
                                             extra_bytes=(ml // req_l.bm) * (nl // req_l.bn) if fused else 0)
            t_bytes = nbytes / bw * 1e3
            t_ops = flops / PEAK_FLOPS[str(req_l.a.dtype)] * 1e3
            row = {
                "case": f"{tag} shard {s}", "kernel": "tensordash_matmul_fused" if fused else "tensordash_matmul_planned",
                "dtype": f"{str(req_l.a.dtype)[6:]}->{str(req_l.out_dtype or req_l.a.dtype)[6:]}",
                "shape": f"[{ml},{kl}]@[{kl},{nl}]", "block": (req_l.bm, req_l.bk, req_l.bn),
                "max_abs_err": shard_err, "ms": ms, "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                "library_ms": cuda_ms(lambda: torch.matmul(req_l.a, req_l.b), iters=10),
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "main_path": False, "stage": f"sharded {stage}",
                "work": int(torch.clamp_min(torch.as_tensor(req_l.nnz), 1).sum()),
                "splits": T.launch_splits(*(req_l.split_shape or (ml, kl, nl)), req_l.bm, req_l.bk, req_l.bn, dev,
                                          req_l.a.dtype),
            }
            if axis == "K":  # the same shard stored in bf16, for the fp32 store's cost
                bf = dataclasses.replace(req_l, out_dtype=req.a.dtype)
                row["bf16_store_ms"] = cuda_ms(lambda: be.execute_planned(bf), iters=10)
            rows.append(row)
            shard_rows.append(row)
            shard_ms.append(ms)
            work.append(row["work"])
        imbalance = max(work) / (sum(work) / len(work))
        entry = {"case": tag, "axis": axis, "shards": n, "balance": balance, "max_abs_err": err,
                 "shard_ms": shard_ms, "sum_shard_ms": sum(shard_ms), "whole_ms": whole_ms, "work": work,
                 "imbalance": imbalance, "whole_shape": f"[{m},{k}]@[{k},{nn}]",
                 "whole_splits": T.launch_splits(m, k, nn, req.bm, req.bk, req.bn, dev, req.a.dtype),
                 "shard_splits": [r["splits"] for r in shard_rows]}
        if axis == "K":
            entry["bf16_store_ms"] = [r["bf16_store_ms"] for r in shard_rows]
        summary.append(entry)
        log(f"  {tag:<62} {entry['whole_shape']:<24} shards {[f'{x:.4f}' for x in shard_ms]} ms "
            f"(sum {entry['sum_shard_ms']:.4f}) vs unsharded {whole_ms:.4f} ms; work {work}, imbalance "
            f"{imbalance:.3f}; splits {entry['shard_splits']} (unsharded {entry['whole_splits']})"
            + (f"; fp32 store {[f'{x:.4f}' for x in shard_ms]} vs bf16 store "
               f"{[f'{x:.4f}' for x in entry['bf16_store_ms']]} ms" if axis == "K" else "")
            + ("; bit-equal" if axis != "K" else f"; max abs err {err:.3e} (kernel tolerance)"))
    lm = [e for e in summary if e["case"].startswith("sharded M") and "LM head" in e["case"]]
    log(f"sharded: LM head imbalance, serpentine {lm[0]['imbalance']:.3f} vs contiguous {lm[1]['imbalance']:.3f}")
    del lm_head, a_t, b_t, w_down, w_gate, g32, ht, pieces, wholes, cases, lm_req, down_req, gate_req, da_req, db_req
    free()

    # -- the expert-parallel decode branch of one full-width MoE layer -------
    cfg = dataclasses.replace(get_config(MOE_ARCH), activation="relu")
    mcfg = moe_config(cfg)
    ep = 4
    layer = init_params(moe_mod.moe_specs(mcfg), seed=0, dtype=bf16, device="cuda")
    expert_gb = sum(layer[k].numel() * 2 for k in ("w_gate", "w_up", "w_down")) / 1e9
    x = rand(SLOTS, 1, mcfg.d_model).to(bf16)
    rt = rtm.Runtime(backend="cuda", device="cuda")
    with torch.inference_mode():
        whole = moe_mod.moe_ffn(layer, mcfg, x, rt=rt)
        e_local = mcfg.num_experts // ep
        bodies, per_rank = [], []
        with no_plain_versions("the expert-parallel decode local steps"):
            for s in range(ep):
                mine = {"router": layer["router"],
                        **{k: layer[k][s * e_local:(s + 1) * e_local] for k in ("w_gate", "w_up", "w_down")}}
                T.reset_launch_counts()
                bodies.append(moe_mod.decode_local_step(mcfg, s, ep, mine, x.reshape(-1, mcfg.d_model), rt=rt))
                torch.cuda.synchronize()
                counts = T.launch_counts()
                per_rank.append({k: v for k, v in counts.items() if v})
                for kname, v in counts.items():
                    launches[kname] += v
        total = torch.stack([b.float() for b in bodies]).sum(0)
        rel = float(torch.linalg.vector_norm(total - whole.reshape(total.shape).float())
                    / torch.linalg.vector_norm(whole.float()))
        body_ms = [cuda_ms(lambda s=s: moe_mod.decode_local_step(
            mcfg, s, ep, {"router": layer["router"], **{k: layer[k][s * e_local:(s + 1) * e_local]
                                                      for k in ("w_gate", "w_up", "w_down")}},
            x.reshape(-1, mcfg.d_model), rt=rt), iters=3, warmup=1) for s in range(ep)]
        whole_ms = cuda_ms(lambda: moe_mod.moe_ffn(layer, mcfg, x, rt=rt), iters=3, warmup=1)
        # the int8 rows of the seq branch's dispatch payload [E, C, d]: a
        # 4 x 32-token prefill group's bucketing
        x2 = rand(SLOTS * 32, mcfg.d_model).to(bf16)
        cap = moe_mod.expert_capacity(mcfg, x2.shape[0])
        _, top_e, _ = moe_mod._route(mcfg, x2, layer["router"])
        table, _, _ = moe_mod._bucket(mcfg, top_e, mcfg.num_experts, cap, x2.shape[0])
        xe = torch.cat([x2, x2.new_zeros((1, x2.shape[1]))])[torch.clamp_max(table // mcfg.top_k, x2.shape[0])]
        q, scale = moe_mod._quantize_rows(xe)
        deq = moe_mod._dequantize_rows(q, scale, xe.dtype)
        xn = xe.float().cpu().numpy()
        s_np = np.maximum(np.abs(xn).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-12)).astype(np.float32)
        q_np = np.clip(np.rint(xn / s_np), -127, 127).astype(np.int8)
        deq_np = (q_np.astype(np.float32) * s_np).astype(np.float32)
    if not (np.array_equal(q.cpu().numpy(), q_np) and np.array_equal(scale.cpu().numpy(), s_np)
            and torch.equal(deq, torch.from_numpy(deq_np).to(dev, bf16))):
        raise AssertionError("sharded: the int8 rows of the dispatch payload differ from numpy's")
    if not bool(torch.isfinite(total).all()) or rel > REF_REL_L2:
        raise AssertionError(f"sharded: the {ep} expert-parallel decode bodies sum to relative L2 {rel} of the "
                             f"unsharded layer (bound {REF_REL_L2})")
    want = {"planner[values]": e_local, "tensordash_matmul_planned": e_local}
    if any(r != want for r in per_rank):
        raise AssertionError(f"sharded: per-rank launches {per_rank}, expected {want} (one plan and one planned "
                             "product per local expert)")
    moe = {"experts_gb": expert_gb, "rel_l2": rel, "launches_per_rank": per_rank, "body_ms": body_ms,
           "whole_ms": whole_ms, "payload": list(xe.shape), "payload_bytes_int8": q.numel() + scale.numel() * 4,
           "payload_bytes_bf16": xe.numel() * 2}
    log(f"sharded moe: {MOE_ARCH} relu, one MoE layer at full width ({mcfg.num_experts} experts, d_model "
        f"{mcfg.d_model}, d_ff {mcfg.d_ff}, {expert_gb:.2f} GB bf16 experts), {SLOTS} tokens, expert-parallel "
        f"size {ep}: the {ep} decode bodies sum to relative L2 {rel:.3e} of the unsharded layer (bound "
        f"{REF_REL_L2:.3e}); launches per rank {per_rank}; body ms {[round(v, 4) for v in body_ms]} vs the "
        f"unsharded layer {whole_ms:.4f} ms; dispatch payload {list(xe.shape)} int8 rows equal numpy's "
        f"({moe['payload_bytes_int8']} B with scales vs {moe['payload_bytes_bf16']} B bf16)")
    del layer, x, whole, bodies, total, xe, q, deq
    free()

    # -- an NCCL group of world size 1 on the card ----------------------------
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            grads = {"w": rand(1024, 1024), "b": rand(4096)}
            res = {k: rand(*v.shape, scale=1e-3) for k, v in grads.items()}
            red, new = compress.ef_compress_grads(grads, res, group=dist.group.WORLD)
            for kname, g in grads.items():
                gq = g + res[kname]
                local = compress.dequantize(*compress.quantize(gq))
                if not (torch.equal(red[kname], local) and torch.equal(new[kname], gq - local)):
                    raise AssertionError(f"sharded nccl: ef_compress_grads[{kname}] differs from the local sum")
            payload = torch.randint(-127, 128, (mcfg.num_experts, 4, 256), generator=gdev, device=dev,
                                    dtype=torch.int8)
            out = torch.empty_like(payload)
            dist.all_to_all_single(out, payload)
            xq = rand(mcfg.num_experts, 4, 256).to(bf16)
            qa2a = moe_mod._quantized_all_to_all(xq, 0, 1, dist.group.WORLD)
            torch.cuda.synchronize()
            if not torch.equal(out, payload):
                raise AssertionError("sharded nccl: the int8 all_to_all_single is not the identity on one rank")
            if not torch.equal(qa2a, moe_mod._dequantize_rows(*moe_mod._quantize_rows(xq), bf16)):
                raise AssertionError("sharded nccl: the quantized all-to-all differs from the local round trip")
            nccl = {"backend": dist.get_backend(), "world_size": dist.get_world_size(), "nccl": list(torch.cuda.nccl.version())}
        finally:
            dist.destroy_process_group()
    log(f"sharded nccl: a group of world size 1 (NCCL {nccl['nccl']}): ef_compress_grads, an int8 "
        "all_to_all_single and the quantized all-to-all equal the local computation; no run across cards was "
        "made (the machine has one card)")
    return {"cases": summary, "rows": rows, "launches": launches, "moe": moe, "nccl": nccl}


def _tp_specs(specs, tp: int):
    """The spec tuples of a spec tree on a ``(data 1, model tp)`` mesh (a
    duck-typed one: the spec table needs no process group)."""
    import types

    from repro_torch.parallel import sharding as S

    return S.param_pspecs(specs, types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": tp}))


def _rank_slice(x, spec, tp: int, rank: int):
    """Model rank ``rank``'s ``local_shard`` of ``x`` on a ``(1, tp)`` mesh,
    cut without a process group (its own storage, as a rank holds it)."""
    from repro_torch.parallel import sharding as S

    return S.shard_slice(x, spec, lambda e: {"model": (tp, rank), "data": (1, 0)}[e]).contiguous()


def restore_rank_task(directory: str) -> dict:
    """One CPU rank of a ``(1, SM_TP)`` gloo mesh: ``restore(shardings=)``
    of the saved full-width block onto the tensor-parallel specs, each leaf
    against this rank's ``local_shard`` of the stored array."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.checkpoint import manager as man
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.rehearsal import mesh
    from repro_torch.runtime import Runtime

    cfg = dataclasses.replace(get_config("deepseek-7b"), activation="relu")
    policy = S.ShardingPolicy(mesh=mesh((1, SM_TP), ("data", "model")))
    specs = policy.param_pspecs(tfm.block_specs(cfg))
    like = S.map_specs(lambda decl, spec: torch.zeros(
        S.local_shard(torch.empty(decl.shape, device="meta"), spec, policy).shape, dtype=torch.bfloat16),
        tfm.block_specs(cfg), specs)
    with Runtime(backend="reference", device="cpu", sharding=policy).use():
        got = man.restore(directory, 1, {"block": like}, shardings={"block": specs})["block"]
    base = Path(directory) / "step_000000000001" / "arrays.npz"
    same, nbytes = [], 0
    with np.load(base) as z:
        for k in ("attn", "mlp"):
            for n, t in got[k].items():
                full = torch.from_numpy(z[f"block/{k}/{n}"]).view(torch.bfloat16)
                same.append(torch.equal(t, S.local_shard(full, specs[k][n], policy)))
                nbytes += t.numel() * t.element_size()
    return {"equal": all(same), "leaves": len(same), "bytes": nbytes}


def tp_ffn_check(tag: str, w: dict, x2, rt, plain_rt) -> dict:
    """One tensor-parallel rank's FFN products at their local geometries,
    held to their plain versions on the same inputs: the fused ReLU gate
    (``check_close``'s bf16 tolerance) and its mask exactly, the plan the
    planner emits from that mask bit-equal to the plain planner chain, the
    planned ``w_down`` rows on the fp32 store (fp32 tolerance)."""
    import torch
    from repro_torch.kernels import ref

    with torch.no_grad():
        g, gmask = rt.matmul_fused(x2, w["w_gate"], activation="relu", assume_dense=True)
        pg, pmask = plain_rt.matmul_fused(x2, w["w_gate"], activation="relu", assume_dense=True)
        gate_err = check_close(f"{tag} gate {list(w['w_gate'].shape)}", g, pg, gmask, pmask)
        h2 = g * (x2 @ w["w_up"])
        plan = rt.plan_for_fused_output(gmask, h2, w["w_down"])
        plain_plan = ref.plan_from_mask_csr_ref(gmask, coarsen=plan.bk // (h2.shape[1] // gmask.shape[1]))
        if not all(torch.equal(a, b) for a, b in zip((plan.nnz, plan.idx, *plan.workqueue()), plain_plan)):
            raise AssertionError(f"{tag}: the emitted plan differs from the plain planner chain's")
        y = rt.matmul(h2, w["w_down"], plan=plan, out_dtype=torch.float32)
        down_err = check_close(f"{tag} w_down {list(w['w_down'].shape)} bk {plan.bk}", y,
                               plain_rt.matmul(h2, w["w_down"], plan=plan, out_dtype=torch.float32))
    return {"gate_shape": [list(x2.shape), list(w["w_gate"].shape)], "gate_lanes": rt.lane(w["w_gate"].shape[1]),
            "gate_max_abs_err": gate_err, "w_down_bk": plan.bk, "w_down_max_abs_err": down_err}


def ffn_product_times(x2, w: dict, rt, plain_rt, bw: float, *, partial: bool) -> dict:
    """A gated ReLU FFN's products at decode, one by one: each product's
    kernel ms, its plain version (the ``reference`` executors on the card),
    one ``torch.matmul`` and its byte bound; ``partial``: a tensor-parallel
    rank's ``w_down`` rows on the fp32 store."""
    import torch

    g, gmask = rt.matmul_fused(x2, w["w_gate"], activation="relu", assume_dense=True)
    h2 = g * (x2 @ w["w_up"])
    plan = rt.plan_for_fused_output(gmask, h2, w["w_down"])
    out32 = torch.float32 if partial else None
    wg, wd = w["w_gate"], w["w_down"]
    work = int(torch.clamp_min(torch.as_tensor(plan.nnz), 1).sum())  # effectual (row, K block) items
    return {
        "gate_ms": cuda_ms(lambda: rt.matmul_fused(x2, wg, activation="relu", assume_dense=True), iters=10),
        "gate_plain_ms": cuda_ms(lambda: plain_rt.matmul_fused(x2, wg, activation="relu", assume_dense=True),
                                 iters=3, warmup=1),
        "gate_library_ms": cuda_ms(lambda: torch.matmul(x2, wg), iters=10),
        "gate_bound_ms": (x2.numel() + wg.numel() + x2.shape[0] * wg.shape[1]) * 2 / bw * 1e3,
        "emitted_plan_ms": cuda_ms(lambda: rt.plan_for_fused_output(gmask, h2, wd), iters=10),
        "w_down_ms": cuda_ms(lambda: rt.matmul(h2, wd, plan=plan, out_dtype=out32), iters=10),
        "w_down_plain_ms": cuda_ms(lambda: plain_rt.matmul(h2, wd, plan=plan, out_dtype=out32), iters=3, warmup=1),
        "w_down_library_ms": cuda_ms(lambda: torch.matmul(h2, wd), iters=10),
        "w_down_bound_ms": (h2.numel() * 2 + work * plan.bk * wd.shape[1] * 2
                            + h2.shape[0] * wd.shape[1] * (4 if out32 else 2)) / bw * 1e3,
        "gate_lanes": rt.lane(wg.shape[1]), "w_down_bk": plan.bk,
        "w_down_k_blocks": h2.shape[1] // plan.bk, "shapes": [list(wg.shape), list(wd.shape)]}


def sharded_model_phase(bw: float) -> dict:
    """The sharded model (tensor parallel over ``model``, FSDP over
    ``data``) of full-width deepseek-7b-ReLU on the one card, each model
    rank's local step run in turn (NCCL refuses two ranks on one card):

    (a) the block under tensor parallel SM_TP: each rank's attention body
        (its 8 heads and kv heads, its ``wo`` rows, fp32 partials) and FFN
        body (its gate columns fused on the kernel, the plan the planner
        emits from its own mask, its ``w_down`` rows on the kernel's fp32
        store), summed, against the unsharded block within ``REF_REL_L2``,
        at SM_ROWS decode rows over SM_PREFIX cached tokens and at an
        SM_PREFILL-token prefill; one fused, one emitted plan and one planned
        launch per rank and FFN call;
    (b) the vocab-parallel head: SM_TP local ``lm_head`` slices ``[4096,
        25600]`` on side B, each launch splitting K as the whole head's does
        (``split_shape``): their concatenation bit-equal to the unsharded
        head; the vocab-parallel cross entropy from the ranks' max, sums and
        target logits within ``LOSS_REL`` of the unsharded loss;
    (c) the backward of (a) and (b) at SM_TRAIN_TOKENS tokens: each rank's
        weight-gradient slices, put together, against the unsharded
        gradients within ``GRAD_REL_L2``;
    (d) an NCCL group of one rank and ``launch.mesh.make_local_mesh()``: the
        sharded train step of the model cut to SM_LAYERS layers (loss within
        ``LOSS_REL``, gradients within ``GRAD_REL_L2`` of the unsharded
        ones) and the sharded engine (greedy tokens equal to the unsharded
        engine's, its decode chunk through the CUDA graph);
    (e) the block saved whole and ``restore(shardings=)`` on SM_TP gloo CPU
        ranks onto the tensor-parallel specs: every slice bit-equal to the
        rank's ``local_shard``.

    Launches are counted over (a)-(d), reset just before and read just
    after; then each body is timed (kernel ms per rank, their sum against
    the unsharded block, the slowest rank)."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch import runtime as rtm
    from repro_torch.checkpoint import manager as man
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import init_params
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.rehearsal import RankPool
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step as TS

    dev, bf16, tp = torch.device("cuda"), torch.bfloat16, SM_TP
    t_phase, spent = time.perf_counter(), {}
    gen = torch.Generator(device=dev).manual_seed(21)
    cfg = dataclasses.replace(get_config("deepseek-7b"), activation="relu")
    acfg, d, v = tfm.attn_config(cfg), cfg.d_model, cfg.vocab_size
    rt = rtm.Runtime(backend="cuda", device="cuda")
    specs = tfm.block_specs(cfg)
    block = init_params(specs, seed=3, dtype=bf16, device="cuda")
    pspec = _tp_specs(specs, tp)
    local_attn = [tfm.attn_local(acfg, tp, r, dev) for r in range(tp)]
    # each rank's weights as the sharded model holds them: its slices, and
    # the whole K/V where the kv heads do not divide the model axis
    ranks = [{k: {n: (w if k == "attn" and n in ("wk", "wv") and local_attn[r][1] is not None
                      else _rank_slice(w, pspec[k][n], tp, r)) for n, w in block[k].items()}
              for k in ("attn", "mlp")} for r in range(tp)]
    lm_head = (torch.randn(d, v, generator=gen, device=dev) * d**-0.5).to(bf16)
    hspec = _tp_specs({"lm_head": M.param_specs(cfg)["lm_head"]}, tp)["lm_head"]
    heads = [_rank_slice(lm_head, hspec, tp, r) for r in range(tp)]
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(bf16)

    def grown(cache, max_len):
        return attn.KVCache(*(torch.cat([c, c.new_zeros((c.shape[0], max_len - c.shape[1], *c.shape[2:]))], 1)
                              if c is not None else None for c in cache))

    # -- the inputs of the decode and prefill cases -------------------------
    x_prefix, x_dec, f_dec = rand(SM_ROWS, SM_PREFIX, d), rand(SM_ROWS, 1, d), rand(SM_ROWS, 1, d)
    x_pre, f_pre = rand(1, SM_PREFILL, d), rand(1, SM_PREFILL, d)
    pos_prefix, pos_pre = torch.arange(SM_PREFIX, device=dev), torch.arange(SM_PREFILL, device=dev)
    rope_prefix, rope_pre = attn.rope_tables(acfg, pos_prefix), attn.rope_tables(acfg, pos_pre)
    # a position a row on the card, as the engine decodes: no index reaches the host
    pos_dec = torch.full((SM_ROWS,), SM_PREFIX, device=dev)
    rope_dec = attn.rope_tables(acfg, attn.decode_positions(pos_dec, SM_ROWS, dev))
    h_dec, h_pre = rand(SM_ROWS, 1, d), rand(1, SM_PREFILL, d)
    labels = torch.randint(0, v, (SM_PREFILL,), generator=gen, device=dev)

    def attn_whole(case):
        if case == "decode":
            return attn.attention_decode(block["attn"], acfg, x_dec, whole_cache, pos_dec, rope_dec)[0]
        return attn.attention_fwd(block["attn"], acfg, x_pre, pos_pre, rope_pre)

    # each rank's caches of the decode rows' prefix: its own kv heads
    with torch.no_grad():
        rank_caches = [grown(attn.attention_fwd(ranks[r]["attn"], local_attn[r][0], x_prefix, pos_prefix,
                                                rope_prefix, return_cache=True, kv_index=local_attn[r][1],
                                                partial=True)[1], SM_PREFIX + 8) for r in range(tp)]
        whole_cache = grown(attn.attention_fwd(block["attn"], acfg, x_prefix, pos_prefix, rope_prefix,
                                               return_cache=True)[1], SM_PREFIX + 8)

    def attn_body(case, r):
        lcfg, kv_index = local_attn[r]
        w = ranks[r]["attn"]
        if case == "decode":  # writes the step's K/V at the same row on every call
            return attn.attention_decode(w, lcfg, x_dec, rank_caches[r], pos_dec, rope_dec,
                                         kv_index=kv_index, partial=True)[0]
        return attn.attention_fwd(w, lcfg, x_pre, pos_pre, rope_pre, kv_index=kv_index, partial=True)

    def ffn_body(case, r):
        return tfm.mlp_fwd(ranks[r]["mlp"], cfg, f_dec if case == "decode" else f_pre, rt=rt, partial=True)

    def ffn_whole(case):
        return tfm.mlp_fwd(block["mlp"], cfg, f_dec if case == "decode" else f_pre, rt=rt)

    def head_body(h, r, w=None):
        w = heads[r] if w is None else w
        with rt.use():
            return tfm.head_matmul(cfg, h, w, key=("lm_head", id(w)), vocab=v)

    # -- (a) and (b): every rank's local step, counted -----------------------
    torch.cuda.synchronize()
    T.reset_launch_counts()
    out, per_rank = {}, []
    with torch.no_grad(), no_plain_versions("the sharded model's local steps"):
        for case in ("decode", "prefill"):
            atts, ffns = [], []
            for r in range(tp):
                before = T.launch_counts()
                atts.append(attn_body(case, r))
                ffns.append(ffn_body(case, r))
                torch.cuda.synchronize()
                per_rank.append({k: n - before[k] for k, n in T.launch_counts().items() if n != before[k]})
            out[case] = (torch.stack([a.float() for a in atts]).sum(0).to(bf16),
                         torch.stack(ffns).sum(0).to(bf16))
        logits = {case: [head_body(h, r) for r in range(tp)] for case, h in (("decode", h_dec), ("prefill", h_pre))}
    torch.cuda.synchronize()
    launches_ab = T.launch_counts()
    want_rank = {"tensordash_matmul_fused": 1, "planner[emitted]": 1, "tensordash_matmul_planned": 1}
    if any(c != want_rank for c in per_rank):
        raise AssertionError(f"sharded model (a): launches per rank and FFN call {per_rank}, expected {want_rank}")
    # each rank's FFN products at their local geometries, held to their plain
    # versions on the same inputs: the gate (check_close's bf16 tolerance)
    # and its mask, the emitted plan bit-equal to the plain planner chain,
    # w_down on the fp32 store (fp32 tolerance)
    plain_rt = rt.replace(backend="reference")
    tp_checks = [{"case": case, "rank": r, **tp_ffn_check(f"sharded model (a) {case} rank {r}", ranks[r]["mlp"],
                                                          f.reshape(-1, d), rt, plain_rt)}
                 for case, f in (("decode", f_dec), ("prefill", f_pre)) for r in range(tp)]
    kernel_rows = [{"kernel": k, "main_path": False, "max_abs_err": max(c[e] for c in tp_checks)}
                   for k, e in (("tensordash_matmul_fused", "gate_max_abs_err"),
                                ("tensordash_matmul_planned", "w_down_max_abs_err"))]
    kernel_rows.append({"kernel": "planner[emitted]", "main_path": False, "max_abs_err": 0.0})
    log(f"sharded model (a): each rank's FFN products against their plain versions on the card: "
        + "; ".join(f"{case} gate {tp_checks[i]['gate_shape']} (bn {tp_checks[i]['gate_lanes']}) max abs err "
                    f"{[c['gate_max_abs_err'] for c in tp_checks if c['case'] == case]}, mask and emitted plan "
                    f"bit-equal, w_down (bk {tp_checks[i]['w_down_bk']}, fp32 store) max abs err "
                    f"{[c['w_down_max_abs_err'] for c in tp_checks if c['case'] == case]}"
                    for i, case in ((0, "decode"), (tp, "prefill"))))
    rows = []
    with torch.no_grad():
        for case in ("decode", "prefill"):
            ra, rf = _rel_l2(out[case][0], attn_whole(case)), _rel_l2(out[case][1], ffn_whole(case))
            if not (ra <= REF_REL_L2 and rf <= REF_REL_L2):
                raise AssertionError(f"sharded model (a) {case}: attention {ra}, FFN {rf} relative L2 of the "
                                     f"unsharded block (bound {REF_REL_L2})")
            rows.append({"case": case, "attn_rel_l2": ra, "ffn_rel_l2": rf})
        head_eq = {}
        for case, h in (("decode", h_dec), ("prefill", h_pre)):
            with rt.use():
                whole = tfm.head_matmul(cfg, h, lm_head)
            head_eq[case] = torch.equal(torch.cat(logits[case], -1), whole)
            if not head_eq[case]:
                raise AssertionError(f"sharded model (b) {case}: the {tp} head slices are not bit-equal to the "
                                     "unsharded head")
        # the vocab-parallel cross entropy from the ranks' pieces
        pieces = [x.float().reshape(-1, x.shape[-1]) for x in logits["prefill"]]
        gmax = torch.stack([S.ce_local_max(x) for x in pieces]).amax(0)
        sums = [S.ce_local_sums(x, labels, r * x.shape[-1], gmax) for r, x in enumerate(pieces)]
        gsum, tgt = sum(s_ for s_, _ in sums), sum(t_ for _, t_ in sums)
        ce = float((torch.log(gsum) - tgt).mean())
        whole_logits = torch.cat(pieces, -1)
        ce_whole = float(-torch.gather(torch.log_softmax(whole_logits, -1), -1, labels[:, None]).mean())
    ce_rel = abs(ce - ce_whole) / abs(ce_whole)
    if ce_rel > LOSS_REL:
        raise AssertionError(f"sharded model (b): vocab-parallel cross entropy {ce} vs {ce_whole}")
    del logits, pieces, whole_logits
    log(f"sharded model (a): deepseek-7b relu block at full width under tensor parallel {tp}: the ranks' "
        + "; ".join(f"{r['case']} attention relative L2 {r['attn_rel_l2']:.3e}, FFN {r['ffn_rel_l2']:.3e}"
                    for r in rows)
        + f" of the unsharded block (bound {REF_REL_L2:.3e}); launches per rank and FFN call {per_rank[0]}")
    log(f"sharded model (b): {tp} lm_head slices {list(heads[0].shape)} side B: concatenation bit-equal to the "
        f"unsharded head at {SM_ROWS} and {SM_PREFILL} rows; vocab-parallel cross entropy {ce:.6f} vs {ce_whole:.6f} "
        f"(relative {ce_rel:.3e}, bound {LOSS_REL:.3e})")

    spent["a_b"] = time.perf_counter() - t_phase
    # -- (c) the backward of (a) and (b) -------------------------------------
    t = SM_TRAIN_TOKENS
    xb, gy = rand(1, t, d), rand(1, t, d) * 0.01
    posb = torch.arange(t, device=dev)
    ropeb = attn.rope_tables(acfg, posb)
    hb, lab = rand(1, t, d), torch.randint(0, v, (t,), generator=gen, device=dev)
    cat_dim = lambda spec: next(i for i, e in enumerate(spec) if e == "model")
    grad_rel = {}
    torch.cuda.synchronize()
    T.reset_launch_counts()
    with no_plain_versions("the sharded model's backward"):
        for part, fwd_whole, fwd_local in (
                ("attn", lambda w: attn.attention_fwd(w, acfg, xb, posb, ropeb),
                 lambda w, r: attn.attention_fwd(w, local_attn[r][0], xb, posb, ropeb, kv_index=local_attn[r][1],
                                                 partial=True)),
                ("mlp", lambda w: tfm.mlp_fwd(w, cfg, xb, rt=rt),
                 lambda w, r: tfm.mlp_fwd(w, cfg, xb, rt=rt, partial=True))):
            names = sorted(block[part])
            w = {n: block[part][n].detach().requires_grad_() for n in names}
            whole = dict(zip(names, torch.autograd.grad(fwd_whole(w), [w[n] for n in names], gy)))
            slices = {n: [] for n in names}
            for r in range(tp):
                wr = {n: ranks[r][part][n].detach().requires_grad_() for n in names}
                for n, g in zip(names, torch.autograd.grad(fwd_local(wr, r), [wr[n] for n in names], gy.float())):
                    slices[n].append(g)
            for n in names:  # slices put together; a weight every rank holds whole: its gradients summed
                got = (sum(g.float() for g in slices[n]) if slices[n][0].shape == whole[n].shape
                       else torch.cat(slices[n], cat_dim(pspec[part][n])))
                grad_rel[f"{part}.{n}"] = _rel_l2(got, whole[n])
            del w, whole, slices
        # the head: the unsharded loss's gradients, and each rank's from the
        # global max and sum of exponentials
        wl = lm_head.detach().requires_grad_()
        hl = hb.detach().requires_grad_()
        with rt.use():
            lw = tfm.head_matmul(cfg, hl, wl).float().reshape(t, v)
        loss = -torch.gather(torch.log_softmax(lw, -1), -1, lab[:, None]).mean()
        dw_whole, dh_whole = torch.autograd.grad(loss, [wl, hl])
        del lw, loss
        pieces, parts = [], []
        for r in range(tp):
            wr = heads[r].detach().requires_grad_()
            hr = hb.detach().requires_grad_()
            pieces.append((wr, hr, head_body(hr, r, wr)))
        with torch.no_grad():
            flat = [p[2].float().reshape(t, -1) for p in pieces]
            gmax = torch.stack([S.ce_local_max(x) for x in flat]).amax(0)
            gsum = sum(S.ce_local_sums(x, lab, r * x.shape[-1], gmax)[0] for r, x in enumerate(flat))
        for r, ((wr, hr, lr), x) in enumerate(zip(pieces, flat)):
            dl = S.ce_local_grad(x, lab, r * x.shape[-1], gmax, gsum, torch.full((t,), 1.0 / t, device=dev))
            parts.append(torch.autograd.grad(lr, [wr, hr], dl.reshape(lr.shape).to(lr.dtype)))
        grad_rel["lm_head"] = _rel_l2(torch.cat([p[0] for p in parts], 1), dw_whole)
        grad_rel["head input"] = _rel_l2(sum(p[1].float() for p in parts), dh_whole)
        del pieces, parts, flat, dw_whole, dh_whole
    torch.cuda.synchronize()
    launches_c = T.launch_counts()
    worst = max(grad_rel, key=grad_rel.get)
    if grad_rel[worst] > GRAD_REL_L2:
        raise AssertionError(f"sharded model (c): gradient {worst} relative L2 {grad_rel[worst]} (bound {GRAD_REL_L2})")
    log(f"sharded model (c): the backward at {t} tokens, each rank's weight-gradient slices put together: worst "
        f"relative L2 {grad_rel[worst]:.3e} at {worst} over {len(grad_rel)} tensors (bound {GRAD_REL_L2:.3e}); "
        f"launches {dict((k, n) for k, n in launches_c.items() if n)}")
    free()

    spent["c"] = time.perf_counter() - t_phase - sum(spent.values())
    # -- (d) the whole sharded step and engine on an NCCL group of one rank ----
    cfg_l = dataclasses.replace(cfg, num_layers=SM_LAYERS)
    params = init_params(M.param_specs(cfg_l), seed=0, dtype=bf16, device="cuda")
    batch = SyntheticLM(vocab_size=v, seq_len=SM_SEQ, global_batch=SM_BATCH, seed=0).batch_at(0)
    prompts = torch.randint(0, v, (SM_REQUESTS, SM_PROMPT), generator=gen, device=dev).cpu()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            policy = S.ShardingPolicy(mesh=make_local_mesh())
            srt = rt.replace(sharding=policy, plan_cache=rtm.PlanCache())
            local = S.shard_tree(params, policy.param_pspecs(M.param_specs(cfg_l)), policy)
            torch.cuda.synchronize()
            T.reset_launch_counts()
            with srt.use(), no_plain_versions("the sharded train step and engine"):
                sh = tfm.shards_of(cfg_l)
                loss_s, grads_s, _ = TS.accumulate_grads(TS.make_loss_fn(cfg_l), cfg_l, local, batch, shards=sh)
                loss_s = float(loss_s)
                eng = ServeEngine(local, cfg_l, slots=SM_REQUESTS, max_len=SM_PROMPT + SM_NEW, chunk=SM_CHUNK,
                                  rt=srt)
                rids = [eng.submit(p, max_new=SM_NEW) for p in prompts]
                toks_s = eng.run()
                graph_s = eng.stats()["decode_graph_captures"]
                del eng
                # last, as it updates the shards in place
                step = TS.make_train_step(cfg_l, OptConfig(lr=1e-4, warmup_steps=1))
                opt = TS.init_train_state(cfg_l, local)
                t0 = time.perf_counter()
                _, _, m = step(local, opt, batch)
                step_loss = float(m["loss"])
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t0
                del opt
            torch.cuda.synchronize()
            launches_d = T.launch_counts()
            mesh_desc = (tuple(policy.mesh.shape), tuple(policy.mesh.mesh_dim_names), dist.get_backend())
        finally:
            dist.destroy_process_group()
    del local
    free()
    with rt.use():
        loss_u, grads_u, _ = TS.accumulate_grads(TS.make_loss_fn(cfg_l), cfg_l, params, batch)
        loss_u = float(loss_u)
        eng = ServeEngine(params, cfg_l, slots=SM_REQUESTS, max_len=SM_PROMPT + SM_NEW, chunk=SM_CHUNK,
                          rt=rt.replace(plan_cache=rtm.PlanCache()))
        urids = [eng.submit(p, max_new=SM_NEW) for p in prompts]
        toks_u = eng.run()
    d_rel = {i: _rel_l2(a, b) for i, (a, b) in enumerate(zip(grads_s, grads_u))}
    d_worst = max(d_rel, key=d_rel.get)
    loss_rel = abs(loss_s - loss_u) / abs(loss_u)
    same_tokens = [toks_s[a] for a in rids] == [toks_u[b] for b in urids]
    if not (loss_rel <= LOSS_REL and d_rel[d_worst] <= GRAD_REL_L2 and same_tokens and graph_s == 1
            and abs(step_loss - loss_s) <= 1e-6 * abs(loss_s)):
        raise AssertionError(f"sharded model (d): loss {loss_s} vs {loss_u}, step loss {step_loss}, worst gradient "
                             f"{d_rel[d_worst]}, tokens equal {same_tokens}, graph captures {graph_s}")
    log(f"sharded model (d): NCCL group of one rank, make_local_mesh() {mesh_desc[0]} over {mesh_desc[1]}: "
        f"deepseek-7b relu cut to {SM_LAYERS} layers, {SM_BATCH} x {SM_SEQ} tokens: sharded loss {loss_s:.6f} vs "
        f"unsharded {loss_u:.6f} (relative {loss_rel:.3e}, bound {LOSS_REL:.3e}), worst gradient relative L2 "
        f"{d_rel[d_worst]:.3e} (leaf {d_worst}, bound {GRAD_REL_L2:.3e}); one sharded make_train_step step "
        f"{step_s:.2f} s, loss {step_loss:.6f}; the sharded engine's greedy tokens equal the unsharded engine's "
        f"({SM_REQUESTS} requests, {SM_NEW} new tokens, decode graph captured {graph_s}x)")
    del params, grads_s, grads_u, eng
    free()

    spent["d"] = time.perf_counter() - t_phase - sum(spent.values())
    # -- (e) restore(shardings=) onto the tensor-parallel specs ---------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        man.save(tmp, 1, {"block": block})
        with RankPool(tp, tmp, timeout=120.0) as pool:
            restored = pool.run(restore_rank_task, tmp, deadline=300.0)
        restore_s = time.perf_counter() - t0
    if not all(r["equal"] for r in restored):
        raise AssertionError(f"sharded model (e): restored slices differ from local_shard: {restored}")
    log(f"sharded model (e): the block saved whole, restore(shardings=) on {tp} gloo CPU ranks of a (1, {tp}) "
        f"mesh: every slice bit-equal to local_shard ({restored[0]['leaves']} leaves, "
        f"{restored[0]['bytes'] / 1e6:.1f} MB a rank) in {restore_s:.1f} s")

    spent["e"] = time.perf_counter() - t_phase - sum(spent.values())
    # -- times -------------------------------------------------------------
    card = card_line()
    times = []
    with torch.no_grad():
        for case in ("decode", "prefill"):
            body = [cuda_ms(lambda r=r: (attn_body(case, r), ffn_body(case, r)), iters=5) for r in range(tp)]
            ffn = [cuda_ms(lambda r=r: ffn_body(case, r), iters=5) for r in range(tp)]
            whole = cuda_ms(lambda: (attn_whole(case), ffn_whole(case)), iters=5)
            ffn_whole_ms = cuda_ms(lambda: ffn_whole(case), iters=5)
            f = cfg.d_ff // tp
            bound = 3 * d * f * 2 / bw * 1e3  # the rank's three FFN weights read once
            times.append({"case": case, "rank_block_ms": body, "rank_ffn_ms": ffn, "sum_ms": sum(body),
                          "slowest_ms": max(body), "whole_block_ms": whole, "whole_ffn_ms": ffn_whole_ms,
                          "rank_ffn_bound_ms": bound})
            log(f"sharded model {case} [{card}]: each rank's block (attention + FFN) {[round(x, 4) for x in body]} ms, "
                f"FFN alone {[round(x, 4) for x in ffn]} ms (bound {bound:.4f} ms: its weights once at "
                f"{bw / 1e12:.2f} TB/s); sum over ranks {sum(body):.4f} ms vs the unsharded block {whole:.4f} ms "
                f"(FFN {ffn_whole_ms:.4f} ms); slowest rank {max(body):.4f} ms")
        # rank 0's FFN at decode, product by product, beside the whole FFN's:
        # each product's kernel ms, its plain version (the ``reference``
        # executors on the card), one torch.matmul and its byte bound
        parts = {tag: ffn_product_times(f_dec.reshape(-1, d), w, rt, plain_rt, bw, partial=tag == "rank 0")
                 for tag, w in (("rank 0", ranks[0]["mlp"]), ("unsharded", block["mlp"]))}
        log(f"sharded model decode FFN by product [{card}]: " + "; ".join(
            f"{tag} {p['shapes']}: gate {p['gate_ms']:.4f} ms (bn {p['gate_lanes']}; plain {p['gate_plain_ms']:.4f}, "
            f"torch.matmul {p['gate_library_ms']:.4f}, bound {p['gate_bound_ms']:.4f}), emitted plan "
            f"{p['emitted_plan_ms']:.4f} ms, w_down {p['w_down_ms']:.4f} ms (bk {p['w_down_bk']}, "
            f"{p['w_down_k_blocks']} K blocks; plain {p['w_down_plain_ms']:.4f}, torch.matmul "
            f"{p['w_down_library_ms']:.4f}, bound {p['w_down_bound_ms']:.4f})" for tag, p in parts.items()))
        head_ms = [cuda_ms(lambda r=r: head_body(h_dec, r), iters=10) for r in range(tp)]
        with plain_rt.use():
            head_plain_ms = cuda_ms(lambda: tfm.head_matmul(cfg, h_dec, heads[0], key=("plain", id(heads[0])),
                                                            vocab=v), iters=3, warmup=1)
        head_library_ms = cuda_ms(lambda: torch.matmul(h_dec, heads[0]), iters=10)
        head_bound_ms = (heads[0].numel() + h_dec.numel() + SM_ROWS * heads[0].shape[1]) * 2 / bw * 1e3
        with rt.use():
            head_whole_ms = cuda_ms(lambda: tfm.head_matmul(cfg, h_dec, lm_head), iters=10)
    log(f"sharded model head [{card}]: each rank's vocab slice at {SM_ROWS} rows {[round(x, 4) for x in head_ms]} ms "
        f"(rank 0's plain version {head_plain_ms:.4f} ms, torch.matmul {head_library_ms:.4f} ms, bound "
        f"{head_bound_ms:.4f} ms), sum {sum(head_ms):.4f} ms vs "
        f"the unsharded head {head_whole_ms:.4f} ms; no run across cards was made (the machine has one card): "
        "collectives are not timed")
    spent["times"] = time.perf_counter() - t_phase - sum(spent.values())
    log(f"sharded model: the phase {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    launches = {k: launches_ab[k] + launches_c[k] + launches_d[k] for k in launches_ab}
    del block, ranks, lm_head, heads
    free()
    return {"launches": launches, "launches_per_rank_ffn": per_rank[0], "rows": rows, "tp_checks": tp_checks,
            "kernel_rows": kernel_rows, "head_bit_equal": head_eq,
            "ce": [ce, ce_whole], "grad_rel_l2": grad_rel, "whole": {"loss": [loss_s, loss_u], "step_loss": step_loss,
            "grad_worst": d_rel[d_worst], "tokens_equal": same_tokens, "graph_captures": graph_s,
            "step_s": step_s, "mesh": mesh_desc}, "restore": restored, "times": times,
            "head_ms": head_ms, "head_whole_ms": head_whole_ms, "head_library_ms": head_library_ms,
            "head_plain_ms": head_plain_ms,
            "head_bound_ms": head_bound_ms, "ffn_parts": parts, "seconds": spent, "card": card}


def _grown(cache, rows: int):
    """A prefill cache (any of the named-tuple caches with a sequence dim
    1) grown to ``rows`` positions with zeros."""
    return type(cache)(*(None if c is None else torch_cat_pad(c, rows) for c in cache))


def torch_cat_pad(c, rows: int):
    import torch

    return torch.cat([c, c.new_zeros((c.shape[0], rows - c.shape[1], *c.shape[2:]))], 1)


def leaf_paths(tree, prefix: str = "") -> list:
    """The paths of a parameter tree's leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def ssm_rank_steps(ws, lcfg, x, caches=None):
    """Each model rank's Mamba2 local step (``ws`` the ranks' weights,
    ``lcfg`` a rank's config) on the one card, their gated-norm statistic
    summed over the ranks as ``tp_sum`` sums it: a first pass records each
    rank's fp32 sum of squares (on copies of the decode caches), the second
    runs every rank on their sum.  Returns the ranks' fp32 partial outputs
    and, per rank, its local step as a closure on that sum (for timing)."""
    import torch
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.runtime.runtime import tree_map

    def run(r, cache, norm_sum):
        if cache is None:
            return ssm_mod.ssm_fwd(ws[r], lcfg, x, norm_sum=norm_sum, partial=True)
        return ssm_mod.ssm_decode(ws[r], lcfg, x, cache, norm_sum=norm_sum, partial=True)[0]

    stats = []
    for r in range(len(ws)):
        run(r, None if caches is None else tree_map(lambda t: t.clone(), caches[r]),
            lambda ss: stats.append(ss) or ss)
    total = torch.stack(stats).sum(0)
    bodies = [lambda r=r: run(r, None if caches is None else caches[r], lambda ss: total) for r in range(len(ws))]
    return [b() for b in bodies], bodies


def one_rank_step(cfg, policy, rt, counted) -> dict:
    """``cfg``'s sharded ``accumulate_grads`` and one ``make_train_step``
    step on ``policy``'s mesh of one rank against the unsharded gradients,
    at SF_BATCH x SF_SEQ tokens.  fp32 parameters: the two paths differ
    only in the order of their sums (the vocab-parallel cross entropy's
    gradient formula is another than ``log_softmax``'s), which bf16
    roundings through 48 layers would amplify into the noise of bf16
    training itself; every leaf within GRAD_REL_L2."""
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import init_params
    from repro_torch.optim import OptConfig
    from repro_torch.parallel import sharding as S
    from repro_torch.train import step as TS

    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.float32, device="cuda")
    local = S.shard_tree(params, policy.param_pspecs(M.param_specs(cfg)), policy)
    srt = rt.replace(sharding=policy, plan_cache=rtm.PlanCache())
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SF_SEQ, global_batch=SF_BATCH, seed=0).batch_at(0)
    with srt.use(), no_plain_versions(f"sharded family (e) {cfg.name} step"):
        loss_s, grads_s, _ = counted(f"{cfg.name} grads", 0, lambda: TS.accumulate_grads(
            TS.make_loss_fn(cfg), cfg, local, batch, shards=tfm.shards_of(cfg)))
        loss_s = float(loss_s)
    with rt.replace(plan_cache=rtm.PlanCache()).use():
        loss_u, grads_u, _ = TS.accumulate_grads(TS.make_loss_fn(cfg), cfg, params, batch)
        loss_u = float(loss_u)
    rel = sorted(zip((_rel_l2(a, b) for a, b in zip(grads_s, grads_u)), leaf_paths(params)), reverse=True)
    del grads_s, grads_u
    with srt.use():
        step = TS.make_train_step(cfg, OptConfig(lr=1e-4, warmup_steps=1))
        t0 = time.perf_counter()
        _, _, m = counted(f"{cfg.name} step", 0, lambda: step(local, TS.init_train_state(cfg, local), batch))
        step_loss = float(m["loss"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    loss_rel = abs(loss_s - loss_u) / abs(loss_u)
    if not (loss_rel <= LOSS_REL and rel[0][0] <= GRAD_REL_L2 and abs(step_loss - loss_s) <= 1e-6 * abs(loss_s)):
        raise AssertionError(f"sharded family (e) {cfg.name}: loss {loss_s} vs {loss_u}, step loss {step_loss}, "
                             f"worst gradients {rel[:3]}")
    del params, local
    free()
    return {"loss": [loss_s, loss_u], "loss_rel": loss_rel, "grad_worst_leaves": rel[:3], "step_loss": step_loss,
            "step_s": step_s}


def sharded_family_phase(bw: float) -> dict:
    """The sharded families at full width on the one card, each model rank's
    local step run in turn under tensor parallel SM_TP (NCCL refuses two
    ranks on one card; a collective is a sum of the ranks' outputs here):

    (a) deepseek-v2-ReLU: layer 0 (MLA, the rank's 32 of 128 heads, plus the
        dense FFN, its gate columns fused on the kernel, the emitted plan,
        its ``w_down`` rows on the fp32 store) and layer 1 (MLA plus the
        MoE, 40 of 160 experts a rank, each a ``values`` plan and a planned
        ``w_down``; the decode branch's local step, every rank on all
        tokens, at SF_CAPACITY so neither side drops), at SM_ROWS decode
        rows over SM_PREFIX cached tokens (each rank's latent cache whole)
        and an SM_PREFILL-token prefill;
    (b) mamba2-780m: one layer, 12 of 48 heads a rank, the gated norm's
        statistic summed over the ranks, at decode and prefill;
    (c) zamba2-2.7b: one group, the shared block (8 of 32 heads, 2560 of
        10240 MLP columns a rank) then its six Mamba2 layers (20 of 80
        heads a rank), each sublayer's partials summed before the next;
    (d) qwen2-vl-72b-ReLU: one layer, 16 of 64 heads and 2 of 8 kv heads a
        rank, the FFN as in (a), at decode (text mode) and over the image
        prompt's M-RoPE positions;
    and for each the vocab-parallel LM head: SM_TP slices on side B, each
    launch splitting K as the whole head's does, their concatenation
    bit-equal to the whole head.  The ranks' outputs, summed, are held to
    the unsharded layer within REF_REL_L2, every rank's kernel launches to
    their plain versions;
    (e) on an NCCL group of one rank through ``make_local_mesh()``: the
        sharded engines of deepseek-v2-ReLU cut to SF_DSV2_LAYERS layers (a
        plain all-to-all payload: the int8 one rounds on a group of one
        too; at SF_CAPACITY, as the decode branch's slot lists are 4x the
        layer's capacity), mamba2 and zamba2 whole against the unsharded ones (greedy
        tokens equal, one graph capture), and mamba2's sharded
        ``accumulate_grads`` and train step (:func:`one_rank_step`) against
        the unsharded ones (zamba2's step, 64.16 GB, does not fit twice; a
        full-width deepseek-v2 step needs several cards).

    Launches are counted over every local step of (a)-(d) and (e)'s sharded
    runs, reset just before and read just after; each rank's launches per
    call are held to the path's.  Then each body is timed: each rank's ms,
    their sum and the slowest rank against the unsharded layer."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch import runtime as rtm
    from repro_torch.configs import get_config
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import hybrid as hyb
    from repro_torch.models import mla as mla_mod
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import Spec, init_params, rms_norm
    from repro_torch.parallel import sharding as S
    from repro_torch.serve.engine import ServeEngine

    dev, bf16, tp = torch.device("cuda"), torch.bfloat16, SM_TP
    t_phase, spent = time.perf_counter(), {}
    gen = torch.Generator(device=dev).manual_seed(26)
    rt = rtm.Runtime(backend="cuda", device="cuda")
    plain_rt = rt.replace(backend="reference")
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(bf16)
    split = lambda tree, specs, r: S.map_specs(lambda w, sp: _rank_slice(w, sp, tp, r), tree, _tp_specs(specs, tp))
    total = lambda parts: torch.stack([p.float() for p in parts]).sum(0).to(bf16)
    launches = {k: 0 for k in T.launch_counts()}
    per_call, checks, kernel_errs, families, heads = [], [], {}, {}, []

    def counted(tag, r, fn):
        """``fn()`` as rank ``r``'s main-path call, its launches added up."""
        torch.cuda.synchronize()
        before = T.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: n - before[k] for k, n in T.launch_counts().items() if n != before[k]}
        for k, n in got.items():
            launches[k] += n
        per_call.append((tag, r, got))
        return out

    def want_calls(tag, want):
        got = [(r, c) for t, r, c in per_call if t == tag]
        if len(got) != tp or any(c != want for _, c in got):
            raise AssertionError(f"sharded family {tag}: launches per rank {got}, expected {want}")

    def err(kernel, e):
        kernel_errs[kernel] = max(kernel_errs.get(kernel, 0.0), e)

    def hold(tag, got, want):
        rel = _rel_l2(got, want)
        if not (bool(torch.isfinite(got.float()).all()) and rel <= REF_REL_L2):
            raise AssertionError(f"sharded family {tag}: the ranks' outputs summed are {rel} relative L2 of the "
                                 f"unsharded layer (bound {REF_REL_L2})")
        checks.append({"case": tag, "rel_l2": rel})
        return rel

    def timed(tag, bodies, whole):
        """Each rank's body ms (its local steps in turn), their sum, the
        slowest rank and the unsharded layer's ms."""
        ms = [cuda_ms(lambda b=b: [f() for f in b], iters=3, warmup=1) for b in bodies]
        whole_ms = cuda_ms(whole, iters=3, warmup=1)
        families.setdefault("times", []).append({"case": tag, "rank_ms": ms, "sum_ms": sum(ms), "slowest_ms": max(ms),
                                                 "whole_ms": whole_ms})

    def head_check(fam, cfg, lm_head):
        """The vocab-parallel head at SM_ROWS decode rows: each rank's slice
        on side B (a ``values`` plan, a planned launch), held to its plain
        version; the concatenation bit-equal to the whole head."""
        h = rand(SM_ROWS, 1, cfg.d_model)
        hspec = _tp_specs({"lm_head": M.param_specs(cfg)["lm_head"]}, tp)["lm_head"]
        slices = [_rank_slice(lm_head, hspec, tp, r) for r in range(tp)]
        tag = f"{fam} head"
        with rt.use():
            logits = [counted(tag, r, lambda w=w: tfm.head_matmul(cfg, h, w, key=("lm_head", id(w)),
                                                                 vocab=cfg.vocab_size))
                      for r, w in enumerate(slices)]
            whole = tfm.head_matmul(cfg, h, lm_head)
        want_calls(tag, {"planner[values]": 1, "tensordash_matmul_planned": 1})
        with plain_rt.use():
            for r, (w, got) in enumerate(zip(slices, logits)):
                err("tensordash_matmul_planned", check_close(
                    f"{tag} rank {r} {list(w.shape)}", got,
                    tfm.head_matmul(cfg, h, w, key=("plain", id(w)), vocab=cfg.vocab_size)))
        if not torch.equal(torch.cat(logits, -1), whole):
            raise AssertionError(f"sharded family {tag}: the {tp} head slices are not bit-equal to the whole head")
        with rt.use():
            ms = [cuda_ms(lambda w=w: tfm.head_matmul(cfg, h, w, key=("lm_head", id(w)), vocab=cfg.vocab_size),
                          iters=10) for w in slices]
        with plain_rt.use():
            plain_ms = cuda_ms(lambda: tfm.head_matmul(cfg, h, slices[0], key=("plain", id(slices[0])),
                                                       vocab=cfg.vocab_size), iters=3, warmup=1)
        library_ms = cuda_ms(lambda: torch.matmul(h, slices[0]), iters=10)
        bound_ms = (slices[0].numel() + h.numel() + SM_ROWS * slices[0].shape[1]) * 2 / bw * 1e3
        heads.append({"family": fam, "slice": list(slices[0].shape), "block_rows": rt.lane(slices[0].shape[1]),
                      "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms})
        log(f"sharded family {tag}: {tp} slices {list(slices[0].shape)} side B (lanes "
            f"{rt.lane(slices[0].shape[1])}) at {SM_ROWS} rows: concatenation bit-equal to the whole head; "
            f"{[round(x, 4) for x in ms]} ms (plain {plain_ms:.4f}, torch.matmul {library_ms:.4f}, bound "
            f"{bound_ms:.4f} ms; rank 0 {ms[0] / library_ms:.2f}x torch.matmul, {bound_ms / ms[0]:.0%} of bound)")

    def attn_rank(w, specs, acfg, r):
        """Rank ``r``'s attention weights as the sharded model holds them:
        its slices, and the whole K/V where the kv heads do not divide the
        model axis (``attn_local``'s ``kv_index``)."""
        mine = split(w, specs, r)
        if not isinstance(acfg, mla_mod.MLAConfig) and tfm.attn_local(acfg, tp, r, dev)[1] is not None:
            mine.update(wk=w["wk"], wv=w["wv"])
        return mine

    def attn_ffn_layer(fam, cfg, block, *, moe=False, mrope=False):
        """One transformer layer's attention (MLA or GQA) and FFN (dense or
        MoE) under tensor parallel ``tp``, at decode and prefill."""
        acfg, tables, fwd, dec = tfm._attention(cfg)
        specs = tfm.block_specs(cfg, moe=moe)
        ranks = [attn_rank(block["attn"], specs["attn"], acfg, r) for r in range(tp)]
        if cfg.use_mla:
            lacfg = dataclasses.replace(acfg, num_heads=acfg.num_heads // tp)
            kw = lambda r: {"partial": True}
        else:
            lacfg = tfm.attn_local(acfg, tp, 0, dev)[0]
            kw = lambda r: {"partial": True, "kv_index": tfm.attn_local(acfg, tp, r, dev)[1]}
        mcfg = tfm.moe_config(cfg)
        e_local = cfg.num_experts // tp if moe else 0
        if moe:
            mine = [{"router": block["mlp"]["router"], **{k: block["mlp"][k][r * e_local:(r + 1) * e_local]
                                                           for k in ("w_gate", "w_up", "w_down")}} for r in range(tp)]
        else:
            mine = [split({"mlp": block["mlp"]}, {"mlp": specs["mlp"]}, r)["mlp"] for r in range(tp)]
        # the decode rows' prefix (text positions), then one step; the prefill
        # over arange or, under M-RoPE, the image prompt's positions
        pos_prefix = torch.arange(SM_PREFIX, device=dev)
        if mrope:
            pos_pre = torch.from_numpy(vl_positions(1)).to(dev)
            pos_prefix = pos_prefix.reshape(1, 1, -1).expand(SM_ROWS, 3, -1)  # text: one position in all streams
        else:
            pos_pre = torch.arange(SM_PREFILL, device=dev)
        s_pre = pos_pre.shape[-1]
        x_prefix, x_dec = rand(SM_ROWS, SM_PREFIX, cfg.d_model), rand(SM_ROWS, 1, cfg.d_model)
        x_pre, f_dec, f_pre = rand(1, s_pre, cfg.d_model), rand(SM_ROWS, 1, cfg.d_model), rand(1, s_pre, cfg.d_model)
        pos_dec = torch.full((SM_ROWS,), SM_PREFIX, device=dev)
        rope_prefix, rope_pre = tables(acfg, pos_prefix), tables(acfg, pos_pre)
        rope_dec = tables(acfg, attn.decode_positions(pos_dec, SM_ROWS, dev, mrope=mrope))
        with torch.no_grad():
            whole_cache = _grown(fwd(block["attn"], acfg, x_prefix, pos_prefix, rope_prefix, return_cache=True)[1],
                                 SM_PREFIX + 8)
            rank_caches = [_grown(fwd(ranks[r], lacfg, x_prefix, pos_prefix, rope_prefix, return_cache=True,
                                      **kw(r))[1], SM_PREFIX + 8) for r in range(tp)]

        def attn_body(case, r):
            if case == "decode":
                return dec(ranks[r], lacfg, x_dec, rank_caches[r], pos_dec, rope_dec, **kw(r))[0]
            return fwd(ranks[r], lacfg, x_pre, pos_pre, rope_pre, **kw(r))

        def attn_whole(case):
            if case == "decode":
                return dec(block["attn"], acfg, x_dec, whole_cache, pos_dec, rope_dec)[0]
            return fwd(block["attn"], acfg, x_pre, pos_pre, rope_pre)

        def ffn_body(case, r, run_rt=rt):
            f = f_dec if case == "decode" else f_pre
            if moe:
                return moe_mod.decode_local_step(mcfg, r, tp, mine[r], f.reshape(-1, cfg.d_model),
                                                 rt=run_rt).reshape(f.shape)
            return tfm.mlp_fwd(mine[r], cfg, f, rt=run_rt, partial=True)

        shared = lambda f: moe_mod._shared_ffn(mcfg, block["mlp"]["shared"], f) if moe and mcfg.num_shared_experts \
            else 0.0

        def ffn_whole(case):
            f = f_dec if case == "decode" else f_pre
            if moe:
                return moe_mod.moe_ffn(block["mlp"], mcfg, f, rt=rt, seq_sharded=case != "decode")
            return tfm.mlp_fwd(block["mlp"], cfg, f, rt=rt)

        ffn_want = ({"planner[values]": e_local, "tensordash_matmul_planned": e_local} if moe else
                    {"tensordash_matmul_fused": 1, "planner[emitted]": 1, "tensordash_matmul_planned": 1})
        with torch.no_grad(), no_plain_versions(f"sharded family {fam}"):
            for case in ("decode", "prefill"):
                atts = [counted(f"{fam} attn {case}", r, lambda r=r: attn_body(case, r)) for r in range(tp)]
                ffns = [counted(f"{fam} ffn {case}", r, lambda r=r: ffn_body(case, r)) for r in range(tp)]
                want_calls(f"{fam} ffn {case}", ffn_want)
                f = f_dec if case == "decode" else f_pre
                hold(f"{fam} attention {case}", total(atts), attn_whole(case))
                hold(f"{fam} {'moe' if moe else 'ffn'} {case}", (total(ffns) + shared(f)).to(bf16), ffn_whole(case))
        with torch.no_grad():  # every rank's launches against their plain versions
            for case in ("decode", "prefill"):
                f = f_dec if case == "decode" else f_pre
                for r in range(tp):
                    if moe:  # the rank's expert products on the inputs its routing gave them
                        seen, expert_ffn = [], moe_mod._expert_ffn
                        moe_mod._expert_ffn = lambda c, xe, *w, rt=None: (seen.append((xe, *w)),
                                                                          expert_ffn(c, xe, *w, rt=rt))[1]
                        try:
                            ffn_body(case, r)
                        finally:
                            moe_mod._expert_ffn = expert_ffn
                        e = check_close(f"{fam} moe {case} rank {r} ({e_local} experts' w_down)",
                                        expert_ffn(mcfg, *seen[0], rt=rt), expert_ffn(mcfg, *seen[0], rt=plain_rt))
                        err("planner[values]", 0.0)
                        err("tensordash_matmul_planned", e)
                    else:
                        c = tp_ffn_check(f"{fam} {case} rank {r}", mine[r], f.reshape(-1, cfg.d_model), rt, plain_rt)
                        err("tensordash_matmul_fused", c["gate_max_abs_err"])
                        err("tensordash_matmul_planned", c["w_down_max_abs_err"])
                        err("planner[emitted]", 0.0)
                        families.setdefault("ffn_shapes", []).append({"family": fam, "case": case, **c})
            if not moe:  # rank 0's FFN products at decode, one by one
                families.setdefault("ffn_parts", {})[fam] = ffn_product_times(
                    f_dec.reshape(-1, cfg.d_model), mine[0], rt, plain_rt, bw, partial=True)
            for case in ("decode", "prefill"):
                timed(f"{fam} {'moe' if moe else 'ffn'} layer {case}",
                      [[lambda r=r: attn_body(case, r), lambda r=r: ffn_body(case, r)] for r in range(tp)],
                      lambda: (attn_whole(case), ffn_whole(case)))

    # -- (a) deepseek-v2-ReLU: MLA with the dense FFN, MLA with the MoE --------
    cfg = dataclasses.replace(get_config(DSV2_ARCH), activation="relu", capacity_factor=SF_CAPACITY)
    block0 = init_params(tfm.block_specs(cfg), seed=5, dtype=bf16, device="cuda")
    attn_ffn_layer("dsv2 layer 0", cfg, block0)
    del block0
    free()
    block1 = init_params(tfm.block_specs(cfg, moe=True), seed=6, dtype=bf16, device="cuda")
    expert_gb = sum(block1["mlp"][k].numel() * 2 for k in ("w_gate", "w_up", "w_down")) / 1e9
    attn_ffn_layer("dsv2 layer 1", cfg, block1, moe=True)
    del block1
    free()
    head_check("dsv2", cfg, (torch.randn(cfg.d_model, cfg.vocab_size, generator=gen, device=dev)
                             * cfg.d_model**-0.5).to(bf16))
    free()
    spent["a"] = time.perf_counter() - t_phase

    # -- (b) and (c): mamba2's layer, zamba2's group -------------------------
    for fam, arch in (("mamba2", SSM_ARCH), ("zamba2", HYBRID_ARCH)):
        cfg = get_config(arch)
        scfg = hyb.ssm_config(cfg)
        lcfg = dataclasses.replace(scfg, tp=tp)
        n_layers = 1 if cfg.family == "ssm" else cfg.attn_every
        lspecs = {"ln": Spec((cfg.d_model,), init="ones"), "ssm": ssm_mod.ssm_specs(scfg)}
        layers = [init_params(lspecs, seed=7 + i, dtype=bf16, device="cuda") for i in range(n_layers)]
        lranks = [[split(p["ssm"], lspecs["ssm"], r) for r in range(tp)] for p in layers]
        x = rand(1, SM_PREFILL, cfg.d_model)
        bodies = [[] for _ in range(tp)]
        with torch.no_grad(), no_plain_versions(f"sharded family {fam}"):
            if cfg.family == "hybrid":
                sspecs = hyb.hybrid_specs(cfg)["shared"]
                shared = init_params(sspecs, seed=13, dtype=bf16, device="cuda")
                acfg = hyb.shared_attn_config(cfg)
                sranks = [{**split(shared, sspecs, r), "attn": attn_rank(shared["attn"], sspecs["attn"], acfg, r)}
                          for r in range(tp)]
                lacfg = tfm.attn_local(acfg, tp, 0, dev)[0]
                positions = torch.arange(SM_PREFILL, device=dev)
                rope = attn.rope_tables(acfg, positions)
                h, h0 = x, x
                xin = hyb._shared_in(shared, h, h0)
                for r in range(tp):
                    bodies[r].append(lambda r=r: attn.attention_fwd(
                        sranks[r]["attn"], lacfg, xin, positions, rope, partial=True,
                        kv_index=tfm.attn_local(acfg, tp, r, dev)[1]))
                a = total([b[0]() for b in bodies])
                hold(f"{fam} shared attention", a, attn.attention_fwd(shared["attn"], acfg, xin, positions, rope))
                h = h + a
                m = rms_norm(h, shared["norm_mlp"])
                for r in range(tp):
                    bodies[r].append(lambda r=r, m=m: hyb.shared_mlp_local(sranks[r]["mlp"], cfg, m, partial=True))
                a = total([b[1]() for b in bodies])
                hold(f"{fam} shared MLP", a, hyb.shared_mlp_local(shared["mlp"], cfg, m))
                h = h + a
                whole = lambda: hyb._group_fwd({"shared": shared}, layers, cfg, x, x, positions, rope)
            else:
                h, whole = x, lambda: x + ssm_mod.ssm_fwd(layers[0]["ssm"], scfg, rms_norm(x, layers[0]["ln"]))
            for i, (p, ws) in enumerate(zip(layers, lranks)):
                xn = rms_norm(h, p["ln"])
                outs, steps = ssm_rank_steps(ws, lcfg, xn)
                for r in range(tp):
                    bodies[r].append(steps[r])
                if cfg.family == "hybrid":  # each sublayer on the same input, then the group
                    hold(f"{fam} Mamba2 layer {i}", total(outs), ssm_mod.ssm_fwd(p["ssm"], scfg, xn))
                h = h + total(outs)
            hold(f"{fam} {'group' if cfg.family == 'hybrid' else 'layer'} prefill", h, whole())
            if cfg.family == "ssm":  # one decode step of SM_ROWS rows after an SM_PREFIX-token prefix
                xp, xd = rand(SM_ROWS, SM_PREFIX, cfg.d_model), rand(SM_ROWS, 1, cfg.d_model)
                # each rank's caches of the prefix: its heads' conv_x channels
                # and states, B and C's tails whole (the norm is after them)
                caches = [ssm_mod.ssm_fwd(lranks[0][r], lcfg, xp, return_cache=True)[1] for r in range(tp)]
                whole_cache = ssm_mod.ssm_fwd(layers[0]["ssm"], scfg, xp, return_cache=True)[1]
                outs, dsteps = ssm_rank_steps(lranks[0], lcfg, xd, caches)
                hold(f"{fam} layer decode", total(outs),
                     ssm_mod.ssm_decode(layers[0]["ssm"], scfg, xd, whole_cache)[0])
                timed(f"{fam} layer decode", [[s] for s in dsteps],
                      lambda: ssm_mod.ssm_decode(layers[0]["ssm"], scfg, xd, whole_cache))
            timed(f"{fam} {'group' if cfg.family == 'hybrid' else 'layer'} prefill", bodies, whole)
        families[fam] = {"heads_per_rank": lcfg.num_heads, "channels_per_rank": lcfg.d_inner}
        lm_head = (torch.randn(cfg.d_model, cfg.vocab_size, generator=gen, device=dev) * cfg.d_model**-0.5).to(bf16)
        head_check(fam, cfg, lm_head)
        del layers, lranks, lm_head, bodies
        free()
    spent["b_c"] = time.perf_counter() - t_phase - sum(spent.values())

    # -- (d) qwen2-vl-72b-ReLU: one layer over M-RoPE positions ----------------
    cfg = dataclasses.replace(get_config(VL_ARCH), activation="relu")
    block = init_params(tfm.block_specs(cfg), seed=17, dtype=bf16, device="cuda")
    attn_ffn_layer("qwen2-vl layer", cfg, block, mrope=True)
    del block
    free()
    head_check("qwen2-vl", cfg, (torch.randn(cfg.d_model, cfg.vocab_size, generator=gen, device=dev)
                                 * cfg.d_model**-0.5).to(bf16))
    free()
    spent["d"] = time.perf_counter() - t_phase - sum(spent.values())
    launches_ad = dict(launches)

    # -- (e) the sharded engines and mamba2's step on an NCCL group of one -----
    engines = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            policy = S.ShardingPolicy(mesh=make_local_mesh())
            for fam, cfg in (("dsv2", dataclasses.replace(get_config(DSV2_ARCH), activation="relu",
                                                         num_layers=SF_DSV2_LAYERS, moe_a2a_quant=False,
                                                         capacity_factor=SF_CAPACITY)),
                             ("mamba2", get_config(SSM_ARCH)), ("zamba2", get_config(HYBRID_ARCH))):
                params = init_params(M.param_specs(cfg), seed=0, dtype=bf16, device="cuda")
                prompts = torch.randint(0, cfg.vocab_size, (SM_REQUESTS, SM_PROMPT), generator=gen, device=dev).cpu()
                local = S.shard_tree(params, policy.param_pspecs(M.param_specs(cfg)), policy)
                srt = rt.replace(sharding=policy, plan_cache=rtm.PlanCache())

                def serve(p, run_rt):
                    eng = ServeEngine(p, cfg, slots=SM_REQUESTS, max_len=SM_PROMPT + SM_NEW, chunk=SM_CHUNK,
                                      rt=run_rt)
                    rids = [eng.submit(q, max_new=SM_NEW) for q in prompts]
                    out = eng.run()
                    return [out[i] for i in rids], eng.stats()["decode_graph_captures"]

                with srt.use(), torch.no_grad(), no_plain_versions(f"sharded family (e) {fam} engine"):
                    toks_s, graph_s = counted(f"{fam} engine", 0, lambda: serve(local, srt))
                toks_u, _ = serve(params, rt.replace(plan_cache=rtm.PlanCache()))
                if toks_s != toks_u or graph_s != 1:
                    raise AssertionError(f"sharded family (e) {fam}: tokens equal {toks_s == toks_u}, graph captures "
                                         f"{graph_s}")
                engines[fam] = {"tokens_equal": True, "graph_captures": graph_s, "requests": SM_REQUESTS,
                                "new_tokens": SM_NEW}
                del params, local
                free()
                if fam == "mamba2":
                    engines["mamba2_step"] = one_rank_step(cfg, policy, rt, counted)
            mesh_desc = (tuple(policy.mesh.shape), tuple(policy.mesh.mesh_dim_names), dist.get_backend())
        finally:
            dist.destroy_process_group()
    spent["e"] = time.perf_counter() - t_phase - sum(spent.values())
    card = card_line()
    for t in families["times"]:
        log(f"sharded family {t['case']} [{card}]: each rank {[round(x, 4) for x in t['rank_ms']]} ms, sum "
            f"{t['sum_ms']:.4f} ms, slowest {t['slowest_ms']:.4f} ms vs the unsharded layer {t['whole_ms']:.4f} ms")
    for fam, q in families["ffn_parts"].items():
        log(f"sharded family {fam} rank 0 decode FFN by product [{card}]: {q['shapes']}: gate {q['gate_ms']:.4f} ms "
            f"(lanes {q['gate_lanes']}; plain {q['gate_plain_ms']:.4f}, torch.matmul {q['gate_library_ms']:.4f}, "
            f"bound {q['gate_bound_ms']:.4f}), emitted plan {q['emitted_plan_ms']:.4f} ms, w_down {q['w_down_ms']:.4f} "
            f"ms (bk {q['w_down_bk']}, {q['w_down_k_blocks']} K blocks; plain {q['w_down_plain_ms']:.4f}, "
            f"torch.matmul {q['w_down_library_ms']:.4f}, bound {q['w_down_bound_ms']:.4f})")
    for c in families.get("ffn_shapes", []):
        if c["case"] == "decode":
            log(f"sharded family {c['family']} FFN: each rank's gate {c['gate_shape']} (lanes {c['gate_lanes']}) "
                f"and w_down (bk {c['w_down_bk']}) against their plain versions: max abs err "
                f"{c['gate_max_abs_err']:.3e} / {c['w_down_max_abs_err']:.3e}")
    log("sharded family: every rank's launches against their plain versions, max abs err by kernel "
        + ", ".join(f"{k} {e:.3e}" for k, e in kernel_errs.items()))
    log("sharded family: " + "; ".join(f"{c['case']} {c['rel_l2']:.3e}" for c in checks)
        + f" relative L2 of the unsharded layer (bound {REF_REL_L2:.3e}); deepseek-v2 layer 1's "
        f"{expert_gb:.2f} GB of experts, 40 a rank; mamba2 {families['mamba2']['heads_per_rank']} and zamba2 "
        f"{families['zamba2']['heads_per_rank']} Mamba2 heads a rank")
    log(f"sharded family (e): NCCL group of one rank, make_local_mesh() {mesh_desc[0]} over {mesh_desc[1]}: "
        + "; ".join(f"{fam} engine tokens equal the unsharded engine's ({e['requests']} requests, "
                    f"{e['new_tokens']} new tokens, decode graph captured {e['graph_captures']}x)"
                    for fam, e in engines.items() if fam != "mamba2_step")
        + f"; mamba2 (fp32) sharded loss {engines['mamba2_step']['loss'][0]:.6f} vs "
        f"{engines['mamba2_step']['loss'][1]:.6f} (relative {engines['mamba2_step']['loss_rel']:.3e}), worst "
        f"gradients relative L2 {[(float(f'{r:.3e}'), n) for r, n in engines['mamba2_step']['grad_worst_leaves']]} "
        f"(bound {GRAD_REL_L2:.3e}), one step "
        f"{engines['mamba2_step']['step_s']:.2f} s; no run "
        "across cards was made (the machine has one card): collectives are not timed")
    log(f"sharded family: launches {dict((k, n) for k, n in launches.items() if n)}; the phase "
        f"{time.perf_counter() - t_phase:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    kernel_rows = [{"kernel": k, "main_path": False, "max_abs_err": e} for k, e in kernel_errs.items()]
    return {"launches": launches, "launches_local_steps": launches_ad, "checks": checks, "kernel_rows": kernel_rows,
            "heads": heads, "families": families, "engines": engines, "mesh": mesh_desc, "seconds": spent,
            "card": card}


# ---------------------------------------------------------------------------
# sharded dst phase: dynamic sparse training on a mesh
# ---------------------------------------------------------------------------

#: the sharded dst phase: (a) deepseek-7b-ReLU's layer (attention and FFN)
#: and LM head at full width, fp32, under tensor parallel SM_TP and a (2, 2)
#: data x model cut, each rank's slices in turn, masks at a runtime of
#: DST_BLOCK-square blocks (``w_down``'s rows 11008 / 4 = 2752 a rank cut
#: through them; the head's 102400 / 4 = 25600 columns do not), the summed
#: partial scores held to the whole tensors' within DST_SCORE_REL of each
#: block; (b) ``make_train_step(dynamic_sparsity=)`` of qwen3-4b-ReLU cut to
#: LAUNCH_LAYERS layers, DST_BATCH x DST_SEQ tokens, DST_STEPS steps with a
#: refresh every 2 to 50%, on an NCCL group of one rank against the
#: unsharded run
DST_BLOCK, DST_SCORE_REL = 128, 1e-5
DST_BATCH, DST_SEQ, DST_STEPS = 2, 256, 6


def spec_tree_map(fn, tree):
    """``fn`` over the leaves (``Spec``s) of a spec tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: spec_tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_tree_map(fn, v) for v in tree]
    return fn(tree)


def dst_weights(shape, block, gen, dev):
    """fp32 ``[*lead, K, N]`` whose block L1 masses are apart: one seeded
    ``[bk, bn]`` tile scaled per block by a permutation of ``0.5 + i /
    blocks``, so two blocks' masses differ by at least ``1 / blocks`` of
    the tile's (4e-5 relative for the head's 25600 blocks), far above fp32
    summation noise: masks selected from two sums of the same blocks agree
    unless the sums are wrong, not by luck."""
    import math

    import torch

    *lead, k, n = shape
    bk, bn = block
    count = math.prod(lead) * (k // bk) * (n // bn)
    tile = torch.randn(bk, bn, generator=gen, device=dev)
    scale = 0.5 + torch.randperm(count, generator=gen, device=dev).float() / count
    scale = scale.reshape(*lead, k // bk, 1, n // bn, 1)
    return (tile.reshape(*([1] * len(lead)), 1, bk, 1, bn) * scale).reshape(*lead, k, n)


def rank_index_of(sizes: dict, coord: dict):
    """``index_of`` (spec entry -> ``(count, index)``) of the rank at mesh
    coordinates ``coord``, row-major over an entry's axes, as
    ``sharding.local_shard`` cuts: no process group needed."""
    def at(entry):
        axes = entry if isinstance(entry, tuple) else (entry,)
        count, index = 1, 0
        for a in axes:
            count, index = count * sizes[a], index * sizes[a] + coord[a]
        return count, index
    return at


def dst_run(cfg, policy, dcfg, ocfg, batches, tag: str) -> dict:
    """``make_train_step(dynamic_sparsity=)`` on fresh fp32 weights (seed 0)
    under ``policy`` (``None``: unsharded): per step the loss and seconds,
    per refresh the report, the masks and the controller's host seconds."""
    import torch
    from repro_torch import runtime as rtm
    from repro_torch import sparse_train as SP
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params
    from repro_torch.train import step as TS

    rt = rtm.Runtime(backend="cuda", device="cuda", sharding=policy)
    out = {"loss": [], "step_s": [], "refreshes": []}
    with rt.use(), no_plain_versions(f"{tag}: the dynamic sparse train step"):
        params = init_params(M.param_specs(cfg), seed=0, dtype=torch.float32, device="cuda", policy=policy)
        specs = policy.param_pspecs(M.param_specs(cfg)) if policy is not None else None
        ctrl = SP.DynamicSparsityController(dcfg, params, specs=specs)
        step = TS.make_train_step(cfg, ocfg, dynamic_sparsity=ctrl, guard_nonfinite=True)
        opt = TS.init_train_state(cfg, params)
        masks = ctrl.masks()
        out["units"] = len(ctrl.units)
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch, masks)
            out["loss"].append(float(m["loss"]))
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            if int(m["nonfinite"]):
                raise AssertionError(f"{tag}: step {i} was not finite")
            if ctrl.should_update(i):
                out["score_numel"] = sum(x.numel() for t in ("dst_w_scores", "dst_g_scores")
                                         for x in m[t].values())
                t0 = time.perf_counter()
                rep = ctrl.update(i, m["dst_w_scores"], m["dst_g_scores"])
                masks = ctrl.masks()
                out["refreshes"].append({"step": i, "pruned": rep["pruned"], "regrown": rep["regrown"],
                                         "sparsity": rep["sparsity"], "edit_ms": rep["edit_ms"],
                                         "update_s": time.perf_counter() - t0,
                                         "masks": {p: u.mask.copy() for p, u in ctrl.units.items()}})
        out["density"] = float(m["dst_density"])
        del params, opt, m, step, ctrl
    free()
    return out


def sharded_dst_phase(bw: float) -> dict:
    """Dynamic sparse training on a mesh, its ranks' work on the one card
    (NCCL refuses two ranks on one card):

    (a) full-width deepseek-7b-ReLU's attention and FFN weights and its LM
        head, fp32, seeded with block masses apart (:func:`dst_weights`), and
        a seeded gradient-shaped tree; a controller at DST_BLOCK-square
        blocks refreshed once to 50% from the whole tensors' scores.  Under
        tensor parallel SM_TP and a (2, 2) data x model cut, for each rank
        in turn: the global shapes from its slices (``leaf_cuts``) equal the
        units' shapes; its slices masked by its slices of the masks, put
        together, bit-equal to the masked whole; its partial weight and
        gradient scores, summed over the ranks holding distinct slices,
        within DST_SCORE_REL of each block's whole score, and the masks a
        second controller selects from the sums equal the first's.  Then
        each rank's side-B ``values`` plans of its masked ``w_down`` rows and
        LM-head slice at the runtime's fit to the slice (bit-equal to the
        plain chain), their skipped share beside the slice's mask
        sparsity, and under tensor parallel its planned ``w_down`` launch at
        SM_ROWS decode rows against its plain version, with ms,
        ``torch.matmul`` ms and the byte bound;
    (b) qwen3-4b-ReLU cut to LAUNCH_LAYERS layers, fp32 (so the two runs'
        block scores differ by fp32 rounding alone; bf16 rounding would be
        wider than the smallest gaps at a selection's cut), through
        ``make_train_step(dynamic_sparsity=)`` under a ``(1, 1)`` mesh on an
        NCCL group of one rank and unsharded: at every refresh the masks and
        the counts equal, every loss within ``LOSS_REL``; the step and
        refresh seconds, and the score all-reduce's ms on the group.

    Launches are counted over (a)'s plans and launches and (b)'s sharded
    run, reset just before each and read just after."""
    import dataclasses
    import types

    import torch
    import torch.distributed as dist
    from repro_torch import runtime as rtm
    from repro_torch import sparse_train as SP
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ref, tensordash_spmm as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding as S
    from repro_torch.runtime.plan import _fit_block

    dev = torch.device("cuda")
    t_phase, spent = time.perf_counter(), {}
    gen = torch.Generator(device=dev).manual_seed(27)
    cfg = dataclasses.replace(get_config("deepseek-7b"), activation="relu")
    rt = rtm.Runtime(backend="cuda", device="cuda", bm=DST_BLOCK, bk=DST_BLOCK, bn=DST_BLOCK)
    plain_rt = rt.replace(backend="reference")
    block_of = lambda shape: (_fit_block(DST_BLOCK, shape[-2]), _fit_block(DST_BLOCK, shape[-1]))
    layer = {k: v for k, v in tfm.block_specs(cfg).items() if k in ("attn", "mlp")}
    decl = {"layers": [layer], "lm_head": M.param_specs(cfg)["lm_head"]}
    whole = spec_tree_map(lambda s: dst_weights(s.shape, block_of(s.shape), gen, dev), decl)
    grads = spec_tree_map(lambda s: torch.randn(s.shape, generator=gen, device=dev) * 1e-3, decl)
    ctrl = SP.DynamicSparsityController(SP.DynamicSparsityConfig(target=0.5, begin=0, end=1, update_every=1),
                                        whole, rt=rt)
    spec = ctrl.spec()
    ctrl.update(1, SP.block_scores(whole, spec), SP.block_scores(grads, spec))
    masks = ctrl.masks()
    masked = SP.apply_block_masks(spec_tree_map(torch.clone, whole), masks, spec)
    want = {"w0": SP.block_scores(whole, spec), "g0": SP.block_scores(grads, spec),
            "w1": SP.block_scores(masked, spec)}
    units = {p: (*u.lead, u.kb * u.block[0], u.nb * u.block[1]) for p, u in ctrl.units.items()}
    log(f"sharded dst (a): deepseek-7b relu's layer and LM head at full width, fp32: {len(units)} units at "
        f"{DST_BLOCK} x {DST_BLOCK} blocks, one refresh to sparsity {ctrl.sparsity():.4f}")

    def rel_err(got: dict, ref_: dict) -> float:
        worst = 0.0
        for p, w in ref_.items():
            g = got[p]
            nz = w != 0
            if not torch.equal(g[~nz], w[~nz]):
                raise AssertionError(f"sharded dst (a): {p}: a block whose whole score is 0 sums to nonzero")
            worst = max(worst, float(((g[nz] - w[nz]).abs() / w[nz]).max()) if nz.any() else 0.0)
        return worst

    meshes, effects = [], []
    launches_a = dict.fromkeys(T.launch_counts(), 0)  # (a)'s plans and launches, not their checks
    for shape in ((1, SM_TP), (2, 2)):
        sizes = dict(zip(("data", "model"), shape))
        pspecs = S.param_pspecs(decl, types.SimpleNamespace(axis_names=("data", "model"), shape=sizes))
        spec_of = SP.stacked_leaves(pspecs)
        sums = {k: {p: torch.zeros_like(w) for p, w in want["w0"].items()} for k in ("w0", "g0", "w1")}
        together = S.map_specs(lambda x, _: torch.zeros_like(x), whole, pspecs)
        for d in range(shape[0]):
            for m in range(shape[1]):
                coord = {"data": d, "model": m}
                index_of = rank_index_of(sizes, coord)
                cut = lambda tree: S.map_specs(lambda x, sp: S.shard_slice(x, sp, index_of).clone(
                    memory_format=torch.contiguous_format), tree, pspecs)
                local, glocal = cut(whole), cut(grads)
                cuts = {p: c for p, c in SP.leaf_cuts(local, pspecs, index_of).items() if p in spec}
                if {p: c.shape for p, c in cuts.items()} != units:
                    raise AssertionError(f"sharded dst (a) {shape} rank {coord}: global shapes from the slices "
                                         f"{ {p: c.shape for p, c in cuts.items()} } differ from the units'")
                # a rank counts a leaf's partials where it is the first of the ranks holding its slice
                named = lambda sp: {a for e in sp if e for a in (e if isinstance(e, tuple) else (e,))}
                owner = {p: all(coord[a] == 0 for a in sizes if a not in named(spec_of[p].leaves[0]))
                         for p in spec}
                parts = {"w0": SP.block_scores(local, spec, cuts), "g0": SP.block_scores(glocal, spec, cuts)}
                SP.apply_block_masks(local, masks, spec, cuts)
                parts["w1"] = SP.block_scores(local, spec, cuts)
                for k, part in parts.items():
                    for p, x in part.items():
                        if owner[p]:
                            sums[k][p] += x
                for dst, src, sp in zip(tree_leaves(together), tree_leaves(local), S.spec_leaves(pspecs)):
                    S.shard_slice(dst, sp, index_of).copy_(src)
                # the TensorDash effect on the rank's masked slices
                wd, head = local["layers"][0]["mlp"]["w_down"], local["lm_head"]
                row = {"mesh": list(shape), "rank": dict(coord)}
                for name, w, path in (("w_down", wd, "['layers']['mlp']['w_down']"), ("lm_head", head, "['lm_head']")):
                    x = torch.randn(SM_ROWS, w.shape[0], generator=gen, device=dev)
                    frt = rt.fit(x.shape, w.shape)
                    before = T.launch_counts()
                    plan = frt.plan(w, side="B")
                    y = rt.matmul(x, w, plan=plan, side="B") if name == "w_down" and shape[0] == 1 else None
                    torch.cuda.synchronize()
                    for k, n in T.launch_counts().items():
                        launches_a[k] += n - before[k]
                    want_plan = ref.plan_blocks_csr_ref(w.T, frt.bn, frt.bk)
                    if not all(torch.equal(a, b) for a, b in zip((plan.nnz, plan.idx, *plan.workqueue()), want_plan)):
                        raise AssertionError(f"sharded dst (a) {shape} rank {coord} {name}: the values plan differs "
                                             "from the plain chain's")
                    u = ctrl.units[path]
                    off = cuts[path].offsets[-2:]
                    emask = SP.shard_block_mask(masks[path].reshape(u.kb, u.nb), u.block, off, tuple(w.shape))
                    row[name] = {"shape": list(w.shape), "plan_block": [frt.bn, frt.bk],
                                 "mask_block": list(u.block), "skipped": plan.skipped_fraction(),
                                 "mask_sparsity": 1.0 - float(emask.float().mean()),
                                 "cuts_blocks": any(o % b or s % b for o, s, b in zip(off, w.shape, u.block))}
                    if y is not None:
                        err = check_close(f"sharded dst (a) rank {coord} w_down slice", y,
                                          plain_rt.matmul(x, w, plan=plan, side="B"))
                        eff = int(plan.nnz.sum())
                        row[name].update(
                            max_abs_err=err, ms=cuda_ms(lambda: rt.matmul(x, w, plan=plan, side="B")),
                            plain_ms=cuda_ms(lambda: plain_rt.matmul(x, w, plan=plan, side="B"), iters=3, warmup=1),
                            library_ms=cuda_ms(lambda: torch.matmul(x, w)),
                            bound_ms=(x.numel() + eff * frt.bn * frt.bk + SM_ROWS * w.shape[1]) * 4 / bw * 1e3,
                            bound_by="bytes")
                effects.append(row)
                del local, glocal
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(together), tree_leaves(masked)))
        if not same:
            raise AssertionError(f"sharded dst (a) {shape}: the ranks' masked slices put together differ from the "
                                 "masked whole")
        errs = {k: rel_err(sums[k], want[k]) for k in sums}
        if max(errs.values()) > DST_SCORE_REL:
            raise AssertionError(f"sharded dst (a) {shape}: summed partial scores off the whole's by {errs} "
                                 f"(bound {DST_SCORE_REL})")
        again = SP.DynamicSparsityController(SP.DynamicSparsityConfig(target=0.5, begin=0, end=1, update_every=1),
                                             whole, rt=rt)
        again.update(1, sums["w0"], sums["g0"])
        diff = [p for p in spec if not (again.units[p].mask == ctrl.units[p].mask).all()]
        if diff:
            raise AssertionError(f"sharded dst (a) {shape}: masks from the summed scores differ at {diff}")
        meshes.append({"mesh": list(shape), "bit_equal": same, "score_rel_err": errs})
        del together, sums, again
        free()
    for m_ in meshes:
        log(f"sharded dst (a) mesh {tuple(m_['mesh'])}: the ranks' masked slices put together bit-equal to the masked "
            f"whole; summed partial scores' largest relative error per block: weights before the refresh "
            f"{m_['score_rel_err']['w0']:.3e}, gradients {m_['score_rel_err']['g0']:.3e}, masked weights "
            f"{m_['score_rel_err']['w1']:.3e} (bound {DST_SCORE_REL:.0e}); masks selected from the sums equal")
    for e in effects:
        log(f"sharded dst (a) mesh {tuple(e['mesh'])} rank {e['rank']}: " + "; ".join(
            f"{n} {e[n]['shape']} plan blocks {e[n]['plan_block']} (mask {e[n]['mask_block']}"
            f"{', cut through' if e[n]['cuts_blocks'] else ''}) skipped {e[n]['skipped']:.4f} vs mask sparsity "
            f"{e[n]['mask_sparsity']:.4f}" for n in ("w_down", "lm_head")))
    card = card_line()
    timed = [e["w_down"] for e in effects if "ms" in e["w_down"]]
    for e in effects:
        if "ms" in e["w_down"]:
            w = e["w_down"]
            log(f"sharded dst (a) [{card}] rank {e['rank']['model']} w_down slice {w['shape']} side B at "
                f"{SM_ROWS} rows, fp32: kernel {w['ms']:.4f} ms (plain {w['plain_ms']:.4f}, torch.matmul "
                f"{w['library_ms']:.4f}, bound {w['bound_ms']:.4f} ms bytes), max abs err {w['max_abs_err']:.3e}")
    del whole, grads, masked
    free()
    spent["a"] = time.perf_counter() - t_phase

    # -- (b) the whole step on an NCCL group of one rank, against unsharded -------
    qcfg = dataclasses.replace(get_config("qwen3-4b"), activation="relu", num_layers=LAUNCH_LAYERS)
    dcfg = SP.DynamicSparsityConfig(target=0.5, begin=0, end=DST_STEPS, update_every=2)
    ocfg = OptConfig(total_steps=100)
    data = SyntheticLM(vocab_size=qcfg.vocab_size, seq_len=DST_SEQ, global_batch=DST_BATCH, seed=0)
    batches = [data.batch_at(i, device=dev) for i in range(DST_STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            policy = S.ShardingPolicy(mesh=make_local_mesh())
            torch.cuda.synchronize()
            T.reset_launch_counts()
            sharded = dst_run(qcfg, policy, dcfg, ocfg, batches, "sharded dst (b) on the mesh")
            torch.cuda.synchronize()
            launches_b = T.launch_counts()
            group = S.axis_group(policy.mesh, ("data", "model"))[0]
            buf = torch.zeros(sharded["score_numel"], device=dev)
            allreduce_ms = cuda_ms(lambda: dist.all_reduce(buf, group=group), iters=20)
            mesh_desc = (tuple(policy.mesh.shape), tuple(policy.mesh.mesh_dim_names), dist.get_backend())
        finally:
            dist.destroy_process_group()
    unsharded = dst_run(qcfg, None, dcfg, ocfg, batches, "sharded dst (b) unsharded")
    for k in ("tensordash_matmul_planned", "tensordash_matmul_fused", "planner[values]", "planner[emitted]",
              "planner[transpose]"):
        if launches_b[k] == 0:
            raise AssertionError(f"sharded dst (b): the step on the mesh launched no {k}")
    for r, u in zip(sharded["refreshes"], unsharded["refreshes"], strict=True):
        counts = [(x["pruned"], x["regrown"], x["sparsity"]) for x in (r, u)]
        diff = [p for p in u["masks"] if not (r["masks"][p] == u["masks"][p]).all()]
        if diff or counts[0] != counts[1]:
            raise AssertionError(f"sharded dst (b) step {r['step']}: masks differ at {diff[:5]}, counts {counts}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(sharded["loss"], unsharded["loss"]))
    if loss_rel > LOSS_REL:
        raise AssertionError(f"sharded dst (b): losses {sharded['loss']} vs {unsharded['loss']}")
    spent["b"] = time.perf_counter() - t_phase - spent["a"]
    log(f"sharded dst (b): qwen3-4b relu cut to {LAUNCH_LAYERS} layers, fp32, {DST_BATCH} x {DST_SEQ} tokens, "
        f"{sharded['units']} units, NCCL group of one rank, make_local_mesh() {mesh_desc[0]} over {mesh_desc[1]}: "
        f"{len(sharded['refreshes'])} refreshes, masks and counts equal to the unsharded run's ("
        + ", ".join(f"step {r['step']} pruned {r['pruned']} regrown {r['regrown']} sparsity {r['sparsity']:.4f}"
                    for r in sharded["refreshes"])
        + f"); losses {[round(x, 6) for x in sharded['loss']]} vs {[round(x, 6) for x in unsharded['loss']]} "
        f"(largest relative difference {loss_rel:.3e}, bound {LOSS_REL:.3e}); final dst_density "
        f"{sharded['density']:.4f}")
    log(f"sharded dst (b) [{card}]: step seconds on the mesh {[round(x, 3) for x in sharded['step_s']]}, unsharded "
        f"{[round(x, 3) for x in unsharded['step_s']]}; refresh plan-edit ms {[round(r['edit_ms'], 1) for r in sharded['refreshes']]} "
        f"(controller update with the masks' copy {[round(r['update_s'] * 1e3, 1) for r in sharded['refreshes']]} ms); "
        f"the score all-reduce of {sharded['score_numel']} fp32 on the group of one {allreduce_ms:.4f} ms (a group "
        "of one moves no bytes and the step skips it; no run across cards was made)")
    log(f"sharded dst: the phase {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    kernel_rows = [{"kernel": "tensordash_matmul_planned", "main_path": False,
                    "max_abs_err": max(w["max_abs_err"] for w in timed)},
                   {"kernel": "planner[values]", "main_path": False, "max_abs_err": 0.0}]
    launches = {k: launches_a[k] + launches_b[k] for k in launches_b}
    for r in sharded["refreshes"] + unsharded["refreshes"]:
        del r["masks"]
    return {"launches": launches, "launches_a": launches_a, "launches_b": launches_b, "meshes": meshes,
            "effects": effects, "kernel_rows": kernel_rows, "sharded": sharded, "unsharded": unsharded,
            "loss_rel": loss_rel, "allreduce_ms": allreduce_ms, "mesh": mesh_desc, "seconds": spent, "card": card}


# ---------------------------------------------------------------------------
# core phase: the scheduled-form codec on the schedule kernel, the public
# ops, plan validation
# ---------------------------------------------------------------------------

#: the schedule kernel's check: CORE_STREAMS seeded streams of CORE_ROWS rows
#: at each density, one-side and two-side, lookahead 1 and 2
CORE_STREAMS, CORE_ROWS = 64, 4096
CORE_DENSITIES = (0.0, 0.1, 0.34, 0.5, 0.9, 1.0)
#: lane counts besides 16 held to the plain loop: one that does not divide 32, and 32;
#: at these, also a split (n_segs, seg_rows, overlap) of their 1024-row streams
OTHER_LANES, SPLIT_SMALL = (5, 32), (8, 128, 64)
#: stream lengths besides CORE_ROWS held to the plain loop: shorter than the
#: kernel's 256-row stage or no multiple of it (the quickstart's 64 and 96 among them)
EDGE_ROWS = (1, 2, 3, 64, 96, 255, 257, 1000)
#: simulate_macs' accumulator against a float64 sum(a*b): relative to the
#: float64 sum of |a*b|, the scale of any rounding error of the sum (relative
#: to |sum(a*b)| a sum that cancels to near zero fails at any precision)
MACS_RTOL = 1e-5
SCHEDULE_SOURCE = "src/repro_torch/kernels/csrc/schedule.cu"
#: the JAX scan the schedule kernel replaces (no Pallas kernel: a lax.scan)
SCHEDULE_REPLACES = "src/repro/core/compress.py:52"
#: the full-width codec tensor: deepseek-7b's w_down, magnitude-pruned
W_DOWN_SHAPE, W_DOWN_KEEP = (11008, 4096), 0.5
#: (h) also splits seeded streams of w_down's length at these densities: the
#: codec's densest (it stores a tensor with less than 30% zeros dense) and 0.9
SPLIT_DENSITIES = (0.7, 0.9)
#: deepseek-7b's FFN widths for the ops check: (d_model, d_ff), rows
FFN_WIDTHS, FFN_ROWS = (4096, 11008), (4, 128)
#: the validate graph check: deepseek-7b-ReLU at full width cut to VALIDATE_LAYERS layers
VALIDATE_LAYERS = 2


def schedule_bytes(s: int, t: int, n: int) -> int:
    """Least bytes of one schedule launch: z read once (a byte a lane), sel
    written once (a byte a lane), advance (a byte a row), n_cycles."""
    return 2 * s * t * n + s * t + 4 * s


def schedule_chain_ms(cycles: int, lookahead: int, clock_hz: float) -> float:
    """Least time of a stream's (or a tile's) serial chain: each scheduler
    cycle needs the window the last one left, and within a cycle each
    level's picks need the bits the levels before it took, so a stream of
    ``cycles`` cycles is at least ``cycles x n_levels`` dependent steps of
    one SM clock each."""
    from repro_torch.kernels import schedule as S

    return cycles * len(S.schedule_tables(16, lookahead)[2]) / clock_hz * 1e3


def schedule_err(got, want, what: str) -> float:
    """Largest |kernel - plain loop| over ``sel``, ``advance`` and
    ``n_cycles``; raises unless it is 0 (bit-equal)."""
    err = 0.0
    for name, g, w in zip(("sel", "advance", "n_cycles"), got, want):
        diff = (g.cpu().long() - w.long()).abs()
        if diff.numel() and int(diff.max()):
            raise AssertionError(f"{what}: {name} differs from the plain loop in {int((diff > 0).sum())} "
                                 f"entries (largest {int(diff.max())})")
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


def schedule_check(bw: float, clock_hz: float) -> tuple[list, dict]:
    """(a): the schedule kernel bit-equal to its plain loop on every stream
    of ``CORE_DENSITIES`` x one-/two-side x lookahead 1, 2, and
    ``simulate_macs`` on the card: the plain loop's cycles, the accumulator
    within ``MACS_RTOL`` of a float64 ``sum(a*b)``.  Times the kernel and
    the plain loop on each lookahead's batch.  Then the kernel against the
    plain loop at the ``EDGE_ROWS`` lengths, ``OTHER_LANES`` lane counts and
    on transposed operands."""
    import torch
    from repro_torch.core import compress, decompress, simulate_macs
    from repro_torch.kernels import schedule as S

    gen = torch.Generator().manual_seed(24)
    s_all = CORE_STREAMS * len(CORE_DENSITIES)
    shape = (s_all, CORE_ROWS, 16)
    dens = torch.tensor(CORE_DENSITIES).repeat_interleave(CORE_STREAMS)[:, None, None]
    a = torch.randn(shape, generator=gen) * (torch.rand(shape, generator=gen) < dens)
    b = torch.randn(shape, generator=gen) * (torch.rand(shape, generator=gen) < dens)
    a_dense = torch.randn(shape, generator=gen)
    sides = {"one-side": (a_dense, b, b != 0), "two-side": (a, b, (a != 0) & (b != 0))}
    rows, worst = [], 0.0
    for la in (1, 2):
        z = torch.cat([zs for _, _, zs in sides.values()])  # [2 * s_all, T, 16]
        zc = z.cuda()
        t0 = time.perf_counter()
        want = S.schedule_streams_ref(z, lookahead=la)
        plain_s = time.perf_counter() - t0
        got = S.schedule_streams(zc, lookahead=la)
        torch.cuda.synchronize()
        sched_err = schedule_err(got, want, f"schedule kernel, lookahead {la}")
        ms = cuda_ms(lambda: S.schedule_streams(zc, lookahead=la), iters=5, warmup=1)
        half = CORE_DENSITIES.index(0.5) * CORE_STREAMS  # the 64 one-side streams at density 0.5
        z64 = zc[half:half + CORE_STREAMS]
        ms64 = cuda_ms(lambda: S.schedule_streams(z64, lookahead=la), iters=5, warmup=1)
        cycles = want[2].view(2, s_all)
        for i, (side, (av, bv, _)) in enumerate(sides.items()):
            acc, cyc = simulate_macs(av.cuda(), bv.cuda(), lookahead=la, two_side=side == "two-side")
            if not torch.equal(cyc.cpu(), cycles[i]):
                raise AssertionError(f"simulate_macs {side}, lookahead {la}: cycles differ from the plain loop")
            prod = av.double() * bv.double()
            ref, scale = prod.sum(dim=(1, 2)), prod.abs().sum(dim=(1, 2))
            err = (acc.cpu().double() - ref).abs()
            if bool((err > MACS_RTOL * scale).any()):
                raise AssertionError(f"simulate_macs {side}, lookahead {la}: accumulator off the float64 "
                                     f"sum by {float((err / scale.clamp(min=1e-300)).max()):.3e} relative")
            worst = max(worst, float((err / scale.clamp(min=1e-300)).max()))
        n_streams = 2 * s_all
        bound = schedule_bytes(n_streams, CORE_ROWS, 16) / bw * 1e3
        chain = schedule_chain_ms(int(want[2].max()), la, clock_hz)
        rows.append({"case": f"{n_streams} streams x {CORE_ROWS} rows, lookahead {la}",
                     "kernel": "td_schedule_kernel", "shape": f"[{n_streams},{CORE_ROWS},16]",
                     "max_abs_err": sched_err, "ms": ms, "plain_ms": plain_s * 1e3, "library_ms": None,
                     "bound_ms": bound, "bound_by": "bytes", "chain_bound_ms": chain, "main_path": la == 2,
                     "cycles_mean": float(cycles.float().mean()), "ms_64_streams_half_dense": ms64,
                     "bound_ms_64_streams": schedule_bytes(CORE_STREAMS, CORE_ROWS, 16) / bw * 1e3})
        log(f"core (a): schedule kernel, lookahead {la}, {n_streams} streams x {CORE_ROWS} rows "
            f"(densities {CORE_DENSITIES}, one- and two-side): sel, advance, n_cycles bit-equal to the plain "
            f"loop; kernel {ms:.4f} ms ({CORE_STREAMS} one-side streams at density 0.5 alone {ms64:.4f} ms), "
            f"plain loop {plain_s * 1e3:.1f} ms, bound {bound:.4f} ms (bytes), serial chain {chain:.4f} ms; "
            f"simulate_macs cycles equal, accumulator within {worst:.2e} of the float64 sum (relative to "
            f"sum |a*b|)")
    for n in OTHER_LANES:  # the kernel's generic rotations (5) and a full word (32); split too
        z = torch.rand((32, 1024, n), generator=gen) < 0.5
        want = S.schedule_streams_ref(z, n_lanes=n)
        schedule_err(S.schedule_streams(z.cuda(), n_lanes=n), want, f"schedule kernel, {n} lanes")
        schedule_err(S._launch(z.cuda(), n, 2, SPLIT_SMALL), want, f"schedule kernel split {SPLIT_SMALL}, {n} lanes")
    log(f"core (a): schedule kernel at {OTHER_LANES} lanes, 32 streams x 1024 rows, one thread a stream and split "
        f"into {SPLIT_SMALL[0]} segments of {SPLIT_SMALL[1]} rows (heads of {SPLIT_SMALL[2]}): bit-equal to the "
        "plain loop")
    # lengths the 256-row stage does not divide, 8 streams at each density
    dens = torch.tensor(CORE_DENSITIES).repeat_interleave(8)[:, None, None]
    for t in EDGE_ROWS:
        z = torch.rand((dens.shape[0], t, 16), generator=gen) < dens
        for la in (1, 2):
            schedule_err(S.schedule_streams(z.cuda(), lookahead=la), S.schedule_streams_ref(z, lookahead=la),
                         f"schedule kernel, T = {t}, lookahead {la}")
    # a transposed [16, T] operand: its != 0 keeps the permuted strides
    t = EDGE_ROWS[-1]
    x = torch.randn((16, t), generator=gen) * (torch.rand((16, t), generator=gen) < 0.5)
    xt = x.cuda().T
    want = S.schedule_streams_ref(x.T.unsqueeze(0))
    schedule_err(S.schedule_streams(xt.unsqueeze(0)), want, "schedule kernel, transposed operand")
    enc = compress(xt)
    schedule_err((enc.sel.unsqueeze(0), enc.advance.unsqueeze(0), enc.n_cycles.reshape(1)), want,
                 "compress of a transposed operand")
    if not torch.equal(decompress(enc, t=t).cpu(), x.T):
        raise AssertionError("compress of a transposed operand does not round-trip")
    _, cyc = simulate_macs(torch.ones_like(xt), xt, two_side=False)
    schedule_err((torch.zeros(0), torch.zeros(0), cyc.reshape(1)), (torch.zeros(0), torch.zeros(0), want[2]),
                 "simulate_macs of a transposed operand")
    log(f"core (a): schedule kernel at T = {EDGE_ROWS}, {dens.shape[0]} streams each, lookahead 1 and 2, and on a "
        f"transposed [16, {t}] operand (schedule_streams, compress, simulate_macs): bit-equal to the plain loop")
    return rows, {"macs_worst_rel": worst}


def codec_check() -> dict:
    """(b): full-width deepseek-7b ``w_down`` [11008, 4096] bf16 from the
    seed, magnitude-pruned to half: ``encode`` on the card then ``decode``
    must give it back bit for bit.  The encode's one schedule launch (one
    stream of 2 818 048 rows) is timed with CUDA events around it; its
    schedule is kept for :func:`codec_schedule_check`."""
    import torch
    from repro_torch.checkpoint import codec
    from repro_torch.kernels import schedule as S

    gdev = torch.Generator(device="cuda").manual_seed(7)
    w = (torch.randn(W_DOWN_SHAPE, generator=gdev, device="cuda") * 0.02).to(torch.bfloat16)
    mag = w.abs().float().flatten()
    thr = torch.kthvalue(mag.cpu(), int(mag.numel() * (1 - W_DOWN_KEEP))).values.item()
    w = torch.where(w.abs().float() > thr, w, torch.zeros((), dtype=w.dtype, device=w.device))
    torch.cuda.synchronize()
    real, events = S.schedule_streams, []

    def timed_schedule(z, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(z, **kw)
        end.record()
        events.append((start, end))
        return out

    S.schedule_streams = timed_schedule
    try:
        t0 = time.perf_counter()
        d = codec.encode(w)
        encode_s = time.perf_counter() - t0
    finally:
        S.schedule_streams = real
    if len(events) != 1:
        raise AssertionError(f"codec: encode made {len(events)} schedule calls, want 1")
    kernel_ms = events[0][0].elapsed_time(events[0][1])
    t0 = time.perf_counter()
    back = codec.decode(d)
    decode_s = time.perf_counter() - t0
    if int(d["mode"]) != 1 or not torch.equal(back.view(torch.int16), w.cpu().view(torch.int16)):
        raise AssertionError("codec: w_down did not round-trip bit for bit")
    rows = int(d["t"])
    return {"w": w, "sel": d["sel"], "advance": d["advance"], "rows": rows, "encode_s": encode_s,
            "decode_s": decode_s, "kernel_ms": kernel_ms, "n_cycles": int(d["values"].shape[0]),
            "compressed_bytes": codec.compressed_bytes(d), "dense_bytes": w.numel() * w.element_size(),
            "zero_share": float((w == 0).float().mean())}


def codec_schedule_check(codec_run: dict, bw: float, clock_hz: float) -> dict:
    """The encode's schedule against the plain loop on the stream's first
    ``CORE_ROWS`` rows (its ms a row timed there; the whole stream would
    take the host loop some twenty minutes): every cycle whose window lies
    inside those rows, its pointer at most ``CORE_ROWS - depth``, sees what
    the plain loop sees and must schedule the same.  Its bounds: bytes, and
    the stream's serial chain."""
    import numpy as np
    import torch
    from repro_torch.kernels import schedule as S

    head = (codec_run["w"][:CORE_ROWS * 16 // W_DOWN_SHAPE[1]] != 0).reshape(1, CORE_ROWS, 16).cpu()
    t0 = time.perf_counter()
    want = S.schedule_streams_ref(head)
    plain_row_ms = (time.perf_counter() - t0) / CORE_ROWS * 1e3
    adv = codec_run["advance"].astype(np.int64)
    k = int(((np.cumsum(adv) - adv) <= CORE_ROWS - 3).sum())  # depth 3 at lookahead 2
    if not 0 < k <= int(want[2][0]):
        raise AssertionError(f"codec: {k} leading cycles to compare, the plain loop has {int(want[2][0])}")
    got = (torch.from_numpy(codec_run["sel"][:k])[None], torch.from_numpy(codec_run["advance"][:k])[None],
           torch.zeros(0))
    err = schedule_err(got, (want[0][:, :k], want[1][:, :k], torch.zeros(0)), "codec schedule of w_down")
    rows = codec_run["rows"]
    return {"kernel_ms": codec_run["kernel_ms"], "plain_ms_per_row": plain_row_ms,
            "plain_ms_extrapolated": plain_row_ms * rows, "cycles_checked": k, "max_abs_err": err,
            "bound_ms": schedule_bytes(1, rows, 16) / bw * 1e3,
            "chain_bound_ms": schedule_chain_ms(codec_run["n_cycles"], 2, clock_hz)}


#: the tile kernel's sweep against its plain loop: PE rows (33 and 100 take
#: the CTA-wide minimum), lane counts, lookaheads; lengths shorter than the
#: window, odd, and a 256-row tile; then TILE_RAGGED tiles of one launch
#: with lengths drawn from TILE_RAGGED_T
TILE_ROWS_SWEEP = (1, 2, 3, 4, 8, 16, 33, 100)
TILE_LANES = (16, 8)
TILE_T = (1, 2, 37, 256)
TILE_RAGGED, TILE_RAGGED_T = 1000, (1, 2, 3, 17, 64, 256, 688)
#: the packings (tiles a warp) each timed batch is also timed at, beside the path's
TILE_PACKS = (1, 2, 8)
#: the JAX scans the tile kernel replaces (no Pallas kernel: lax.scans)
TILE_REPLACES = "src/repro/core/pe.py:92"
#: the Fig. 17/18 rows sweep (benchmarks/fig17_18_tile_geometry.py's layer and settings)
FIG17_LAYER, FIG17_ROWS = ("resnet_conv", 256, 3, 3, 128, 28, 28), (1, 2, 4, 8, 16)
#: (g): deepseek-7b's FFN layers through model_speedup at the defaults, per-layer
#: densities drawn from this seed
CYCLE_MODEL_SEED = 29


def tile_bytes(parts) -> int:
    """Least bytes of one tile launch: every row's 0/1 bytes read once,
    the cycles written once."""
    return sum(z.numel() for z in parts) + 4 * sum(z.shape[0] for z in parts)


def _tiles_on(parts, dev):
    """A ragged batch's one buffer on ``dev`` and its views."""
    from repro_torch.kernels import schedule as S

    packed = S.pack_tiles(parts).to(dev)
    return S.tile_views(packed, sum(z.shape[0] for z in parts))


def tile_run(parts, clock_hz: float, label: str) -> dict:
    """One batch of 4-row tiles through the tile kernel as ``tile_cycles``
    launches it (the path: its packing from the batch's size, rows staged)
    and at each of :data:`TILE_PACKS` tiles a warp, each held to the plain
    loop and timed; the path's clocks a cycle are its ms over the longest
    tile's cycles, as :func:`split_check` takes the stream's.  Not counted:
    the caller restores the launch counts."""
    import numpy as np
    from repro_torch.kernels import block_mask, schedule as S

    t0 = time.perf_counter()
    want = S.tile_cycles(*_tiles_on(parts, "cpu"), rows=4).numpy()  # the plain loop, a batch a length
    plain_s = time.perf_counter() - t0
    z, t, off = _tiles_on(parts, "cuda")
    max_t = max(p.shape[2] for p in parts)
    pack, words = S.tile_launch_shape(t.shape[0], max_t, 4, block_mask.sm_count(z.device))
    runs = {"path": lambda: S.tile_cycles(z, t, off, rows=4, max_t=max_t)}
    runs.update({k: (lambda k=k: S._tile_launch(z, t, off, 4, 16, 2, (k, words))) for k in TILE_PACKS if k != pack})
    for name, run in runs.items():
        got = run().cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"tile kernel, {label} ({name} a warp): cycles differ from the plain loop in "
                                 f"{int((got != want).sum())} tiles")
    times = {name: cuda_ms(run, iters=10, warmup=1) for name, run in runs.items()}
    ms, cycles = times.pop("path"), int(want.max())
    return {"want": want, "plain_s": plain_s, "ms": ms, "pack": pack, "pack_ms": {pack: ms, **times},
            "cycles_max": cycles, "clocks_a_cycle": ms * 1e-3 * clock_hz / max(cycles, 1)}


#: the tile run's numbers kept in its row
TILE_RUN_KEYS = ("pack", "pack_ms", "cycles_max", "clocks_a_cycle")


def tile_log(run: dict) -> str:
    """A :func:`tile_run`'s numbers for the log."""
    return (f"the path ({run['pack']} a warp) {run['ms']:.4f} ms, {run['cycles_max']} cycles "
            f"({run['clocks_a_cycle']:.0f} clocks a cycle); at "
            + ", ".join(f"{k} a warp {v:.4f}" for k, v in sorted(run["pack_ms"].items())) + " ms")


def tile_check(bw: float, clock_hz: float) -> list:
    """(f): the tile kernel (``td_tile_kernel``) bit-equal to its plain
    loop (``tile_cycles_ref``): PE rows ``TILE_ROWS_SWEEP`` x lanes
    ``TILE_LANES`` x lookahead 1, 2, each a batch of tiles of lengths
    ``TILE_T`` (all-zero, all-one and seeded densities), launched as
    ``tile_cycles`` launches it (``max_t`` given: rows staged), with its
    rows loaded as needed (``max_t`` unknown) and with as many tiles a warp
    as a warp holds; then a ragged batch of ``TILE_RAGGED`` tiles of 4
    rows, lengths from ``TILE_RAGGED_T``, in one launch, timed against its
    plain loop and its bounds (:func:`tile_run`)."""
    import numpy as np
    import torch
    from repro_torch.kernels import schedule as S

    rng = np.random.default_rng(19)
    n_cases = 0
    for rows in TILE_ROWS_SWEEP:
        for n in TILE_LANES:
            parts = []
            for t in TILE_T:
                z = rng.random((4, rows, t, n)) < rng.uniform(0.05, 0.95, size=(4, rows, 1, 1))
                z[0], z[1] = False, True
                parts.append(torch.from_numpy(z))
            for la in (1, 2):
                want = np.concatenate([S.tile_cycles_ref(z.numpy(), n, la) for z in parts])
                z, t, off = _tiles_on(parts, "cuda")
                runs = {"path": lambda: S.tile_cycles(z, t, off, rows=rows, n_lanes=n, lookahead=la,
                                                      max_t=max(TILE_T)),
                        "rows loaded as needed": lambda: S.tile_cycles(z, t, off, rows=rows, n_lanes=n,
                                                                       lookahead=la)}
                if rows <= 32:
                    full = (32 // rows, rows * (max(TILE_T) | 1))
                    runs["a full warp of tiles"] = lambda: S._tile_launch(z, t, off, rows, n, la, full)
                for name, run in runs.items():
                    got = run()
                    if not np.array_equal(got.cpu().numpy(), want):
                        raise AssertionError(f"tile kernel, {rows} rows, {n} lanes, lookahead {la} ({name}): "
                                             f"cycles {got.cpu().tolist()} != the plain loop's {want.tolist()}")
                n_cases += len(want)
    log(f"core (f): tile kernel at rows {TILE_ROWS_SWEEP} x lanes {TILE_LANES} x lookahead 1, 2, T = {TILE_T} "
        f"(all-zero, all-one, seeded), the path (staged), rows loaded as needed and a full warp of tiles "
        f"(rows <= 32): {n_cases} tiles, cycles == the plain loop's")
    order = rng.permutation(TILE_RAGGED)
    ts = np.array(TILE_RAGGED_T)[np.arange(TILE_RAGGED) % len(TILE_RAGGED_T)][order]
    parts = [torch.from_numpy(rng.random((1, 4, int(t), 16)) < rng.uniform(0.2, 0.8)) for t in ts]
    case = f"{TILE_RAGGED} ragged tiles of 4 rows, T in {TILE_RAGGED_T}, lookahead 2"
    run = tile_run(parts, clock_hz, case)
    row = {"case": case, "kernel": "td_tile_kernel", "shape": f"[{TILE_RAGGED},4,T,16]", "max_abs_err": 0.0,
           "ms": run["ms"], "plain_ms": run["plain_s"] * 1e3, "library_ms": None,
           "bound_ms": tile_bytes(parts) / bw * 1e3, "bound_by": "bytes",
           "chain_bound_ms": schedule_chain_ms(run["cycles_max"], 2, clock_hz), "main_path": False,
           **{k: run[k] for k in TILE_RUN_KEYS}}
    log(f"core (f): tile kernel, {case}, one launch: cycles == the plain loop's; {tile_log(run)}; plain loop "
        f"{row['plain_ms']:.1f} ms, bounds: bytes {row['bound_ms']:.6f} ms, chain {row['chain_bound_ms']:.4f} ms")
    return [row]


#: the cycle model's timed configurations: the train step's deepseek-7b and the deepest the port serves
CYCLE_MODEL_ARCHS = ("deepseek-7b", "qwen3-moe-235b-a22b")
CYCLE_MODEL_REPEAT = 9


def cycle_model_timing(clock_hz: float, repeat: int = CYCLE_MODEL_REPEAT) -> dict:
    """``speedup_from_densities`` (into ``model_speedup`` at its defaults)
    on the card over each of :data:`CYCLE_MODEL_ARCHS`' FFN layers, the
    densities drawn from ``CYCLE_MODEL_SEED``, equal to the host's: the
    seconds of ``repeat`` calls after a first one (median and least), one
    tile launch a call, and that launch's device ms on the call's batch
    (``tile_cycles`` as ``simulate_tiles`` calls it) with its clocks a
    cycle; then ``TILE_RAGGED`` ragged tiles in one launch.  It uses only
    names the package has had since the tile kernel came, so it times an
    older checkout's package with that checkout's ``src`` first on
    ``sys.path`` (:func:`cycle_model_timing_main`)."""
    import inspect
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import perf_model as pm
    from repro_torch.kernels import schedule as S

    def launch_ms(parts):
        z, t, off = _tiles_on(parts, "cuda")
        kw = {"max_t": max(p.shape[2] for p in parts)} if "max_t" in inspect.signature(S.tile_cycles).parameters \
            else {}
        want = S.tile_cycles(*_tiles_on(parts, "cpu"), rows=4).numpy()
        if not np.array_equal(S.tile_cycles(z, t, off, rows=4, **kw).cpu().numpy(), want):
            raise AssertionError("tile kernel: cycles differ from the plain loop")
        return cuda_ms(lambda: S.tile_cycles(z, t, off, rows=4, **kw), iters=10, warmup=1), int(want.max())

    counted = dict(S.LAUNCHES)
    out = {}
    for arch in CYCLE_MODEL_ARCHS:
        cfg = get_config(arch)
        layers = pm.ffn_layers_from_config(cfg)
        rng = np.random.default_rng(CYCLE_MODEL_SEED)
        a, g = rng.uniform(0.2, 0.6, cfg.num_layers), rng.uniform(0.3, 0.9, cfg.num_layers)
        card = pm.speedup_from_densities(a, g, layers)
        if card != pm.speedup_from_densities(a, g, layers, device="cpu"):
            raise AssertionError(f"model_speedup over {arch}'s FFN layers: the card's != the host's")
        seconds = []
        for _ in range(repeat):
            before = S.LAUNCHES["td_tile_kernel"]
            t0 = time.perf_counter()
            pm.speedup_from_densities(a, g, layers)
            seconds.append(time.perf_counter() - t0)
            if S.LAUNCHES["td_tile_kernel"] != before + 1:
                raise AssertionError(f"model_speedup over {arch}'s FFN layers: not one tile launch")
        spars = [{pm.FWD: 1 - x, pm.BWD_INPUT: 1 - y, pm.BWD_WEIGHT: max(1 - x, 1 - y)} for x, y in zip(a, g)]
        parts = [torch.from_numpy(pm._conv_masks(layer, s[c], pm.TileConfig(), 0.4, 2, 256, 7919 * i)[0])
                 for i, (layer, s) in enumerate(zip(layers, spars)) for c in (pm.FWD, pm.BWD_INPUT, pm.BWD_WEIGHT)]
        ms, cycles = launch_ms(parts)
        out[arch] = {"layers": len(layers), "tiles": sum(p.shape[0] for p in parts), "call_s": seconds,
                     "median_s": statistics.median(seconds), "least_s": min(seconds), "launch_ms": ms,
                     "cycles_max": cycles, "clocks_a_cycle": ms * 1e-3 * clock_hz / max(cycles, 1)}
        log(f"cycle model timing: {arch}'s {len(layers)} FFN layers, {out[arch]['tiles']} tiles, card == host: "
            f"a call median {out[arch]['median_s']:.4f} s, least {out[arch]['least_s']:.4f} s over {repeat}; "
            f"its launch {ms:.4f} ms, {cycles} cycles ({out[arch]['clocks_a_cycle']:.0f} clocks a cycle)")
    rng = np.random.default_rng(CYCLE_MODEL_SEED)
    ts = rng.permutation(np.array(TILE_RAGGED_T)[np.arange(TILE_RAGGED) % len(TILE_RAGGED_T)])
    ms, cycles = launch_ms([torch.from_numpy(rng.random((1, 4, int(t), 16)) < rng.uniform(0.2, 0.8)) for t in ts])
    out["ragged"] = {"tiles": TILE_RAGGED, "launch_ms": ms, "cycles_max": cycles,
                     "clocks_a_cycle": ms * 1e-3 * clock_hz / max(cycles, 1)}
    log(f"cycle model timing: {TILE_RAGGED} ragged tiles, one launch {ms:.4f} ms, {cycles} cycles "
        f"({out['ragged']['clocks_a_cycle']:.0f} clocks a cycle)")
    S.LAUNCHES.update(counted)  # not the path's
    return out


def cycle_model_timing_main() -> int:
    """:func:`cycle_model_timing` alone, for the package first on
    ``sys.path``, its result a JSON line: ``python3 -c 'import sys;
    sys.path[:0] = ["<checkout>/src", "."]; import chip_smoke as C;
    sys.exit(C.cycle_model_timing_main())'`` from this file's directory."""
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card visible", file=sys.stderr)
        return 2
    _build.library()
    log(f"cycle model timing: {_build.__file__}")
    print(json.dumps(cycle_model_timing(max_sm_clock_hz())))
    print(card_line())
    return 0


def cycle_model_check(bw: float, clock_hz: float) -> dict:
    """(g): the paper's cycle model on the card, the main path's: the
    train step's estimator over deepseek-7b's 30 FFN layers
    (``speedup_from_densities`` into ``model_speedup`` at the defaults, 90
    convolutions, one tile launch), the Fig. 17/18 rows sweep and
    deepseek-7b's FFN convolution over its whole workload (all 256 groups,
    all 688 rows); each equal to the host's (``device="cpu"``), both timed.
    The kernel alone on the estimator's and the whole workload's batches is
    timed against its plain loop and its bounds; those launches are not
    counted."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import perf_model as pm
    from repro_torch.kernels import schedule as S

    cfg = get_config("deepseek-7b")
    layers = pm.ffn_layers_from_config(cfg)
    rng = np.random.default_rng(CYCLE_MODEL_SEED)
    a, g = rng.uniform(0.2, 0.6, cfg.num_layers), rng.uniform(0.3, 0.9, cfg.num_layers)
    t0 = time.perf_counter()
    card = pm.speedup_from_densities(a, g, layers)
    card_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        pm.speedup_from_densities(a, g, layers)
    card_s = min(card_s, (time.perf_counter() - t0) / reps)
    t0 = time.perf_counter()
    host = pm.speedup_from_densities(a, g, layers, device="cpu")
    host_s = time.perf_counter() - t0
    if card != host:
        raise AssertionError(f"model_speedup on the card {card} != the host's {host}")
    # the host path before the tile kernel: a plain loop a convolution
    spars = [{pm.FWD: 1 - x, pm.BWD_INPUT: 1 - y, pm.BWD_WEIGHT: max(1 - x, 1 - y)} for x, y in zip(a, g)]
    t0 = time.perf_counter()
    for i, (layer, sp) in enumerate(zip(layers, spars)):
        for conv in (pm.FWD, pm.BWD_INPUT, pm.BWD_WEIGHT):
            pm.simulate_conv(layer, sparsity=sp[conv], max_t=256, seed=7919 * i, device="cpu")
    per_conv_s = time.perf_counter() - t0
    fig = []
    for rows in FIG17_ROWS:
        kw = dict(sparsity=0.66, tile=pm.TileConfig(rows=rows, cols=4), clustering=0.55, sample_groups=1,
                  max_t=192)
        got, want = (pm.simulate_conv(pm.ConvLayer(*FIG17_LAYER), **kw),
                     pm.simulate_conv(pm.ConvLayer(*FIG17_LAYER), device="cpu", **kw))
        if (got.td_cycles, got.dense_cycles) != (want.td_cycles, want.dense_cycles):
            raise AssertionError(f"Fig. 17/18 rows {rows}: card {got} != host {want}")
        fig.append((rows, got.speedup))
    whole = dict(sparsity=0.5, sample_groups=256, max_t=688)
    t0 = time.perf_counter()
    got = pm.simulate_conv(layers[0], **whole)
    whole_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = pm.simulate_conv(layers[0], device="cpu", **whole)
    whole_host_s = time.perf_counter() - t0
    if (got.td_cycles, got.dense_cycles) != (want.td_cycles, want.dense_cycles):
        raise AssertionError(f"deepseek-7b FFN conv, whole workload: card {got} != host {want}")
    counted = dict(S.LAUNCHES)
    # the kernel alone on the two batches: the estimator's 90 convolutions and the whole workload
    rows = []
    est = [torch.from_numpy(pm._conv_masks(layer, s[c], pm.TileConfig(), 0.4, 2, 256, 7919 * i)[0])
           for i, (layer, s) in enumerate(zip(layers, spars)) for c in (pm.FWD, pm.BWD_INPUT, pm.BWD_WEIGHT)]
    full = [torch.from_numpy(pm._conv_masks(layers[0], 0.5, pm.TileConfig(), 0.4, 256, 688, 0)[0])]
    deep_cfg = get_config(CYCLE_MODEL_ARCHS[-1])
    deep_layers = pm.ffn_layers_from_config(deep_cfg)
    drng = np.random.default_rng(CYCLE_MODEL_SEED)  # cycle_model_timing's densities
    da, dg = drng.uniform(0.2, 0.6, deep_cfg.num_layers), drng.uniform(0.3, 0.9, deep_cfg.num_layers)
    deep = [torch.from_numpy(pm._conv_masks(layer, s, pm.TileConfig(), 0.4, 2, 256, 7919 * i)[0])
            for i, (layer, x, y) in enumerate(zip(deep_layers, da, dg)) for s in (1 - x, 1 - y, max(1 - x, 1 - y))]
    runs = []
    for label, parts, main in (("model_speedup, deepseek-7b's 30 FFN layers x 3 convolutions, 2 groups of "
                                "4 x 256 rows each", est, True),
                               (f"model_speedup's batch over {CYCLE_MODEL_ARCHS[-1]}'s {len(deep_layers)} FFN "
                                "layers, 2 groups of 4 x 256 rows a convolution", deep, False),
                               ("deepseek-7b FFN conv, whole workload: 256 groups of 4 x 688 rows", full, False)):
        run = tile_run(parts, clock_hz, label)
        n_tiles = sum(p.shape[0] for p in parts)
        rows.append({"case": label, "kernel": "td_tile_kernel", "shape": f"[{n_tiles},4,T,16]",
                     "max_abs_err": 0.0, "ms": run["ms"], "plain_ms": run["plain_s"] * 1e3, "library_ms": None,
                     "bound_ms": tile_bytes(parts) / bw * 1e3, "bound_by": "bytes",
                     "chain_bound_ms": schedule_chain_ms(run["cycles_max"], 2, clock_hz), "main_path": main,
                     **{k: run[k] for k in TILE_RUN_KEYS}})
        runs.append(run)
    S.LAUNCHES.update(counted)  # the timing launches above are not the path's
    est_row, deep_row, full_row = rows
    log(f"core (g): model_speedup over deepseek-7b's {len(layers)} FFN layers (speedup_from_densities, seed "
        f"{CYCLE_MODEL_SEED}) on the card == on the host: {card}; card {card_s:.3f} s a call (one tile launch), "
        f"host loop {host_s:.2f} s (a convolution at a time, as before the tile kernel, {per_conv_s:.2f} s); "
        f"the launch alone: {tile_log(runs[0])} (plain loop {est_row['plain_ms']:.0f} "
        f"ms; bounds: bytes {est_row['bound_ms']:.6f} ms, chain {est_row['chain_bound_ms']:.4f} ms)")
    log(f"core (g): {deep_row['case']}: {tile_log(runs[1])} (plain loop {deep_row['plain_ms']:.0f} ms; bounds: "
        f"bytes {deep_row['bound_ms']:.6f} ms, chain {deep_row['chain_bound_ms']:.4f} ms)")
    log(f"core (g): Fig. 17/18 rows sweep {FIG17_LAYER[0]} at 66% sparsity, card == host: "
        + ", ".join(f"{r} rows {s:.3f}x" for r, s in fig))
    log(f"core (g): deepseek-7b FFN conv over its whole workload (256 groups x 688 rows) card == host, "
        f"{got.speedup:.4f}x: simulate_conv card {whole_card_s:.3f} s, host {whole_host_s:.2f} s; the launch alone: "
        f"{tile_log(runs[2])} (plain loop {full_row['plain_ms']:.0f} ms; bounds: bytes "
        f"{full_row['bound_ms']:.6f} ms, chain {full_row['chain_bound_ms']:.4f} ms)")
    return {"rows": rows, "model_speedup": card, "card_s": card_s, "host_s": host_s, "per_conv_host_s": per_conv_s,
            "fig17_rows": fig,
            "whole_speedup": got.speedup, "whole_card_s": whole_card_s, "whole_host_s": whole_host_s}


def split_check(codec_run: dict, bw: float, clock_hz: float) -> dict:
    """(h): the whole ``w_down`` stream's split schedule (the codec's path)
    bit-equal to one thread walking it (the one-thread path, the split's
    fallback): ``sel``, ``advance`` and ``n_cycles`` over every cycle.  Both
    timed; the walk's ms gives the clocks a cycle; the split's bounds: the
    bytes, and the longest segment's chain (its head, its rows and its
    replay at the stream's cycles a row) plus the stitch's walk over the
    segments.  The same for seeded streams of that length at
    ``SPLIT_DENSITIES``, where hand-overs come later.  Not counted: the
    codec's encode is the path's launch."""
    import torch
    from repro_torch.kernels import schedule as S

    zc = (codec_run["w"] != 0).reshape(1, -1, 16)
    t = zc.shape[1]
    split = S.split_geometry(1, t)
    counted = dict(S.LAUNCHES)
    got = S.schedule_streams(zc)
    walk = S._launch(zc, 16, 2, None)
    torch.cuda.synchronize()
    for name, g, w in zip(("sel", "advance", "n_cycles"), got, walk):
        if not torch.equal(g, w):
            raise AssertionError(f"split schedule of w_down: {name} differs from the one-thread walk in "
                                 f"{int((g != w).sum())} entries")
    split_ms = cuda_ms(lambda: S.schedule_streams(zc), iters=5, warmup=1)
    walk_ms = cuda_ms(lambda: S._launch(zc, 16, 2, None), iters=1, warmup=0)
    dense = {}  # denser streams of the same length: hand-overs come later (or fall back)
    gdev = torch.Generator(device="cuda").manual_seed(13)
    for d in SPLIT_DENSITIES:
        zd = torch.rand(zc.shape, generator=gdev, device="cuda") < d
        got_d, walk_d = S.schedule_streams(zd), S._launch(zd, 16, 2, None)
        torch.cuda.synchronize()
        for name, g, w in zip(("sel", "advance", "n_cycles"), got_d, walk_d):
            if not torch.equal(g, w):
                raise AssertionError(f"split schedule at density {d}: {name} differs from the one-thread walk")
        dense[d] = {"cycles": int(walk_d[2][0]), "split_ms": cuda_ms(lambda: S.schedule_streams(zd), iters=3, warmup=0),
                    "walk_ms": cuda_ms(lambda: S._launch(zd, 16, 2, None), iters=1, warmup=0)}
        del zd, got_d, walk_d
    S.LAUNCHES.update(counted)
    cycles = int(walk[2][0])
    n_segs, seg_rows, overlap = split
    chain_rows = overlap + 2 * seg_rows
    chain = schedule_chain_ms(round(chain_rows * cycles / t), 2, clock_hz) + n_segs / clock_hz * 1e3
    out = {"split": split, "cycles": cycles, "split_ms": split_ms, "walk_ms": walk_ms,
           "clocks_a_cycle": walk_ms * 1e-3 * clock_hz / cycles, "bound_ms": schedule_bytes(1, t, 16) / bw * 1e3,
           "split_chain_bound_ms": chain, "walk_chain_bound_ms": schedule_chain_ms(cycles, 2, clock_hz),
           "denser": dense}
    log(f"core (h): w_down's one stream of {t} rows split into {n_segs} segments of {seg_rows} rows (heads of "
        f"{overlap}): sel, advance, n_cycles == the one-thread walk's over all {cycles} cycles; split "
        f"{split_ms:.4f} ms, walk {walk_ms:.1f} ms ({out['clocks_a_cycle']:.0f} clocks a cycle at "
        f"{clock_hz / 1e6:.0f} MHz); bounds: bytes {out['bound_ms']:.4f} ms, the split's chain "
        f"{chain:.4f} ms, the walk's {out['walk_chain_bound_ms']:.4f} ms; denser streams of {t} rows, split == walk: "
        + "; ".join(f"density {d}: {r['cycles']} cycles, split {r['split_ms']:.4f} ms, walk {r['walk_ms']:.1f} ms"
                    for d, r in dense.items()))
    return out


def quickstart_check() -> dict:
    """(c): the port's quickstart example, ``repro_torch.examples.quickstart``,
    its ``main`` on the card, held to its run on the host (``--device cpu``,
    the plain versions: the same cycles, codec rows and projection) and its
    schedules to the plain loop."""
    import io

    import numpy as np
    import torch
    from repro_torch.examples import quickstart as Q
    from repro_torch.kernels import schedule as S

    out = Q.main([])  # on the card: the tile, schedule, SpMM and planner kernels
    with contextlib.redirect_stdout(io.StringIO()):
        host = Q.main(["--device", "cpu"])
    r, a, b, x, enc, res = out["stream"], out["a"], out["b"], out["x"], out["enc"], out["conv"]
    if int(r.cycles) != int(host["stream"].cycles):
        raise AssertionError("quickstart simulate_stream: the card's cycles differ from the host's")
    mac_err = abs(float(out["acc"]) - float(np.sum(a.astype(np.float64) * b)))
    # both schedules against the plain loop on the same bits (host: no launch)
    none = torch.zeros(0)
    want = S.schedule_streams_ref(torch.from_numpy((a != 0) & (b != 0))[None])
    sched_err = {"simulate_macs": schedule_err((none, none, out["mac_cycles"].reshape(1)), (none, none, want[2]),
                                               "quickstart simulate_macs")}
    sched_err["compress"] = schedule_err((enc.sel[None], enc.advance[None], enc.n_cycles.reshape(1)),
                                         S.schedule_streams_ref(torch.from_numpy(x != 0)[None]), "quickstart compress")
    host_conv = host["conv"]
    if (res.td_cycles, res.dense_cycles) != (host_conv.td_cycles, host_conv.dense_cycles):
        raise AssertionError(f"quickstart simulate_conv: the card's {res} differs from the host's {host_conv}")
    am = out["operands"][0]
    plan = out["plan"]
    got = {"pe_dense": int(r.dense), "pe_cycles": int(r.cycles), "mac_err": mac_err,
           "mac_cycles": int(out["mac_cycles"]), "codec_rows": int(enc.n_cycles), "codec_exact": out["exact"],
           "conv_speedup": res.speedup, "plan_skipped": plan.skipped_fraction(), "runtime_err": out["runtime_err"],
           "ambient": out["ambient"], "plan_cache": out["plan_cache"], "schedule_err": sched_err}
    if not (got["pe_cycles"] < got["pe_dense"] and mac_err <= 1e-5 * float(np.abs(a * b).sum())
            and got["mac_cycles"] <= 64 and got["codec_exact"] and res.speedup > 1
            and got["runtime_err"] <= 2e-4 * (1 + float(np.abs(am).max())) and got["ambient"] == "cuda"
            and (got["codec_rows"], got["plan_skipped"]) == (int(host["enc"].n_cycles),
                                                             host["plan"].skipped_fraction())):
        raise AssertionError(f"quickstart through the port: {got}")
    log(f"core (c): the quickstart example on the card: PE {got['pe_dense']} dense -> {got['pe_cycles']} TensorDash "
        f"cycles ({got['pe_dense'] / got['pe_cycles']:.2f}x at 66% sparsity, == the host's); MAC |acc - ref| = "
        f"{mac_err:.2e} in {got['mac_cycles']}/64 cycles (the plain loop's); codec 96 rows -> {got['codec_rows']} "
        f"scheduled rows (sel, advance, n_cycles == the plain loop's), exact {got['codec_exact']}; conv projection "
        f"{res.speedup:.2f}x (== the host's); runtime[cuda] plan skips {got['plan_skipped']:.0%}, "
        f"|err| {got['runtime_err']:.1e}; ambient runtime -> {got['ambient']}, plan cache {got['plan_cache']}")
    return got


def ops_check() -> dict:
    """(d): ``ops.matmul`` / ``matmul_fused`` / ``matmul_grads`` and
    ``Runtime.sparse_ffn`` on ``cuda`` at deepseek-7b's FFN widths in bf16,
    each against its plain version within the kernel tolerance (bf16 rtol
    2**-7 + atol 1e-3 of the max, as PERF.md section 2); each product one
    launch, one emitted planner launch for the ``w_down`` plan."""
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.kernels import ops, ref, tensordash_spmm as T

    d, f = FFN_WIDTHS
    gdev = torch.Generator(device="cuda").manual_seed(11)
    w1 = (torch.randn(d, f, generator=gdev, device="cuda") / d ** 0.5).to(torch.bfloat16)
    w2 = (torch.randn(f, d, generator=gdev, device="cuda") / f ** 0.5).to(torch.bfloat16)
    rt = rtm.Runtime(backend="cuda")
    out = {}
    for m in FFN_ROWS:
        x = torch.randn(m, d, generator=gdev, device="cuda").to(torch.bfloat16)
        h = torch.relu(x.float() @ w1.float()).to(torch.bfloat16)
        gy = torch.randn(m, d, generator=gdev, device="cuda").to(torch.bfloat16)
        checks = (
            ("matmul", lambda: ops.matmul(h, w2, runtime=rt), lambda: ref.matmul_ref(h, w2),
             {"tensordash_matmul_planned": 1, "planner[values]": 1}),
            ("matmul_fused", lambda: ops.matmul_fused(x, w1, activation="relu", runtime=rt)[0], lambda: h,
             {"tensordash_matmul_fused": 1, "planner[values]": 1}),
            ("matmul_grads", lambda: ops.matmul_grads(h, w2, gy, runtime=rt),
             lambda: ref.matmul_grads_ref(h, w2, gy), None),
            ("sparse_ffn", lambda: ops.sparse_ffn(x, w1, w2, runtime=rt), lambda: ref.sparse_ffn_ref(x, w1, w2),
             {"tensordash_matmul_fused": 1, "planner[emitted]": 1, "tensordash_matmul_planned": 1}),
        )
        for name, call, plain, want in checks:
            before = T.launch_counts()
            with no_plain_versions(f"ops {name}"):
                got = call()
            torch.cuda.synchronize()
            counts = {k: v - before[k] for k, v in T.launch_counts().items() if v - before[k]}
            products = sum(v for k, v in counts.items() if k.startswith("tensordash_matmul"))
            if want is not None and counts != want:
                raise AssertionError(f"ops {name} M={m}: launches {counts} != {want}")
            if want is None and products != 2:
                raise AssertionError(f"ops {name} M={m}: {products} product launches, want 2 (da, db)")
            wants = plain()
            pairs = zip(got, wants) if isinstance(got, tuple) else [(got, wants)]
            err = max(check_close(f"ops {name} M={m}", gg, ww) for gg, ww in pairs)
            out[f"{name} M={m}"] = {"launches": counts, "max_abs_err": err}
        log(f"core (d): ops at [{m},{d}]->{f}->{d} bf16 on cuda: " + "; ".join(
            f"{k.split(' ')[0]} {v['launches']} err {v['max_abs_err']:.2e}" for k, v in out.items()
            if k.endswith(f"M={m}")))
    return out


def validate_check() -> dict:
    """(e): ``Runtime(validate="full")`` on the card: a ``corrupt_cache_entry``
    found and evicted by ``scrub``; a corrupt caller plan (each corruption
    mode) warns, is logged and replanned, and the output equals the clean
    plan's bit for bit; the host ms of ``check_plan`` at each level on the
    LM head's 800-row plan; then deepseek-7b-ReLU cut to
    ``VALIDATE_LAYERS`` layers served with the decode chunk as a CUDA graph
    under ``validate="boundary"``: the eager run's greedy tokens, checks at
    the warm-up, none while capturing."""
    import dataclasses
    import warnings

    import numpy as np
    import torch
    from repro_torch import runtime as rtm
    from repro_torch.analysis import plan_check, verify_plan
    from repro_torch.configs import get_config
    from repro_torch.kernels import tensordash_spmm as T
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params
    from repro_torch.resilience import ResilienceLog, faults
    from repro_torch.resilience.log import use_log
    from repro_torch.runtime import runtime as rtmod

    out = {}
    gdev = torch.Generator(device="cuda").manual_seed(13)
    rt = rtm.Runtime(backend="cuda", validate="full")
    ws = [block_sparse(1024, 4096, 128, 512, 0.6, torch.Generator().manual_seed(i)).to("cuda", torch.bfloat16)
          for i in range(3)]
    for i, w in enumerate(ws):
        rt.plan(w, key=f"w{i}")
    key = faults.corrupt_cache_entry(rt.plan_cache, rng=np.random.default_rng(0))
    bad = rt.plan_cache.scrub()
    if [k for k, _ in bad] != [key] or len(rt.plan_cache._entries) != len(ws) - 1:
        raise AssertionError(f"validate: scrub evicted {[k for k, _ in bad]}, corrupted {key}")
    i = int(key[0][1:])
    misses = rt.plan_cache.misses
    if verify_plan(rt.plan(ws[i], key=key[0])) or rt.plan_cache.misses != misses + 1:
        raise AssertionError("validate: the scrubbed entry was not replanned clean")
    out["scrub"] = {"corrupted": str(key[0]), "evicted": [str(k[0]) for k, _ in bad], "error": bad[0][1][:120]}

    d, f = FFN_WIDTHS
    h = torch.relu(torch.randn(4, f, generator=gdev, device="cuda")).to(torch.bfloat16)
    w2 = (torch.randn(f, d, generator=gdev, device="cuda") / f ** 0.5).to(torch.bfloat16)
    clean = rt.fit(h.shape, w2.shape).plan(h)  # the geometry Runtime.matmul fits
    want = rt.matmul(h, w2, plan=clean)
    out["recovered"] = {}
    for mode in faults.PLAN_CORRUPTIONS:
        log_ = ResilienceLog()
        with use_log(log_), warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = rt.matmul(h, w2, plan=faults.corrupt_plan(clean, rng=np.random.default_rng(1), mode=mode))
        warned = sum(issubclass(w.category, RuntimeWarning) and "corrupt SparsityPlan" in str(w.message)
                     for w in seen)
        if warned != 1 or log_.counts() != {("plan-corrupt", "replan"): 1} or not torch.equal(got, want):
            raise AssertionError(f"validate: corrupt plan ({mode}): {warned} warnings, log {log_.counts()}, "
                                 f"output equal {torch.equal(got, want)}")
        out["recovered"][mode] = "warned, logged, replanned, output equal"

    cfg = dataclasses.replace(get_config("deepseek-7b"), activation="relu", num_layers=VALIDATE_LAYERS)
    params = init_params(M.param_specs(cfg), seed=0, dtype=torch.bfloat16, device="cuda")
    head_plan = rtm.Runtime(backend="cuda").plan(params["lm_head"], side="B")
    if head_plan.block_rows != 800:
        raise AssertionError(f"validate: LM head plan has {head_plan.block_rows} block rows, not 800")
    out["check_plan_host_ms"] = {level: host_ms(lambda: plan_check.check_plan(head_plan, level=level), iters=20)
                                 for level in ("boundary", "full")}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(s)) for s in rng.integers(16, 33, size=REQUESTS)]
    out["before_serve"] = T.launch_counts()  # drive_serve counts each run from 0
    eager = drive_serve(params, cfg, prompts, rtm.Runtime(backend="cuda"))
    checks, skipped = [], []
    real_check, real_capturing = plan_check.check_plan, rtmod.capturing

    def counted_check(plan, geometry=None, *, level="full"):
        checks.append(torch.cuda.is_current_stream_capturing())
        return real_check(plan, geometry, level=level)

    def counted_capturing():
        now = real_capturing()
        if now:
            skipped.append(True)
        return now

    plan_check.check_plan, rtmod.capturing = counted_check, counted_capturing
    try:
        graph = drive_serve(params, cfg, prompts, rtm.Runtime(backend="cuda", validate="boundary"), cuda_graph=True)
    finally:
        plan_check.check_plan, rtmod.capturing = real_check, real_capturing
    diff = first_difference(graph["out"], eager["out"])
    st = graph["stats"]
    if diff is not None or st["decode_graph_captures"] != 1 or not checks or any(checks) or not skipped:
        raise AssertionError(f"validate: graph under boundary: first token difference {diff}, "
                             f"{st['decode_graph_captures']} captures, {len(checks)} checks "
                             f"({sum(checks)} while capturing), {len(skipped)} skipped")
    out["graph"] = {"checks": len(checks), "skipped_while_capturing": len(skipped),
                    "captures": st["decode_graph_captures"], "replays": st["decode_graph_replays"],
                    "tokens_equal_eager": True}
    # the serve runs' launches (each run counts from 0; a capture's once per replay)
    out["serve_launches"] = {k: eager["launches"][k] + graph["device_launches"][k] for k in eager["launches"]}
    log(f"core (e): validate='full' on the card: corrupt_cache_entry({out['scrub']['corrupted']}) evicted by "
        f"scrub and replanned clean; a corrupt caller plan ({', '.join(faults.PLAN_CORRUPTIONS)}) warned, "
        f"logged plan-corrupt/replan and replanned, output bit-equal to the clean plan's; check_plan on the LM "
        f"head's 800-row plan {out['check_plan_host_ms']['boundary']:.3f} ms (boundary) / "
        f"{out['check_plan_host_ms']['full']:.3f} ms (full) host; deepseek-7b-ReLU cut to {VALIDATE_LAYERS} "
        f"layers through the decode graph under validate='boundary': {len(checks)} checks outside the capture, "
        f"{len(skipped)} skipped while capturing, 1 capture, {st['decode_graph_replays']} replays, greedy "
        f"tokens == eager run's")
    del params
    torch.cuda.empty_cache()
    return out


def core_phase(bw: float) -> dict:
    """The paper's core on the card: (a) the schedule kernel against its
    plain loop (not counted), then the slice's main path, its launches
    counted from 0: (c) the quickstart's five steps, (b) the codec on
    full-width ``w_down``, (d) the public ops and ``sparse_ffn``, (e) plan
    validation; then the codec's schedule against the plain loop."""
    import torch
    from repro_torch.kernels import schedule as S, tensordash_spmm as T

    t0 = time.perf_counter()
    clock_hz = max_sm_clock_hz()
    rows, macs = schedule_check(bw, clock_hz)
    tile_rows = tile_check(bw, clock_hz)
    S.reset_launch_counts()
    T.reset_launch_counts()
    quick = quickstart_check()
    codec_run = codec_check()
    ops_run = ops_check()
    validate = validate_check()  # its serve runs count from 0: their launches come back apart
    cycle_model = cycle_model_check(bw, clock_hz)
    torch.cuda.synchronize()
    launches = {k: v + validate["serve_launches"][k] for k, v in validate.pop("before_serve").items()}
    launches.update(S.LAUNCHES)
    timing = codec_schedule_check(codec_run, bw, clock_hz)
    split = split_check(codec_run, bw, clock_hz)
    cm_timing = cycle_model_timing(clock_hz)
    cut = {k: v for k, v in codec_run.items() if k not in ("w", "sel", "advance")}
    for name, shape in (("simulate_macs", "[1,64,16]"), ("compress", "[1,96,16]")):
        rows.append({"case": f"quickstart {name}", "kernel": "td_schedule_kernel", "shape": shape,
                     "max_abs_err": quick["schedule_err"][name], "main_path": False})
    rows.append({"case": f"deepseek-7b w_down {W_DOWN_SHAPE[0]}x{W_DOWN_SHAPE[1]} bf16, half pruned: one stream "
                         f"of {codec_run['rows']} rows", "kernel": "td_schedule_kernel",
                 "shape": f"[1,{codec_run['rows']},16]", "max_abs_err": timing["max_abs_err"],
                 "cycles_checked": timing["cycles_checked"], "ms": timing["kernel_ms"], "plain_ms": None,
                 "plain_ms_per_row": timing["plain_ms_per_row"], "library_ms": None, "bound_ms": timing["bound_ms"],
                 "bound_by": "bytes", "chain_bound_ms": timing["chain_bound_ms"],
                 "split_chain_bound_ms": split["split_chain_bound_ms"], "walk_ms": split["walk_ms"],
                 "clocks_a_cycle": split["clocks_a_cycle"], "main_path": False})
    log(f"core (b): codec on deepseek-7b w_down [{W_DOWN_SHAPE[0]}, {W_DOWN_SHAPE[1]}] bf16, "
        f"{cut['zero_share']:.1%} zero: encode {cut['encode_s']:.3f} s, decode {cut['decode_s']:.3f} s, round trip "
        f"bit-exact; {cut['rows']} rows -> {cut['n_cycles']} scheduled rows; the encode's schedule launch "
        f"{timing['kernel_ms']:.1f} ms (bounds: bytes {timing['bound_ms']:.4f} ms, serial chain "
        f"{timing['chain_bound_ms']:.4f} ms at {clock_hz / 1e6:.0f} MHz), its first {timing['cycles_checked']} cycles "
        f"== the plain loop's on the first {CORE_ROWS} rows; plain loop {timing['plain_ms_per_row']:.4f} ms a row "
        f"there (~{timing['plain_ms_extrapolated'] / 60e3:.1f} min at full size, not run); "
        f"{cut['compressed_bytes']} compressed bytes vs {cut['dense_bytes']} dense "
        f"({cut['compressed_bytes'] / cut['dense_bytes']:.3f}x)")
    log(f"core: main-path launches (c)+(b)+(d)+(e)+(g): {launches}; phase {time.perf_counter() - t0:.1f} s")
    return {"rows": rows, "tile_rows": tile_rows + cycle_model["rows"], "macs": macs, "quickstart": quick,
            "codec": {**cut, **timing, **split}, "ops": ops_run, "validate": validate,
            "cycle_model": cycle_model, "cycle_model_timing": cm_timing, "launches": launches,
            "sm_clock_mhz": clock_hz / 1e6, "seconds": time.perf_counter() - t0}


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

    if sys.argv[1:2] == ["--profiler-stress"]:
        _build.library()
        profiler_stress(int(sys.argv[2]))
        print(card)
        return 0

    _build.library()
    log(f"build: nvcc sm_90a kernels ready in {_build.build_seconds:.1f} s")
    for line in ptxas_lines(_build.ptxas_report):
        log(f"ptxas: {line}")
    dry = start_dry_run()  # (a) runs on the host's cores beside the card phases
    try:
        return _phases(t_start, card, name, bw, dry)
    finally:
        stop_dry_run(dry)


def _phases(t_start, card, name, bw, dry) -> int:
    """Every phase after the build, (a) of the dry-run phase running in the
    background as ``dry``; prints the result lines."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    log("kernels: each against its plain PyTorch version on the card")
    rows, launch_check = kernel_phase(bw)
    log("sampler: JAX's key step and Gumbel-max draw against its plain version on the card")
    sampler_rows, sampler_check = sampler_phase(bw)
    log(f"init: the normal fill against its plain version on the card, JAX's draws, full-width {INIT_ARCH}")
    init_rows, init = init_phase(bw)
    log("core: the schedule kernel against its plain loop; the codec, the quickstart, the public ops and plan "
        "validation on the card")
    core = core_phase(bw)
    params, cfg, prompts, serve = serve_phase()
    ref_l2, top1 = reference_phase(params, cfg, prompts)
    log(f"sampled serve: the same requests at temperature {SERVE_TEMPERATURE}, JAX's per-request key streams, "
        "eager and through the decode graph")
    sampled = sampled_serve_phase(params, cfg, prompts, serve)
    log("grid kernels: v2/v1 against the ragged kernel and the plain version; block_zero_mask")
    grid_rows = grid_kernel_phase(bw)
    tuned_db, tune = tune_phase()
    auto = serve_auto_phase(params, cfg, prompts, tuned_db, serve["greedy_tokens"])
    del params
    torch.cuda.empty_cache()
    log(f"moe serve: {MOE_ARCH} relu at full width, {MOE_LAYERS} layers, eager and through the decode graph")
    moe = moe_serve_phase()
    log(f"dsv2 serve: {DSV2_ARCH} relu at full width, {DSV2_LAYERS} layers, MLA attention, eager and through "
        "the decode graph")
    dsv2 = moe_serve_phase(DSV2_ARCH, DSV2_LAYERS, tag="dsv2 serve")
    log(f"ssm serve: {SSM_ARCH} as registered, whole, eager and through the decode graph")
    ssm = whole_serve_phase(get_config(SSM_ARCH), "ssm serve")
    log(f"hybrid serve: {HYBRID_ARCH} as registered, whole, eager and through the decode graph")
    hybrid = whole_serve_phase(get_config(HYBRID_ARCH), "hybrid serve")
    log(f"starcoder2 serve: {STARCODER_ARCH} as registered, whole, eager and through the decode graph")
    starcoder = whole_serve_phase(get_config(STARCODER_ARCH), "starcoder2 serve")
    log(f"gemma2 serve: {GEMMA_ARCH} relu, whole, eager and through the decode graph, then a "
        f"{LONG_PROMPT}-token request")
    gemma = whole_serve_phase(dataclasses.replace(get_config(GEMMA_ARCH), activation="relu"), "gemma2 serve",
                              then=gemma2_long_request)
    log(f"kv-int8 serve: deepseek-7b relu with the int8 KV cache, {KV_MAX_LEN} rows a slot")
    kv8 = whole_serve_phase(dataclasses.replace(get_config("deepseek-7b"), activation="relu", kv_cache_quant=True),
                            "kv-int8 serve", max_len=KV_MAX_LEN, then=kv_int8_checks)
    log(f"qwen2-vl run: {VL_ARCH} relu at full width, {VL_LAYERS} layers, M-RoPE over an image prompt, "
        "through prefill and decode_step")
    vl = frontend_phase(dataclasses.replace(get_config(VL_ARCH), activation="relu", num_layers=VL_LAYERS),
                        "qwen2-vl run")
    log(f"musicgen run: {MG_ARCH} as registered, whole, one head per codebook, through prefill and decode_step")
    mg = frontend_phase(get_config(MG_ARCH), "musicgen run")
    log("launch serve: repro_torch.launch.serve.main at full width with a poisoned slot")
    launch_serve = launch_serve_phase()
    log(f"train kernels: the backward products at {TRAIN_TOKENS} tokens, fp32 operands, bf16 output")
    train_rows, train_launch = train_kernel_phase(bw)
    log("planner: every mode at the path's shapes against the plain chain on the card")
    planner_rows, planner_launch = planner_phase(bw)
    train = train_phase()
    log(f"ssm train: {SSM_ARCH} through make_train_step on cuda, {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    ssm_train = ssm_train_phase(SSM_ARCH, "ssm train")
    log(f"hybrid train: {HYBRID_ARCH} through make_train_step on cuda, {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    hybrid_train = ssm_train_phase(HYBRID_ARCH, "hybrid train")
    log(f"qwen2-vl train: {VL_ARCH} relu at full width through make_train_step on cuda, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} M-RoPE embedding positions")
    vl_train = frontend_train_phase(dataclasses.replace(get_config(VL_ARCH), activation="relu"), "qwen2-vl train")
    log(f"musicgen train: {MG_ARCH} as registered through make_train_step on cuda, {TRAIN_BATCH} x {TRAIN_SEQ} "
        "frame embeddings")
    mg_train = frontend_train_phase(get_config(MG_ARCH), "musicgen train")
    log("examples: the port's five examples through their main on the card")
    examples = examples_phase()
    log(f"launch: repro_torch.launch.train.main on qwen3-4b cut to {LAUNCH_LAYERS} layers: checkpoint, "
        "resume, dynamic sparse training")
    launch = launch_train_phase()
    log("sharded: each rank's local step of the sharded SpMM on the card, the expert-parallel decode branch, "
        "an NCCL group of world size 1")
    sharded = sharded_phase(bw)
    log(f"sharded model: deepseek-7b relu at full width under tensor parallel {SM_TP}, the ranks' local steps in "
        "turn; the sharded train step and engine on an NCCL group of one rank; restore(shardings=)")
    smodel = sharded_model_phase(bw)
    log(f"sharded family: deepseek-v2 relu, mamba2, zamba2 and qwen2-vl relu at full width under tensor parallel "
        f"{SM_TP}, the ranks' local steps in turn; the sharded engines and mamba2's step on an NCCL group of one rank")
    sfamily = sharded_family_phase(bw)
    log(f"sharded dst: dynamic sparse training on a mesh: deepseek-7b relu's layer and head at full width under "
        f"tensor parallel {SM_TP} and (2, 2), the ranks' slices in turn; qwen3-4b relu cut to {LAUNCH_LAYERS} "
        "layers through the dynamic sparse step on an NCCL group of one rank against the unsharded run")
    sdst = sharded_dst_phase(bw)
    log("dry run: the port's dry run on the production meshes, held to a real step; item 14e at full width")
    dry_run = dry_run_phase(bw, dry)

    def grouped(counts):
        """Launches per entry of the kernels line: v2 and v1 together, and
        ``block_zero_mask`` (row 5's kernel, ``td_plan_kernel``) over every
        planner mode."""
        out = dict(counts)
        for w in ("planned", "fused"):
            out[f"tensordash_matmul_{w}[v2/v1]"] = (counts[f"tensordash_matmul_{w}[v2]"]
                                                   + counts[f"tensordash_matmul_{w}[v1]"])
        out["block_zero_mask"] = sum(counts[c] for c in PLANNER)
        return out

    # the serving path's runs: eager, through the graph (clean and the two
    # fault replays; a capture's launches once per replay), the launcher, the
    # MoE, MLA, SSM, hybrid, starcoder2, gemma2 and int8-cache serve runs
    # (eager and graph) and the frontend runs (prefill and eager decode)
    moe_runs = grouped({k: moe["launches"][k] + moe["graph"]["device_launches"][k] for k in moe["launches"]})
    dsv2_runs = grouped({k: dsv2["launches"][k] + dsv2["graph"]["device_launches"][k] for k in dsv2["launches"]})
    whole_runs = {tag: grouped({k: r["launches"][k] + r["graph"]["device_launches"][k] for k in r["launches"]})
                  for tag, r in (("ssm", ssm), ("hybrid", hybrid), ("starcoder2", starcoder), ("gemma2", gemma),
                                 ("kv_int8", kv8))}
    frontend_runs = {tag: grouped(r["launches"]) for tag, r in (("qwen2vl", vl), ("musicgen", mg))}
    serve_counts = dict(serve["launches"])
    for extra in (serve["graph"]["device_launches"], *(f["device_launches"] for f in serve["faults"]),
                  launch_serve["launches"], moe["launches"], moe["graph"]["device_launches"],
                  dsv2["launches"], dsv2["graph"]["device_launches"],
                  *(c for r in (ssm, hybrid, starcoder, gemma, kv8) for c in (r["launches"],
                                                                              r["graph"]["device_launches"])),
                  vl["launches"], mg["launches"]):
        for k, v in extra.items():
            serve_counts[k] += v
    serve_runs = grouped(serve_counts)
    pinned = grouped(auto["pinned_v2"]["launches"])
    for fam in ("tensordash_matmul_planned[v2/v1]", "tensordash_matmul_fused[v2/v1]"):
        serve_runs[fam] = pinned[fam]  # the v2/v1 kernels serve under the v2-pinned DB
    train_runs = grouped({k: sum(st["launches"][k] for run in (train, ssm_train, hybrid_train, vl_train, mg_train)
                                 for st in run["steps"]) for k in train["launches_per_step"]})
    example_counts = {k: sum(r["launches"].get(k, 0) for r in examples.values())
                      for k in (*train["launches_per_step"], "td_schedule_kernel", "td_tile_kernel", _SAMPLE)}
    example_runs_ = grouped(example_counts)
    per_train_step = grouped(train["launches_per_step"])
    launch_runs = grouped({k: launch["a"]["launches"][k] + launch["c"]["launches"][k]
                           for k in launch["a"]["launches"]})
    per_launch_step = {tag: grouped(w) for tag, w in launch["launches_per_step"].items()}
    sharded_runs = grouped(sharded["launches"])
    smodel_runs = grouped(smodel["launches"])
    sfamily_runs = grouped(sfamily["launches"])
    sdst_runs = grouped(sdst["launches"])
    core_runs = grouped({k: v for k, v in core["launches"].items()
                         if k not in ("td_schedule_kernel", "td_tile_kernel")})
    kernels = []
    for kname in REPLACES:
        mine = [r for r in rows + grid_rows + train_rows + planner_rows + sharded["rows"] + smodel["kernel_rows"]
                + sfamily["kernel_rows"] + sdst["kernel_rows"] if r["kernel"] == kname]
        head = next(r for r in mine if r["main_path"])  # the first main-path shape
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE if kname in SPMM else PLANNER_SOURCE,
            "replaces": REPLACES[kname],
            "launches": (serve_runs[kname] + train_runs[kname] + launch_runs[kname] + sharded_runs[kname]
                         + core_runs[kname] + smodel_runs[kname] + sfamily_runs[kname] + sdst_runs[kname]
                         + example_runs_[kname]),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"], "shape": head["shape"],
            "launches_serve": serve_runs[kname], "launches_moe_serve": moe_runs[kname],
            "launches_dsv2_serve": dsv2_runs[kname],
            **{f"launches_{tag}_serve": runs[kname] for tag, runs in whole_runs.items()},
            **{f"launches_{tag}_run": runs[kname] for tag, runs in frontend_runs.items()},
            "launches_per_train_step": per_train_step[kname],
            "launches_per_ssm_train_step": grouped(ssm_train["launches_per_step"])[kname],
            "launches_per_hybrid_train_step": grouped(hybrid_train["launches_per_step"])[kname],
            "launches_per_qwen2vl_train_step": grouped(vl_train["launches_per_step"])[kname],
            "launches_per_musicgen_train_step": grouped(mg_train["launches_per_step"])[kname],
            "launches_examples": example_runs_[kname],
            "launches_launch_train": launch_runs[kname],
            "launches_per_launch_step": {tag: w[kname] for tag, w in per_launch_step.items()},
            "launches_sharded_local_steps": sharded_runs[kname],
            "launches_sharded_model": smodel_runs[kname],
            "launches_sharded_family": sfamily_runs[kname],
            "launches_sharded_dst": sdst_runs[kname],
            "launches_core": core_runs[kname],
        })
    head = next(r for r in core["rows"] if r["main_path"])
    kernels.append({
        "name": "td_schedule_kernel", "route": "cuda", "source": SCHEDULE_SOURCE, "replaces": SCHEDULE_REPLACES,
        "launches": core["launches"]["td_schedule_kernel"] + example_counts["td_schedule_kernel"],
        "launches_examples": example_counts["td_schedule_kernel"],
        "max_abs_err": max(r["max_abs_err"] for r in core["rows"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape": head["shape"], "launches_core": core["launches"]["td_schedule_kernel"],
        "ms_64_streams": head["ms_64_streams_half_dense"], "w_down_ms": core["codec"]["kernel_ms"],
        "w_down_bound_ms": core["codec"]["bound_ms"], "chain_bound_ms": head["chain_bound_ms"],
        "w_down_chain_bound_ms": core["codec"]["chain_bound_ms"],
        "w_down_split_chain_bound_ms": core["codec"]["split_chain_bound_ms"],
        "w_down_walk_ms": core["codec"]["walk_ms"], "clocks_a_cycle": core["codec"]["clocks_a_cycle"],
        "plain_ms_per_row": core["codec"]["plain_ms_per_row"],
    })
    head = next(r for r in core["tile_rows"] if r["main_path"])
    kernels.append({
        "name": "td_tile_kernel", "route": "cuda", "source": SCHEDULE_SOURCE, "replaces": TILE_REPLACES,
        "launches": core["launches"]["td_tile_kernel"] + example_counts["td_tile_kernel"],
        "launches_examples": example_counts["td_tile_kernel"],
        "max_abs_err": max(r["max_abs_err"] for r in core["tile_rows"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape": head["shape"], "launches_core": core["launches"]["td_tile_kernel"],
        "chain_bound_ms": head["chain_bound_ms"], "model_speedup_s": core["cycle_model"]["card_s"],
        "model_speedup_host_s": core["cycle_model"]["host_s"],
        "model_speedup_per_conv_host_s": core["cycle_model"]["per_conv_host_s"],
        "whole_conv_ms": core["tile_rows"][-1]["ms"], "whole_conv_bound_ms": core["tile_rows"][-1]["bound_ms"],
        "whole_conv_chain_bound_ms": core["tile_rows"][-1]["chain_bound_ms"],
        **{k: head[k] for k in TILE_RUN_KEYS},
        "whole_conv_clocks_a_cycle": core["tile_rows"][-1]["clocks_a_cycle"],
        **{tag: {k: core["tile_rows"][i][k] for k in ("shape", "ms", "pack", "pack_ms", "clocks_a_cycle", "bound_ms")}
           for tag, i in (("ragged", 0), ("deep", 2))},
        "model_speedup_timing": {k: v for k, v in core["cycle_model_timing"].items() if k != "ragged"},
    })
    head = next(r for r in sampler_rows if r["main_path"])
    kernels.append({
        "name": _SAMPLE, "route": "cuda", "source": SAMPLE_SOURCE, "replaces": SAMPLE_REPLACES,
        "launches": sampled["launches"][_SAMPLE] + example_counts[_SAMPLE],
        "launches_sampled_serve": sampled["launches"][_SAMPLE], "launches_examples": example_counts[_SAMPLE],
        "launches_per_decode_step": sampled["graph"]["replay_launches"][_SAMPLE] / CHUNK,
        "max_abs_err": max(r["max_abs_err"] for r in sampler_rows), "cases_bit_equal": sampler_check["cases"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "library": "torch.multinomial (another stream)", "shape": head["shape"],
        "by_vocab": {r["shape"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                     for r in sampler_rows},
        **{k: sampler_check["fixed"][k] for k in ("floor_ms", "skipped_ms", "intercept_ms", "ps_a_draw")},
    })
    head = next(r for r in init_rows if r["main_path"])
    kernels.append({
        "name": "td_normal_kernel", "route": "cuda", "source": INIT_SOURCE, "replaces": INIT_REPLACES,
        "launches": init["launches"], "max_abs_err": max(r["max_abs_err"] for r in init_rows),
        "max_fp32_ulps": max(r["max_ulps"] for r in init_rows if r["dtype"] == "torch.float32"),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape": head["shape"],
        "init_draws": init["draws"], "init_kernel_ms": init["kernel_ms"], "init_bound_ms": init["bound_ms"],
        "init_bound_by": init["bound_by"], "init_device_ms": init["init_ms"], "init_host_s": init["init_host_s"],
        "randn_init_ms": init["randn_init_ms"], "jax_anchors": init["anchors"],
    })
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "cases": rows + grid_rows, "launch_check": launch_check, "serve": serve,
         "ptxas": ptxas_lines(_build.ptxas_report), "reference_rel_l2": ref_l2,
         "reference_top1": top1, "sampler_cases": sampler_rows, "sampler_check": sampler_check,
         "init_cases": init_rows, "init": init,
         "sampled_serve": sampled, "tune": tune, "serve_auto": auto, "train_cases": train_rows,
         "train_launch_check": train_launch, "planner_cases": planner_rows,
         "planner_launch_check": planner_launch, "train": train, "launch_train": launch,
         "launch_serve": launch_serve, "moe_serve": moe, "dsv2_serve": dsv2, "ssm_serve": ssm,
         "hybrid_serve": hybrid, "starcoder2_serve": starcoder, "gemma2_serve": gemma, "kv_int8_serve": kv8,
         "qwen2vl_run": vl, "musicgen_run": mg,
         "ssm_train": ssm_train, "hybrid_train": hybrid_train, "qwen2vl_train": vl_train, "musicgen_train": mg_train,
         "examples": examples, "sharded": sharded, "sharded_model": smodel,
         "sharded_family": sfamily, "sharded_dst": sdst,
         "core": core, "dry_run": dry_run,
         "seconds": time.perf_counter() - t_start}, indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
