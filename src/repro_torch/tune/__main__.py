"""Offline TuningDB pre-population CLI (port of ``repro/tune/__main__.py``).

    python -m repro_torch.tune --configs smoke,deepseek_7b
    python -m repro_torch.tune --configs smoke --db TUNING_db_torch.json --reps 10

measures on the card (``--backend cuda --device cuda``, the defaults) and
writes the port's own DB, keyed to the card model; ``--backend reference
--device cpu`` measures the plain executors on the CPU.

``smoke`` sweeps the standard micro-bench shapes; a registered
architecture name (dashes or underscores) sweeps its reduced FFN
contraction shapes — the products the kernel serves for that model, at the
reduced config.  The DB is written atomically
after the sweep; re-running refines in place (measured cells are
overwritten with fresh measurements, never silently kept).
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.tune.db import DEFAULT_DB_FILENAME, TuningDB, platform_of
from repro_torch.tune.search import (
    STANDARD_DENSITIES,
    STANDARD_MICRO_SHAPES,
    seed_from_history,
    tune_cells,
)


def config_shapes(name: str, tokens: int = 64) -> tuple:
    """The matmul shapes one architecture's FFN stack exercises, at the
    reduced (CI-runnable) config: up-projection and down-projection for a
    ``tokens``-row microbatch."""
    from repro_torch.configs import get_config, reduce_config

    cfg = reduce_config(get_config(name))
    d_ff = getattr(cfg, "d_ff", None) or cfg.d_model * 4
    return (
        (tokens, cfg.d_model, d_ff),   # x @ w_up
        (tokens, d_ff, cfg.d_model),   # h @ w_down (the sparse product)
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.tune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--configs", default="smoke",
                   help="comma list: 'smoke' (standard micro shapes) and/or "
                        "registered architecture names (underscores ok)")
    p.add_argument("--db", default=DEFAULT_DB_FILENAME,
                   help="TuningDB JSON path (default: %(default)s)")
    p.add_argument("--densities", default=None,
                   help="comma list of densities to sweep "
                        f"(default: {','.join(map(str, STANDARD_DENSITIES))})")
    p.add_argument("--ops", default="matmul",
                   help="comma list of op keys to tune (default: matmul)")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--backend", default="cuda",
                   help="backend to measure on (default: %(default)s, the "
                        "Hopper kernels)")
    p.add_argument("--device", default="cuda",
                   help="device the operands lie on (default: %(default)s)")
    p.add_argument("--reps", type=int, default=10,
                   help="best-of-N reps per candidate (default: 10)")
    p.add_argument("--keep", type=int, default=10,
                   help="candidates kept after the perf_model prior prune")
    p.add_argument("--tokens", type=int, default=64,
                   help="microbatch rows for architecture-derived shapes")
    p.add_argument("--seed-from-history", metavar="JSONL", default=None,
                   help="seed grid-family preferences from a "
                        "BENCH_history.jsonl before measuring")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    log = (lambda *a, **k: None) if args.quiet else print
    db = TuningDB.load(args.db, platform=platform_of(args.device))
    if args.seed_from_history:
        n = seed_from_history(db, args.seed_from_history, log=log)
        log(f"seeded {n} cells from {args.seed_from_history}")

    shapes = []
    for name in args.configs.split(","):
        name = name.strip()
        if not name:
            continue
        if name == "smoke":
            shapes.extend(STANDARD_MICRO_SHAPES)
        else:
            # registry names use dashes; accept CLI-friendly underscores
            shapes.extend(config_shapes(name.replace("_", "-"),
                                        tokens=args.tokens))
    seen = set()
    shapes = [s for s in shapes if not (s in seen or seen.add(s))]
    if not shapes:
        p.error("--configs selected no shapes")

    densities = (
        STANDARD_DENSITIES if args.densities is None
        else tuple(float(d) for d in args.densities.split(","))
    )
    stored = tune_cells(
        db, shapes,
        densities=densities,
        ops=tuple(o.strip() for o in args.ops.split(",") if o.strip()),
        dtype=getattr(torch, args.dtype),
        backend=args.backend, device=args.device, reps=args.reps,
        keep=args.keep, log=log,
    )
    path = db.save(args.db)
    log(f"stored {stored} cells -> {path} ({len(db)} total, "
        f"platform={db.platform})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
