"""Assemble the dry-run appendix from a baseline and a current results file
(port of ``repro/launch/finalize_report.py``: the same sections, from the
port's files, written to ``--out``).

    PYTHONPATH=src python -m repro_torch.launch.finalize_report \\
        --baseline results/dryrun_torch_baseline.json --current results/dryrun_torch.json \\
        --out results/dryrun_torch_appendix.md

``--baseline`` is a complete single-pod pass; ``--current`` holds re-measured
cells and the multi-pod pass.  The appendix goes to ``--out`` alone: this
never writes the JAX package's ``EXPERIMENTS.md`` or ``results/dryrun.json``.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.report import dryrun_table, fmt_s, roofline_table

MARK = "## §Appendix: dry-run & roofline tables"

#: files of the JAX package's report, never written here
JAX_FILES = ("EXPERIMENTS.md", "dryrun.json", "dryrun_baseline.json")


def appendix(base: dict, cur: dict) -> str:
    """The appendix text (JAX's sections, in its order) from the baseline
    and current results."""
    out = [MARK, ""]
    out.append("### Roofline, single-pod 16x16 / 256 chips — framework baseline (all cells)\n")
    out.append(roofline_table(base, "16x16"))

    out.append("\n### Post-optimization cells (re-measured after §Perf iterations 3-5)\n")
    out.append("| cell | compute | collective | useful ratio |")
    out.append("|---|---|---|---|")
    for k in sorted(cur):
        if cur[k].get("mesh") != "16x16" or not cur[k].get("ok") or k not in base:
            continue
        b, a = base[k]["roofline"], cur[k]["roofline"]
        if abs(a["flops"] - b["flops"]) < 1e-6 and abs(a["coll_bytes"] - b["coll_bytes"]) < 1e-6:
            continue
        ub = base[k].get("useful_flops_ratio")
        ua = cur[k].get("useful_flops_ratio")
        out.append(
            f"| {k.rsplit('|', 1)[0].replace('|', ' x ')} "
            f"| {fmt_s(b['compute_s'])} -> {fmt_s(a['compute_s'])} "
            f"| {fmt_s(b['collective_s'])} -> {fmt_s(a['collective_s'])} "
            f"| {ub and round(ub, 3)} -> {ua and round(ua, 3)} |"
        )

    ok = sum(1 for r in cur.values() if r.get("mesh") == "2x16x16" and r.get("ok"))
    tot = sum(1 for r in cur.values() if r.get("mesh") == "2x16x16")
    out.append(f"\n### Multi-pod pass, 2x16x16 / 512 chips ({ok}/{tot} cells compile)\n")
    out.append(
        "Proves the `pod` axis shards every program (lower + compile succeeds"
        " per cell; scan-mode compiles — per-layer roofline extrapolation is"
        " single-pod only, per the assignment).\n"
    )
    out.append(dryrun_table(cur, "2x16x16"))

    out.append("\n### Dry-run detail, single-pod (memory analysis per device)\n")
    out.append(dryrun_table(base, "16x16"))
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default="results/dryrun_torch_baseline.json")
    ap.add_argument("--current", default="results/dryrun_torch.json")
    ap.add_argument("--out", default="results/dryrun_torch_appendix.md")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) in JAX_FILES:
        ap.error(f"--out {args.out}: a file of the JAX package's report")
    with open(args.baseline) as f:
        base = json.load(f)
    with open(args.current) as f:
        cur = json.load(f)
    text = appendix(base, cur)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    ok = sum(1 for r in cur.values() if r.get("mesh") == "2x16x16" and r.get("ok"))
    tot = sum(1 for r in cur.values() if r.get("mesh") == "2x16x16")
    print(f"appendix written to {args.out} ({ok}/{tot} multipod cells ok)")


if __name__ == "__main__":
    main()
