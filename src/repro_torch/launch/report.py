"""Render the dry run's results into markdown tables (port of
``repro/launch/report.py``; the same tables, from the port's
``results/dryrun_torch.json``).

    PYTHONPATH=src python -m repro_torch.launch.report [--json results/dryrun_torch.json]

The tables are JAX's, column for column: a record's ``compile_s`` is the
seconds of the counted meta run (nothing compiles), and the roofline terms
are at H100 rates (:mod:`repro_torch.launch.roofline`).
"""
from __future__ import annotations

import argparse
import json


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 0.1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def dryrun_table(results: dict, mesh: str) -> str:
    rows = [
        "| arch | shape | kind | compile | args/dev | temp/dev | FLOPs (global) | HBM bytes | coll bytes |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        r = results[key]
        if r.get("mesh") != mesh:
            continue
        if not r.get("ok"):
            rows.append(f"| {r['arch']} | {r['shape']} | - | FAILED: {r.get('error', '')[:60]} | | | | | |")
            continue
        mem = r.get("mem", {})
        chips = r["chips"]
        rf = r["roofline"]
        rows.append(
            "| {arch} | {shape} | {kind} | {c}s | {args} | {temp} | {fl:.3e} | {hb} | {cb} |".format(
                arch=r["arch"], shape=r["shape"], kind=r["kind"], c=r["compile_s"],
                args=fmt_bytes((mem.get("argument_bytes") or 0)),
                temp=fmt_bytes((mem.get("temp_bytes") or 0)),
                fl=rf["flops"], hb=fmt_bytes(rf["hbm_bytes"] / chips) + "/dev",
                cb=fmt_bytes(rf["coll_bytes"] / chips) + "/dev",
            )
        )
    return "\n".join(rows)


def roofline_table(results: dict, mesh: str = "16x16") -> str:
    rows = [
        "| arch | shape | compute | memory | memory(adj) | collective | dominant | MODEL_FLOPS | useful ratio |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        r = results[key]
        if r.get("mesh") != mesh or not r.get("ok"):
            continue
        rf = r["roofline"]
        rows.append(
            "| {arch} | {shape} | {c} | {m} | {ma} | {co} | {dom} | {mf:.2e} | {ur} |".format(
                arch=r["arch"], shape=r["shape"],
                c=fmt_s(rf["compute_s"]), m=fmt_s(rf["memory_s"]),
                ma=fmt_s(r.get("memory_adj_s")), co=fmt_s(rf["collective_s"]),
                dom=rf["dominant"], mf=r["model_flops"],
                ur=f"{r['useful_flops_ratio']:.3f}" if r.get("useful_flops_ratio") else "-",
            )
        )
    return "\n".join(rows)


def fit_table(results: dict, mesh: str = "16x16") -> str:
    """The port's own table: each cell's dominant term, its bound and the
    per-rank peak against the H100's 80 GB."""
    rows = ["| arch | shape | dominant | bound | peak/rank (1e9 B) | fits 80 GB |", "|---|---|---|---|---|---|"]
    for key in sorted(results):
        r = results[key]
        if r.get("mesh") != mesh or not r.get("ok"):
            continue
        rf = r["roofline"]
        rows.append(f"| {r['arch']} | {r['shape']} | {rf['dominant']} | {fmt_s(rf['bound_s'])} "
                    f"| {r['mem']['peak_bytes'] / 1e9:.2f} | {'yes' if r['fits_80gb'] else 'no'} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)
    with open(args.json) as f:
        results = json.load(f)
    for mesh in ("16x16", "2x16x16"):
        if any(r.get("mesh") == mesh for r in results.values()):
            print(f"\n### Dry-run ({mesh})\n")
            print(dryrun_table(results, mesh))
            print(f"\n### Roofline ({mesh})\n")
            print(roofline_table(results, mesh))
            print(f"\n### Fit on H100 ({mesh})\n")
            print(fit_table(results, mesh))
    ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{ok}/{len(results)} cells ok")


if __name__ == "__main__":
    main()
