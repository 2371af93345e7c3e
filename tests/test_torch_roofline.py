"""The port's roofline terms, collective counts and report tables against
the JAX package's ``launch/roofline.py``, ``report.py`` and
``finalize_report.py``.

* ``RooflineTerms`` gives JAX's formulas with JAX's constants set to the
  H100's: for an all-bf16 program whose collectives stay inside a host the
  two agree term for term; fp32 FLOPs go at 67 TFLOP/s and collectives of a
  group that spans hosts at 50 GB/s.
* ``collective_bytes`` keeps JAX's operand convention: the port's count of
  calls (result bytes and group size) equals JAX's parse of the same calls
  as HLO text.
* ``dryrun_table``, ``roofline_table`` and the appendix render text equal
  to JAX's for the same results dict (JAX's report modules import no JAX).
"""
import json

import numpy as np
import pytest

from repro_torch.launch import finalize_report as TF
from repro_torch.launch import report as TR
from repro_torch.launch import roofline as RL


@pytest.fixture
def jax_h100(monkeypatch):
    """JAX's roofline module with its constants set to the H100's rates."""
    from repro.launch import roofline as JR

    monkeypatch.setattr(JR, "PEAK_FLOPS", RL.H100.peak("bfloat16"))
    monkeypatch.setattr(JR, "HBM_BW", RL.H100.hbm_bw)
    monkeypatch.setattr(JR, "LINK_BW", RL.H100.nvlink_bw)
    return JR


def test_published_rates():
    hw = RL.H100
    assert (hw.peak("bfloat16"), hw.peak("float16"), hw.peak("float32")) == (989e12, 989e12, 67e12)
    assert (hw.hbm_bw, hw.hbm_bytes, hw.nvlink_bw, hw.inter_host_bw, hw.ranks_per_host) == (
        3.35e12, 80e9, 450e9, 50e9, 8)
    with pytest.raises(KeyError, match="float64"):
        hw.peak("float64")


@pytest.mark.parametrize("seed", range(5))
def test_terms_equal_jax_formulas_at_h100_rates(jax_h100, seed):
    rng = np.random.default_rng(seed)
    flops, hbm, coll = (float(x) for x in rng.uniform(1e9, 1e16, 3))
    chips = int(rng.choice([1, 8, 256, 512]))
    ours = RL.RooflineTerms(flops=flops, hbm_bytes=hbm, coll_bytes=coll, chips=chips)
    jax_terms = jax_h100.RooflineTerms(flops=flops, hbm_bytes=hbm, coll_bytes=coll, chips=chips)
    for k in ("compute_s", "memory_s", "collective_s", "dominant", "bound_s"):
        assert getattr(ours, k) == getattr(jax_terms, k), k
    mine, theirs = ours.as_dict(), jax_terms.as_dict()
    assert {k: mine[k] for k in theirs} == theirs


def test_compute_term_sums_dtypes_over_their_peaks_and_collectives_over_their_links():
    t = RL.RooflineTerms(flops=3e15, hbm_bytes=0.0, coll_bytes=5e11, chips=2,
                         flops_by_dtype=(("bfloat16", 2e15), ("float32", 1e15)), coll_bytes_inter=1e11)
    assert t.compute_s == pytest.approx(2e15 / (2 * 989e12) + 1e15 / (2 * 67e12), rel=1e-15)
    assert t.collective_s == pytest.approx(4e11 / (2 * 450e9) + 1e11 / (2 * 50e9), rel=1e-15)
    assert t.dominant == "compute" and t.bound_s == t.compute_s
    assert t.as_dict()["flops_by_dtype"] == {"bfloat16": 2e15, "float32": 1e15}


def test_groups_spanning_hosts():
    assert not RL.spans_hosts(range(8))
    assert not RL.spans_hosts(range(8, 16))
    assert RL.spans_hosts(range(16))  # a model group of 16: two hosts
    assert RL.spans_hosts(range(0, 256, 16))  # a data group: strided over hosts
    assert not RL.spans_hosts([0])


def _hlo(kind, result_dims, dtype, groups, group_size):
    shape = ",".join(map(str, result_dims))
    return (f"  %x.1 = {dtype}[{shape}]{{1,0}} {kind}(%p.0), channel_id=1, "
            f"replica_groups=[{groups},{group_size}]<=[{groups * group_size}], use_global_device_ids=true")


def test_collective_bytes_keep_jax_operand_convention():
    from repro.launch.roofline import collective_bytes as jax_collective_bytes

    nb = {"bf16": 2, "f32": 4}
    calls, lines = [], []
    for kind, dims, dt, g in [("all-gather", (64, 128), "bf16", 16), ("all-reduce", (8, 4096), "f32", 16),
                              ("reduce-scatter", (4, 512), "f32", 16), ("all-to-all", (16, 8, 64), "bf16", 16),
                              ("collective-permute", (3, 5), "f32", 2), ("all-gather", (32,), "f32", 32)]:
        lines.append(_hlo(kind, dims, dt, 256 // g, g))
        calls.append((kind, int(np.prod(dims)) * nb[dt], g))
    assert RL.collective_bytes(calls) == jax_collective_bytes("\n".join(lines))
    assert set(RL.collective_bytes([])) == set(RL.COLLECTIVES)


def _results():
    """A results dict of the dry run's shape: ok cells on both meshes, a
    cell with no useful ratio and a failed one."""
    rng = np.random.default_rng(1)
    out = {}
    for arch in ("deepseek-7b", "zamba2-2.7b"):
        for shape, kind in (("train_4k", "train"), ("decode_32k", "decode"), ("long_500k", "decode")):
            for mesh, chips, tag in (("16x16", 256, "pod"), ("2x16x16", 512, "multipod")):
                terms = RL.RooflineTerms(flops=float(rng.uniform(1e14, 1e18)), hbm_bytes=float(rng.uniform(1e12, 1e15)),
                                         coll_bytes=float(rng.uniform(1e10, 1e14)), chips=chips)
                out[f"{arch}|{shape}|{tag}"] = {
                    "arch": arch, "shape": shape, "mesh": mesh, "chips": chips, "kind": kind,
                    "lower_s": 0.1, "compile_s": round(float(rng.uniform(0, 30)), 1),
                    "memory_adj_s": float(rng.uniform(1e-5, 1)),
                    "mem": {"argument_bytes": int(rng.integers(1, 1 << 36)), "temp_bytes": int(rng.integers(1, 1 << 36)),
                            "output_bytes": 12, "peak_bytes": int(rng.integers(1, 1 << 37))},
                    "roofline": terms.as_dict(), "model_flops": float(rng.uniform(1e14, 1e18)),
                    "useful_flops_ratio": None if shape == "long_500k" else float(rng.uniform(0, 1)),
                    "fits_80gb": True, "ok": True,
                }
    out["zamba2-2.7b|prefill_32k|pod"] = {"arch": "zamba2-2.7b", "shape": "prefill_32k", "mesh": "16x16",
                                          "ok": False, "error": "RuntimeError: " + "x" * 80}
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_tables_equal_jax(mesh):
    from repro.launch import report as JR

    res = _results()
    assert TR.dryrun_table(res, mesh) == JR.dryrun_table(res, mesh)
    assert TR.roofline_table(res, mesh) == JR.roofline_table(res, mesh)
    for x in (None, 0, 3.5e-5, 2e-3, 0.25, 12.0):
        assert TR.fmt_s(x) == JR.fmt_s(x)
    for b in (None, 0, 1000, 5 << 20, 3 << 40, 1 << 62):
        assert TR.fmt_bytes(b) == JR.fmt_bytes(b)


def test_appendix_equals_jax(tmp_path, monkeypatch):
    """JAX's ``finalize_report.main`` reads ``results/dryrun_baseline.json``
    and ``results/dryrun.json`` under the working directory and rewrites
    ``EXPERIMENTS.md`` after its marker: run it in a temporary directory and
    hold the port's appendix to what it wrote."""
    from repro.launch import finalize_report as JF

    base = {k: v for k, v in _results().items() if k.endswith("|pod")}
    cur = _results()
    for k in ("deepseek-7b|train_4k|pod", "zamba2-2.7b|decode_32k|pod"):  # re-measured cells
        cur[k] = json.loads(json.dumps(cur[k]))
        cur[k]["roofline"]["flops"] *= 0.5
        cur[k]["roofline"]["compute_s"] *= 0.5
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "dryrun_baseline.json").write_text(json.dumps(base))
    (tmp_path / "results" / "dryrun.json").write_text(json.dumps(cur))
    (tmp_path / "EXPERIMENTS.md").write_text("# head\n\n")
    monkeypatch.chdir(tmp_path)
    JF.main()
    written = (tmp_path / "EXPERIMENTS.md").read_text()
    assert written == "# head\n\n" + TF.appendix(base, cur)
    # the port's CLI writes --out, and refuses the JAX package's files
    (tmp_path / "results" / "b.json").write_text(json.dumps(base))
    (tmp_path / "results" / "c.json").write_text(json.dumps(cur))
    TF.main(["--baseline", "results/b.json", "--current", "results/c.json", "--out", "out/appendix.md"])
    assert (tmp_path / "out" / "appendix.md").read_text() == TF.appendix(base, cur)
    for bad in ("EXPERIMENTS.md", "results/dryrun.json"):
        with pytest.raises(SystemExit):
            TF.main(["--baseline", "results/b.json", "--current", "results/c.json", "--out", bad])


def test_report_main_prints_every_mesh(tmp_path, capsys):
    path = tmp_path / "r.json"
    path.write_text(json.dumps(_results()))
    TR.main(["--json", str(path)])
    text = capsys.readouterr().out
    for mesh in ("16x16", "2x16x16"):
        assert f"### Roofline ({mesh})" in text and f"### Fit on H100 ({mesh})" in text
    assert "12/13 cells ok" in text
