"""repro_torch.tune and ``Runtime(geometry="auto")`` against repro.tune, on
the CPU.

* The candidate lattice, the analytic prior, the synthetic operands, the
  buckets and the ``PolicyKey`` encoding equal the JAX package's.
* Both packages load the JAX package's checked-in ``TUNING_db.json``
  (read only) with platform ``"cpu"`` and resolve the same ``(bm, bk, bn,
  compact_grid)`` over a grid of call sites, through the DB and through
  ``Runtime._resolved`` (with and without a caller's plan).  Its cells never
  resolve on a card's platform, the port never writes that file, and the
  port's default DB is its own file.
* ``tune_matmul`` on the CPU stores a policy that passes the numerics
  gate, and ``seed_from_history`` seeds the JAX package's cells.
* The cuda form of the gate, driven by fake backends on the CPU: a
  candidate that is not bit-equal to its backend's ragged family, or
  outside the kernel tolerance of the plain executor, is rejected; one
  that differs from the plain executor only in the last bits passes.
"""
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro import tune as jtune
from repro.tune import search as jsearch
from repro_torch import runtime as trt
from repro_torch import tune as ttune
from repro_torch.runtime.backends import ReferenceBackend, _REGISTRY, register_backend
from repro_torch.tune import search as tsearch
from repro_torch.tune.__main__ import main as tune_main

ROOT = Path(__file__).resolve().parents[1]
JAX_DB = ROOT / "TUNING_db.json"
SHAPES = [(128, 256, 64), (64, 256, 128), (256, 512, 256), (4, 4096, 11008), (100, 96, 40)]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_candidates_and_prior_equal_jax(m, k, n):
    cands = tsearch.candidate_policies(m, k, n)
    assert cands == jsearch.candidate_policies(m, k, n)
    assert tsearch.default_policy(m, k, n) == jsearch.default_policy(m, k, n)
    for density in (None, 0.25, 1.0):
        for c in cands[:: max(1, len(cands) // 12)]:
            assert (tsearch.prior_score(m, k, n, density=density, **c)
                    == jsearch.prior_score(m, k, n, density=density, **c))


@pytest.mark.parametrize("density", [None, 0.25, 0.5, 1.0])
def test_make_operand_equals_jax(density):
    t = tsearch.make_operand(64, 96, density, seed=3, device="cpu")
    j = jsearch.make_operand(64, 96, density, seed=3)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_buckets_and_key_encoding_equal_jax():
    for d in (None, 0.0, 0.05, 0.2, 0.25, 0.2500001, 0.75, 1.0):
        assert ttune.density_bucket(d) == jtune.density_bucket(d)
    for dim in (1, 2, 3, 4, 5, 100, 128, 129, 11008):
        assert ttune.shape_bucket(dim) == jtune.shape_bucket(dim)
    tdb, jdb = ttune.TuningDB(platform="cpu"), jtune.TuningDB(platform="cpu")
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for density in (None, 0.3):
            tk = tdb.key(op="matmul_fused", m=100, k=4096, n=11008, dtype=tdt, density=density)
            jk = jdb.key(op="matmul_fused", m=100, k=4096, n=11008, dtype=jdt, density=density)
            assert tk.encode() == jk.encode()
            assert ttune.PolicyKey.decode(jk.encode()) == tk
    assert ttune.DENSITY_EDGES == jtune.DENSITY_EDGES and ttune.DB_VERSION == jtune.DB_VERSION


def _call_sites():
    for op in ("matmul", "matmul_fused"):
        for m, k, n in [(128, 256, 64), (100, 256, 64), (64, 256, 128), (256, 512, 256),
                        (200, 300, 250), (32, 64, 16)]:
            for density in (None, 0.2, 0.5, 0.9, 1.0):
                yield op, m, k, n, density


def _fields(policy):
    return None if policy is None else dataclasses.astuple(policy)


def test_checked_in_db_resolves_the_same_in_both_packages():
    before = JAX_DB.read_bytes()
    tdb = ttune.TuningDB.load(JAX_DB, platform="cpu")
    jdb = jtune.TuningDB.load(JAX_DB, platform="cpu")
    assert len(tdb) == len(jdb) == 12
    geom = dict(bm=8, bk=16, bn=16)
    trt_auto = trt.Runtime(backend="reference", device="cpu", geometry="auto", tuning_db=tdb, **geom)
    jrt_auto = jrt.Runtime(backend="reference", geometry="auto", tuning_db=jdb, **geom)
    hits = 0
    for op, m, k, n, density in _call_sites():
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            tp = tdb.resolve(op=op, m=m, k=k, n=n, dtype=tdt, density=density)
            jp = jdb.resolve(op=op, m=m, k=k, n=n, dtype=jdt, density=density)
            assert _fields(tp) == _fields(jp)
            hits += tp is not None
            for plan in (None, "caller's plan"):  # only its presence is read
                t = trt_auto._resolved(op, (m, k), (k, n), tdt, plan=plan, density=density)
                j = jrt_auto._resolved(op, (m, k), (k, n), jdt, plan=plan, density=density)
                assert (t.bm, t.bk, t.bn, t.compact_grid) == (j.bm, j.bk, j.bn, j.compact_grid)
    assert hits > 0  # the grid reaches measured cells, not only cold ones
    assert JAX_DB.read_bytes() == before


def test_cpu_cells_never_resolve_on_a_card_and_the_jax_db_is_never_written(tmp_path, monkeypatch):
    card = "cuda:NVIDIA H100 80GB HBM3"
    with pytest.warns(UserWarning, match="platform"):
        db = ttune.TuningDB.load(JAX_DB, platform=card)
    assert db.resolve(op="matmul", m=128, k=256, n=64, dtype=torch.float32) is None
    assert ttune.platform_of("cpu") == "cpu"
    with pytest.raises(ValueError, match="JAX package"):
        ttune.TuningDB.load(JAX_DB, platform="cpu").save()
    with pytest.raises(ValueError, match="JAX package"):
        ttune.TuningDB(platform="cpu").save(tmp_path / "TUNING_db.json")
    # discovery finds only the port's own file name
    monkeypatch.delenv("REPRO_TORCH_TUNING_DB", raising=False)
    monkeypatch.chdir(ROOT)
    found = ttune.default_db_path()
    assert found is None or Path(found).name == "TUNING_db_torch.json"
    mine = tmp_path / "TUNING_db_torch.json"
    ttune.TuningDB(platform="cpu").save(mine)
    monkeypatch.chdir(tmp_path)
    assert Path(ttune.default_db_path()) == mine
    assert len(ttune.default_db("cpu")) == 0
    # a policy measured on one card model never resolves on another
    other = ttune.TuningDB(platform="cuda:NVIDIA H200")
    other.store(other.key(op="matmul", m=4, k=64, n=64, dtype=torch.bfloat16),
                ttune.TunedPolicy(bm=4, bk=64, bn=64, compact_grid="v2"))
    other.save(tmp_path / "h200.json")
    with pytest.warns(UserWarning, match="platform"):
        on_h100 = ttune.TuningDB.load(tmp_path / "h200.json", platform=card)
    assert on_h100.resolve(op="matmul", m=4, k=64, n=64, dtype=torch.bfloat16) is None


def test_tune_matmul_on_the_cpu_stores_a_gated_policy():
    db = ttune.TuningDB(platform="cpu")
    trials = []
    pol = tsearch.tune_matmul(db, 32, 64, 48, density=0.5, backend="reference", device="cpu",
                              reps=2, keep=4, trials=trials)
    key = db.key(op="matmul", m=32, k=64, n=48, dtype=torch.float32, density=0.5)
    assert db.lookup(key) == pol and pol.source == "measured" and pol.backend == "reference"
    assert pol.speedup >= 1.0
    assert all("us" in t for t in trials) and {t["compact_grid"] for t in trials} >= {"ragged"}
    a = tsearch.make_operand(32, 64, 0.5, device="cpu")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 48)).astype(np.float32))
    assert tsearch.measure_candidate(a, b, bm=pol.bm, bk=pol.bk, bn=pol.bn,
                                     compact_grid=pol.compact_grid, backend="reference",
                                     reps=1) > 0.0
    with pytest.raises(ValueError, match="measuring on"):
        tsearch.tune_matmul(ttune.TuningDB(platform="cuda:X"), 8, 16, 16, backend="reference",
                            device="cpu")


def test_seed_from_history_equals_jax():
    tdb, jdb = ttune.TuningDB(platform="cpu"), jtune.TuningDB(platform="cpu")
    path = str(ROOT / "BENCH_history.jsonl")
    assert tsearch.seed_from_history(tdb, path) == jsearch.seed_from_history(jdb, path)
    assert ({k.encode(): dataclasses.astuple(v) for k, v in tdb.entries().items()}
            == {k.encode(): dataclasses.astuple(v) for k, v in jdb.entries().items()})


def test_cli_writes_the_ports_db(tmp_path):
    out = tmp_path / "TUNING_db_torch.json"
    assert tune_main(["--configs", "deepseek_7b", "--backend", "reference", "--device", "cpu",
                      "--densities", "0.5", "--keep", "2", "--reps", "1", "--db", str(out),
                      "--quiet"]) == 0
    raw = json.loads(out.read_text())
    assert raw["platform"] == "cpu" and raw["version"] == ttune.DB_VERSION
    # reduced deepseek-7b FFN: (64, 64, 128) and (64, 128, 64), density cell + "any" alias each
    assert sorted(raw["entries"]) == sorted(
        f"matmul|{s}|float32|{d}|cpu" for s in ("64x64x128", "64x128x64") for d in ("le0.5", "any"))
    # a runtime built on the file resolves those cells; geometry is checked
    rt = trt.Runtime.tuned(path=out, backend="reference", device="cpu")
    assert rt.geometry == "auto" and len(rt.tuning_db) == 4
    want = ttune.TunedPolicy(**raw["entries"]["matmul|64x64x128|float32|any|cpu"])
    got = rt._resolved("matmul", (64, 64), (64, 128), torch.float32)
    assert (got.bm, got.bk, got.bn, got.compact_grid) == (want.bm, want.bk, want.bn, want.compact_grid)
    assert trt.Runtime(backend="reference", device="cpu")._db is None
    with pytest.raises(ValueError, match="geometry"):
        trt.Runtime(backend="reference", device="cpu", geometry="tuned")


# ---------------------------------------------------------------------------
# the cuda form of the numerics gate, on fake backends
# ---------------------------------------------------------------------------


class _Fake(ReferenceBackend):
    """Plain executors that answer like a kernel backend without the
    ``bitwise_dense`` property, with ``perturb(out, req)`` applied."""

    bitwise_dense = False

    def __init__(self, name, perturb):
        self.name, self.perturb = name, perturb

    def execute_planned(self, req):
        return self.perturb(super().execute_planned(req), req)


def _ulp_up(out):
    return torch.nextafter(out, torch.full_like(out, float("inf")))


@pytest.fixture
def fake_backends():
    fakes = {
        "fake-v2-off": lambda out, req: _ulp_up(out) if req.compact_grid == "v2" else out,
        "fake-all-off-ulp": lambda out, req: _ulp_up(out),
        "fake-all-off-far": lambda out, req: out + 1.0,
    }
    for name, fn in fakes.items():
        register_backend(_Fake(name, fn))
    yield
    for name in fakes:
        _REGISTRY.pop(name)


@pytest.mark.usefixtures("fake_backends")
def test_cuda_gate_rejects_a_candidate_not_bit_equal_to_its_ragged_family():
    a = tsearch.make_operand(32, 64, 0.5, device="cpu")
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 48)).astype(np.float32))
    geom = dict(bm=8, bk=16, bn=16)
    with pytest.raises(tsearch.CandidateRejected, match="ragged family"):
        tsearch.measure_candidate(a, b, compact_grid="v2", backend="fake-v2-off", reps=1, **geom)
    for grid in ("ragged", "v1"):
        tsearch.measure_candidate(a, b, compact_grid=grid, backend="fake-v2-off", reps=1, **geom)
    # last-bit differences from the plain executor are within the kernel
    # tolerance on this backend (the JAX rule on a bitwise backend would not
    # take them); a real difference is not
    for grid in ("ragged", "v2", "v1"):
        tsearch.measure_candidate(a, b, compact_grid=grid, backend="fake-all-off-ulp", reps=1, **geom)
        with pytest.raises(tsearch.CandidateRejected, match="tolerance"):
            tsearch.measure_candidate(a, b, compact_grid=grid, backend="fake-all-off-far",
                                      reps=1, **geom)
    # the tuner never stores the rejected family
    db, trials = ttune.TuningDB(platform="cpu"), []
    pol = tsearch.tune_matmul(db, 32, 64, 48, density=0.5, backend="fake-v2-off", device="cpu",
                              reps=1, keep=12, trials=trials)
    rejected = [t for t in trials if "rejected" in t]
    assert rejected and all(t["compact_grid"] == "v2" for t in rejected)
    assert pol.compact_grid != "v2"
