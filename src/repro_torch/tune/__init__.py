"""HASS-style geometry & mode autotuner (port of ``repro.tune``).

The policy vector the runtime used to hand-pick per call site — ``(bm, bk,
bn)`` tile geometry, grid family (``ragged``/``v2``/``v1``), fuse-or-not,
backend — is searched by **measurement** per key ``(op, M/K/N shape-bucket,
dtype, density-bucket, platform)`` and persisted in a :class:`TuningDB`
(JSON on disk, keyed and validated like the ``PlanCache``).  A
``Runtime(geometry="auto")`` — or ``Runtime.tuned()`` — consults it at
every execution method; unmeasured cells fall back to the hand-tuned
defaults, and the search harness only stores candidates that pass its
numerics gate (``search._verify``), so tuning changes nothing beyond what
a geometry implies.

Offline pre-population, on the card::

    python -m repro_torch.tune --configs smoke,deepseek_7b

and in code::

    rt = Runtime.tuned()                              # discovered default DB
    rt = Runtime.tuned(path="TUNING_db_torch.json")   # explicit file
"""
from repro_torch.tune.db import (
    DB_VERSION,
    DENSITY_EDGES,
    PolicyKey,
    TunedPolicy,
    TuningDB,
    default_db,
    default_db_path,
    density_bucket,
    platform_of,
    shape_bucket,
)
from repro_torch.tune.search import (
    STANDARD_DENSITIES,
    STANDARD_MICRO_SHAPES,
    candidate_policies,
    measure_candidate,
    prior_score,
    seed_from_history,
    tune_cells,
    tune_matmul,
)

__all__ = [
    "DB_VERSION",
    "DENSITY_EDGES",
    "PolicyKey",
    "TunedPolicy",
    "TuningDB",
    "default_db",
    "default_db_path",
    "density_bucket",
    "platform_of",
    "shape_bucket",
    "STANDARD_DENSITIES",
    "STANDARD_MICRO_SHAPES",
    "candidate_policies",
    "measure_candidate",
    "prior_score",
    "seed_from_history",
    "tune_cells",
    "tune_matmul",
]
