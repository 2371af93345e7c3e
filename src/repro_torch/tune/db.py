"""The persistent tuned-policy store behind ``Runtime(geometry="auto")``
(port of ``repro/tune/db.py``).

A :class:`TuningDB` maps a :class:`PolicyKey` — ``(op, M/K/N shape-bucket,
dtype, density-bucket, platform)`` — to the measured-best
:class:`TunedPolicy` (tile geometry ``bm/bk/bn``, grid family
``compact_grid``, fuse-or-not, backend).  It is keyed and validated like
``repro_torch.runtime.plan.PlanCache``: lookups only resolve entries whose key
matches the *current* platform exactly (an entry measured on another
platform is ignored with a warning — tile geometry does not transfer
between card models, nor between a card and a host CPU), and a corrupted or
stale on-disk file degrades to an empty DB with a warning instead of
poisoning execution policy.  The platform is the torch device's: ``"cpu"``
on the CPU and ``"cuda:<card name>"`` (``torch.cuda.get_device_name``) on a
card, so a policy tuned on one card model never resolves on another and the
JAX package's ``cpu`` cells never resolve on a card.  Resolution never
changes numerics beyond what a geometry implies — the search harness
(``repro_torch.tune.search``) gates every stored candidate.

Shape bucketing rounds each of M/K/N up to the next power of two, so a
65..128-token microbatch resolves the same policy as the 128-token one it
was tuned at (the geometry is re-clamped to exact divisors at the call
site, see ``Runtime._resolved``).  Density buckets are half-open intervals
``(prev_edge, edge]`` over :data:`DENSITY_EDGES`; ``None`` (caller has no
density estimate) is its own ``"any"`` bucket, so an unhinted lookup never
aliases a hinted one.

The on-disk format is the JAX package's versioned JSON, so either package
reads the other's file.  The port's default file is its own,
``TUNING_db_torch.json``: ``default_db()`` discovers it via
``$REPRO_TORCH_TUNING_DB``, the working directory, or the repo root, and
memoizes the loaded handle per ``(path, mtime, platform)``.  It never looks
for, and nothing in the port writes, the JAX package's ``TUNING_db.json``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.tensordash_spmm import _check_compact_grid

__all__ = [
    "DB_VERSION",
    "DENSITY_EDGES",
    "PolicyKey",
    "TunedPolicy",
    "TuningDB",
    "density_bucket",
    "shape_bucket",
    "default_db",
    "default_db_path",
    "platform_of",
]

DB_VERSION = 1

#: density-bucket upper edges: a density d lands in the first bucket with
#: d <= edge, so boundary values (exactly 0.25) belong to the bucket they
#: close — deterministic, no float-epsilon ambiguity at the edges
DENSITY_EDGES = (0.05, 0.25, 0.5, 0.75, 1.0)

#: ops the runtime resolves: the forward planned matmul, the two backward
#: products (the transposed plan generally wants a different geometry), the
#: fused-epilogue matmul and the FFN fuse-or-not decision
OPS = ("matmul", "matmul_fused", "matmul_da", "matmul_db", "ffn", "moe_expert")


def density_bucket(density: float | None) -> str:
    """Bucket label for a density in [0, 1]; ``None`` -> ``"any"``."""
    if density is None:
        return "any"
    d = float(density)
    if not 0.0 <= d <= 1.0:
        raise ValueError(f"density {d!r} outside [0, 1]")
    for edge in DENSITY_EDGES:
        if d <= edge:
            return f"le{edge:g}"
    raise AssertionError("unreachable: DENSITY_EDGES ends at 1.0")


def shape_bucket(dim: int) -> int:
    """Next power of two >= ``dim`` (>= 1)."""
    d = int(dim)
    if d < 1:
        raise ValueError(f"dim {dim!r} < 1")
    return 1 << (d - 1).bit_length() if d > 1 else 1


@dataclasses.dataclass(frozen=True)
class PolicyKey:
    """One tuning cell.  ``m/k/n`` are already shape-bucketed; ``dtype`` is
    the canonical name (``"float32"``/``"bfloat16"`` — never aliased:
    distinct dtypes are distinct strings); ``density`` is a bucket label;
    ``platform`` is :func:`platform_of` the measuring device."""

    op: str
    m: int
    k: int
    n: int
    dtype: str
    density: str
    platform: str

    def encode(self) -> str:
        return "|".join((self.op, f"{self.m}x{self.k}x{self.n}",
                         self.dtype, self.density, self.platform))

    @classmethod
    def decode(cls, s: str) -> "PolicyKey":
        op, mkn, dtype, density, platform = s.split("|")
        m, k, n = (int(x) for x in mkn.split("x"))
        return cls(op=op, m=m, k=k, n=n, dtype=dtype, density=density,
                   platform=platform)


@dataclasses.dataclass(frozen=True)
class TunedPolicy:
    """The measured-best policy vector for one :class:`PolicyKey` cell.

    ``measured_us``/``default_us`` record the best-of-N wall times of this
    policy and of the hand-tuned default it beat (same harness, same
    operands), so a DB entry carries its own evidence; ``source`` is
    ``"measured"`` for harness results or ``"history"`` for entries seeded
    from ``BENCH_history.jsonl`` trends (mode preference only — geometry is
    the fitted default until measured)."""

    bm: int
    bk: int
    bn: int
    compact_grid: str = "ragged"
    fuse: bool = True
    backend: str = ""
    measured_us: float = 0.0
    default_us: float = 0.0
    source: str = "measured"

    def __post_init__(self):
        object.__setattr__(self, "compact_grid",
                           _check_compact_grid(self.compact_grid))
        for f in ("bm", "bk", "bn"):
            v = getattr(self, f)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"TunedPolicy.{f}={v!r}: need an int >= 1")

    @property
    def speedup(self) -> float:
        """Measured speedup over the hand-tuned default (>= 1 by
        construction: the default is always in the measured candidate set)."""
        return self.default_us / max(self.measured_us, 1e-9)


def _canon_dtype(dtype) -> str:
    """The dtype's canonical name, the JAX package's spelling: a torch dtype
    without its ``torch.`` prefix, a numpy dtype's name, or a name as is."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    return np.dtype(dtype).name


def platform_of(device=None) -> str:
    """The platform key of a torch device: ``"cpu"``, or ``"cuda:<card
    name>"`` for a card (``None`` means the current card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"no tuning platform for device {dev}")
    return f"cuda:{torch.cuda.get_device_name(dev)}"


class TuningDB:
    """Persistent, platform-validated tuned-policy store.

    Mirrors ``PlanCache``'s discipline: exact keys, validated hits
    (platform match enforced at lookup — a mismatching entry is ignored
    with a one-time warning), hit/miss counters, and graceful degradation —
    a corrupted/stale file or a malformed entry falls back to defaults
    instead of raising mid-model.  ``resolve()`` memoizes per
    ``(op, shapes, dtype, density-bucket)``, so a warm lookup on the eager
    serving path is one dict probe.
    """

    def __init__(self, path: str | os.PathLike | None = None, *,
                 platform: str | None = None):
        self.path = os.fspath(path) if path is not None else None
        self.platform = platform or platform_of()
        self._entries: dict[PolicyKey, TunedPolicy] = {}
        self._memo: dict[tuple, TunedPolicy | None] = {}
        self.hits = 0
        self.misses = 0
        self._warned: set[str] = set()

    def __len__(self) -> int:
        return len(self._entries)

    def _warn_once(self, tag: str, message: str) -> None:
        if tag not in self._warned:
            self._warned.add(tag)
            warnings.warn(message, stacklevel=3)

    # -- persistence -------------------------------------------------------
    @classmethod
    def load(cls, path: str | os.PathLike, *,
             platform: str | None = None) -> "TuningDB":
        """Load a DB file; any corruption/staleness degrades to empty."""
        db = cls(path, platform=platform)
        try:
            with open(db.path, encoding="utf-8") as f:
                raw = json.load(f)
        except FileNotFoundError:
            return db
        except (json.JSONDecodeError, OSError, UnicodeDecodeError, ValueError) as e:
            db._warn_once("corrupt", (
                f"TuningDB {db.path}: unreadable ({e!r}); tuned policies "
                "unavailable, falling back to hand-tuned defaults"
            ))
            return db
        if not isinstance(raw, dict) or raw.get("version") != DB_VERSION:
            db._warn_once("stale", (
                f"TuningDB {db.path}: version "
                f"{raw.get('version') if isinstance(raw, dict) else '?'} != "
                f"{DB_VERSION} (stale or foreign file); falling back to "
                "hand-tuned defaults — re-run `python -m repro_torch.tune`"
            ))
            return db
        file_platform = raw.get("platform")
        if file_platform and file_platform != db.platform:
            db._warn_once("platform", (
                f"TuningDB {db.path}: tuned on {file_platform!r} but running "
                f"on {db.platform!r}; its entries are ignored (tile geometry "
                "does not transfer across platforms) — re-run "
                "`python -m repro_torch.tune` here"
            ))
        for ks, ev in (raw.get("entries") or {}).items():
            try:
                key = PolicyKey.decode(ks)
                pol = TunedPolicy(**ev)
            except Exception as e:  # malformed entry: skip, keep the rest
                db._warn_once(f"entry:{ks}", (
                    f"TuningDB {db.path}: dropping malformed entry {ks!r} "
                    f"({e!r})"
                ))
                continue
            db._entries[key] = pol
        return db

    def save(self, path: str | os.PathLike | None = None) -> str:
        p = os.fspath(path) if path is not None else self.path
        if p is None:
            raise ValueError("TuningDB.save: no path bound or given")
        if os.path.basename(p) == JAX_DB_FILENAME:
            raise ValueError(f"TuningDB.save: {p} is the JAX package's DB, which the port only reads")
        payload = {
            "version": DB_VERSION,
            "platform": self.platform,
            "entries": {k.encode(): dataclasses.asdict(v)
                        for k, v in sorted(self._entries.items(),
                                           key=lambda kv: kv[0].encode())},
        }
        tmp = p + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, p)
        return p

    # -- keying ------------------------------------------------------------
    def key(self, *, op: str, m: int, k: int, n: int, dtype,
            density: float | None = None,
            platform: str | None = None) -> PolicyKey:
        return PolicyKey(
            op=op, m=shape_bucket(m), k=shape_bucket(k), n=shape_bucket(n),
            dtype=_canon_dtype(dtype), density=density_bucket(density),
            platform=platform or self.platform,
        )

    # -- access ------------------------------------------------------------
    def lookup(self, key: PolicyKey) -> TunedPolicy | None:
        """Exact-key fetch; entries measured on another platform never
        resolve (warned once per foreign platform)."""
        if key.platform != self.platform:
            self._warn_once(f"lookup-platform:{key.platform}", (
                f"TuningDB: ignoring lookup for platform {key.platform!r} "
                f"(running on {self.platform!r})"
            ))
            return None
        pol = self._entries.get(key)
        if pol is None:
            self.misses += 1
        else:
            self.hits += 1
        return pol

    def resolve(self, *, op: str, m: int, k: int, n: int, dtype,
                density: float | None = None) -> TunedPolicy | None:
        """The runtime's hot-path lookup: bucket the call-site shapes, probe
        the memo, fall through to :meth:`lookup`.  A warm resolve is a dict
        probe — no I/O, no planning, no device work."""
        # memo on the RAW call-site inputs (no canonicalization, no
        # bucketing): the warm probe must stay one tuple hash + dict get
        mk = (op, m, k, n, dtype, density)
        try:
            pol = self._memo[mk]
        except KeyError:
            pol = self.lookup(self.key(op=op, m=int(m), k=int(k), n=int(n),
                                       dtype=dtype, density=density))
            self._memo[mk] = pol
        else:
            self.hits += 1
        return pol

    def store(self, key: PolicyKey, policy: TunedPolicy) -> TunedPolicy:
        if not isinstance(key, PolicyKey) or not isinstance(policy, TunedPolicy):
            raise TypeError(f"store({type(key).__name__}, {type(policy).__name__})")
        self._entries[key] = policy
        self._memo.clear()  # resolution must see the new entry
        return policy

    def entries(self) -> dict[PolicyKey, TunedPolicy]:
        return dict(self._entries)

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "platform": self.platform}


DEFAULT_DB_FILENAME = "TUNING_db_torch.json"
#: the JAX package's checked-in DB: readable, never written by the port
JAX_DB_FILENAME = "TUNING_db.json"


def default_db_path() -> str | None:
    """Discover the port's default DB file: ``$REPRO_TORCH_TUNING_DB`` > CWD
    > the repo root (three levels above this package — the src layout)."""
    env = os.environ.get("REPRO_TORCH_TUNING_DB")
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    for base in (os.getcwd(), repo_root):
        cand = os.path.join(base, DEFAULT_DB_FILENAME)
        if os.path.exists(cand):
            return cand
    return None


@functools.lru_cache(maxsize=8)
def _load_cached(path: str, mtime: float, platform: str) -> TuningDB:
    del mtime  # part of the cache key: a rewritten file reloads
    return TuningDB.load(path, platform=platform)


def default_db(platform: str | None = None) -> TuningDB:
    """The process-wide default DB handle for ``platform`` (default: the
    current card's), memoized per file mtime, or an empty unbound DB when
    no file is discoverable — ``geometry="auto"`` then behaves exactly like
    the fitted defaults."""
    platform = platform or platform_of()
    path = default_db_path()
    if path is None or not os.path.exists(path):
        return TuningDB(platform=platform)
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return TuningDB(platform=platform)
    return _load_cached(path, mtime, platform)
