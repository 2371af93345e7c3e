"""Repo-specific AST linter for the port: ``python -m repro_torch.analysis.lint
src/repro_torch`` (port of ``repro/analysis/lint.py``).

The JAX package's seven rules are JAX pitfalls; each has a PyTorch
counterpart here under the same name:

``host-sync``
    ``.item()``, ``.tolist()``, ``.cpu()`` or ``float()``/``int()``/
    ``bool()`` of a tensor-rooted value (a ``torch.*`` call's result, a
    local assigned from one, a parameter annotated ``Tensor``) blocks the
    host until the device has caught up.  In a launch or report path it
    serialises the stream; read once, in bulk.
``np-on-device``
    ``np.*`` applied to a tensor-rooted value: numpy needs the data on the
    host, so it either copies (a hidden sync) or, for a card tensor, fails.
    Keep device math in torch; cross the boundary explicitly.
``loop-fetch``
    ``np.asarray``/``np.array`` of, or ``.cpu()``/``.tolist()``/``.item()``
    on, a value rooted at a maybe-device parameter inside a loop: one device
    round trip per iteration.  Fetch once above the loop.
``traced-stats``
    JAX's rule catches host reads of traced values under ``jit``; the
    port's counterpart is code a CUDA graph captures (``ServeEngine._chunk``,
    ``ssm_decode``, ``hybrid_decode``): any ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``, ``float()``/
    ``int()``/``bool()`` of a tensor or maybe-device value, or a Python
    ``if``/``while`` on a tensor there breaks the capture (it raises; the
    decode graph has no fallback).
``workqueue-dropped``
    A direct call of ``tensordash_matmul_planned``/``_fused`` without a
    ``workqueue=`` passthrough in a function that did not plan inline: the
    wrapper re-derives the plan's CSR queue on every call.
``shard-map-axes``
    JAX's rule catches ``shard_map`` pspecs not derived from
    ``ShardingPolicy.spmm_axes()``; the port's counterpart is a collective on
    a hand-built group: a ``torch.distributed`` collective with no
    ``group=`` (the world group) or a ``new_group`` outside
    ``parallel/sharding.py``.  Groups come from ``spmm_axes()`` /
    ``axis_group()``, so they follow the policy's axis roles.
``hand-geometry``
    A literal ``bm=``/``bk=``/``bn=``/``compact_grid=`` keyword outside
    ``repro_torch/tune/`` and ``repro_torch/runtime/``: hand-pinned kernel
    policy at a call site, which overrides the ``Runtime`` and the
    ``TuningDB``.

Waivers: put ``# lint: allow-<rule>`` (e.g. ``# lint: allow-host-sync``;
several rules: ``# lint: allow-host-sync allow-np-on-device``) on the
flagged line or the line above, with the reason beside it.  The linter
is heuristic by design: it tracks taint per function and prefers false
negatives over noise.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import pathlib
import re
import sys

__all__ = ["LintFinding", "RULES", "lint_source", "lint_file", "lint_paths", "main"]

RULES = (
    "host-sync",
    "np-on-device",
    "loop-fetch",
    "traced-stats",
    "workqueue-dropped",
    "shard-map-axes",
    "hand-geometry",
)

#: functions a CUDA graph captures, by module path suffix
CAPTURED = {
    "serve/engine.py": ("_chunk",),
    "models/ssm.py": ("ssm_decode",),
    "models/hybrid.py": ("hybrid_decode",),
}

#: kernel-policy keywords owned by Runtime/TuningDB resolution
_GEOMETRY_KWARGS = ("bm", "bk", "bn", "compact_grid")
#: methods that read a tensor back to the host
_FETCH_METHODS = ("item", "tolist", "cpu")
#: torch.distributed collectives
_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all", "all_to_all_single",
    "reduce_scatter", "reduce_scatter_tensor", "broadcast", "reduce", "gather", "scatter",
)
#: torch calls whose result is a host value, not a tensor that may live on a card
_HOST_CALLS = re.compile(
    r"torch\.(device|Size|finfo|iinfo|dtype|Generator|from_numpy|is_\w+|get_\w+|set_\w+"
    r"|manual_seed|no_grad|enable_grad|inference_mode|promote_types|result_type)$"
    r"|torch\.(cuda|distributed|backends|utils|profiler|testing|library|jit)\."
)
#: annotations that mark a parameter as host-side data
_HOST_ANNOTATIONS = re.compile(
    r"ndarray|PlanShards|PlanDelta|SparsityPlan|PlanCache|Runtime\b|ModelConfig"
    r"|\bint\b|\bfloat\b|\bstr\b|\bbool\b|\bbytes\b|Path\b|\bdict\b|\blist\b|\btuple\b"
)
_TENSOR_ANNOTATION = re.compile(r"\bTensor\b")
#: tensor attributes and methods whose value lives on the host
_HOST_ATTRS = frozenset((
    "shape", "ndim", "dtype", "device", "numel", "dim", "size", "stride", "element_size",
    "data_ptr", "is_contiguous", "requires_grad", "is_cuda", "nbytes", "itemsize",
))
_WAIVER = re.compile(r"#\s*lint:(.*)")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.code}] {self.message}"


def _dotted(node) -> str:
    """``torch.cuda.synchronize`` -> ``"torch.cuda.synchronize"``; non-name
    roots -> ``""``."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _root_name(node) -> str | None:
    """The base ``Name`` a value expression is rooted at, through attribute,
    subscript and call chains (``h[:, 0].sum()`` -> ``h``)."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return None


def _is_device_call(node) -> bool:
    """A ``torch.*`` call whose result is a tensor (not a host value)."""
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func)
    return name.startswith("torch.") and not _HOST_CALLS.search(name)


class _FunctionLint:
    """Per-function taint walk.  ``maybe_device``: parameters with no
    host-typed annotation; ``tainted``: parameters annotated ``Tensor`` and
    locals assigned from ``torch.*`` calls or tainted values."""

    def __init__(self, fn, *, path: str, findings: list, waived, captured: bool,
                 distributed_owner: bool):
        self.fn = fn
        self.path = path
        self.findings = findings
        self.waived = waived
        self.captured = captured
        self.distributed_owner = distributed_owner
        self.maybe_device: set[str] = set()
        self.tainted: set[str] = set()
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            if a.arg in ("self", "cls"):
                continue
            ann = ast.unparse(a.annotation) if a.annotation is not None else ""
            if _TENSOR_ANNOTATION.search(ann):
                self.tainted.add(a.arg)
            elif not ann or not _HOST_ANNOTATIONS.search(ann):
                self.maybe_device.add(a.arg)
        self.plans_inline = bool(re.search(
            r"\bplan_blocks\w*\(|\bplan_operand\(|\bplan_workqueue\(", ast.unparse(fn)))

    def report(self, node, code: str, message: str) -> None:
        line = node.lineno
        if code in self.waived.get(line, ()) or code in self.waived.get(line - 1, ()):
            return
        self.findings.append(LintFinding(self.path, line, code, message))

    # -- taint --------------------------------------------------------------
    def _is_device_value(self, node) -> bool:
        probe = node
        while isinstance(probe, (ast.Attribute, ast.Subscript, ast.Call)):
            if isinstance(probe, ast.Attribute) and probe.attr in _HOST_ATTRS:
                return False  # x.shape[0], x.numel(), ...: host values
            if _is_device_call(probe):
                return True
            probe = probe.func if isinstance(probe, ast.Call) else probe.value
        return _root_name(node) in self.tainted

    def _note_assign(self, targets, value) -> None:
        names = []
        for t in targets:
            names += [e.id for e in (t.elts if isinstance(t, ast.Tuple) else [t]) if isinstance(e, ast.Name)]
        device = self._is_device_value(value)
        for n in names:
            if device:
                self.tainted.add(n)
            else:
                self.tainted.discard(n)  # any other rebind clears the taint

    # -- the walk -----------------------------------------------------------
    def run(self, *, in_policy_module: bool) -> None:
        loop_depth = 0

        def visit(node):
            nonlocal loop_depth
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) and node is not self.fn:
                return  # nested functions get their own pass
            if isinstance(node, ast.Assign):
                self._note_assign(node.targets, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._note_assign([node.target], node.value)
            if isinstance(node, ast.Call):
                self._call(node, loop_depth, in_policy_module)
            if self.captured and isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                    and self._is_device_value(node.test):
                self.report(node, "traced-stats",
                            "a Python branch on a tensor in captured code reads it on the host")
            if isinstance(node, (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
                                 ast.GeneratorExp)):
                loop_depth += 1
                for child in ast.iter_child_nodes(node):
                    visit(child)
                loop_depth -= 1
                return
            for child in ast.iter_child_nodes(node):
                visit(child)

        for child in ast.iter_child_nodes(self.fn):
            visit(child)

    def _call(self, node: ast.Call, loop_depth: int, in_policy_module: bool) -> None:
        callee = _dotted(node.func)
        method = node.func.attr if isinstance(node.func, ast.Attribute) and not node.args else None
        receiver = node.func.value if method else None
        arg0 = node.args[0] if len(node.args) == 1 else None

        what = f".{method}()" if method else f"{callee}()"

        # traced-stats: host reads in code a CUDA graph captures
        if self.captured:
            if method in (*_FETCH_METHODS, "numpy") or callee == "torch.cuda.synchronize":
                self.report(node, "traced-stats",
                            f"{what} in code a CUDA graph captures: a host read breaks the capture")
                return
            if callee in ("float", "int", "bool") and arg0 is not None and (
                    self._is_device_value(arg0) or _root_name(arg0) in self.maybe_device):
                self.report(node, "traced-stats",
                            f"{callee}() of a tensor in code a CUDA graph captures breaks the capture")
                return

        # host-sync: .item()/.tolist()/.cpu(), float()/int()/bool() of a tensor
        if method in _FETCH_METHODS and self._is_device_value(receiver):
            self.report(node, "host-sync", f".{method}() on a tensor blocks the host on the device")
        elif callee in ("float", "int", "bool") and arg0 is not None and self._is_device_value(arg0):
            self.report(node, "host-sync", f"{callee}() of a tensor blocks the host on the device")

        # loop-fetch: a device round trip per iteration
        fetched = (receiver if method in _FETCH_METHODS
                   else node.args[0] if callee in ("np.asarray", "np.array") and node.args else None)
        if loop_depth and fetched is not None and not self._is_device_value(fetched) \
                and _root_name(fetched) in self.maybe_device:
            self.report(node, "loop-fetch",
                        f"{what} of {_root_name(fetched)}... inside a loop: one device round trip "
                        f"per iteration — fetch once above the loop")

        # np-on-device: numpy on a tensor
        if callee.startswith("np.") and node.args and self._is_device_value(node.args[0]):
            self.report(node, "np-on-device",
                        f"{callee}() of a tensor copies it to the host (or fails on a card) — keep "
                        f"device math in torch")

        # workqueue-dropped: planned-kernel call discarding the carried queue
        if callee.split(".")[-1] in ("tensordash_matmul_planned", "tensordash_matmul_fused"):
            if "workqueue" not in {k.arg for k in node.keywords} and not self.plans_inline:
                self.report(node, "workqueue-dropped",
                            f"{callee}() without workqueue=: the plan's carried CSR queue is "
                            f"re-derived per call")

        # hand-geometry: literal kernel-policy kwargs outside the policy modules
        if not in_policy_module:
            for kw in node.keywords:
                if (kw.arg in _GEOMETRY_KWARGS and isinstance(kw.value, ast.Constant)
                        and kw.value.value is not None):
                    self.report(kw.value, "hand-geometry",
                                f"literal {kw.arg}={kw.value.value!r} hand-pins kernel policy at the "
                                f"call site — let the Runtime (or the TuningDB under "
                                f"geometry='auto') resolve it")

        # shard-map-axes: collectives over the world group or a hand-built group
        name = callee.split(".")[-1]
        if callee.startswith(("dist.", "torch.distributed.")):
            if name in _COLLECTIVES and "group" not in {k.arg for k in node.keywords}:
                self.report(node, "shard-map-axes",
                            f"{callee}() without group= runs over the world group, not the "
                            f"policy's axis group (spmm_axes() / axis_group())")
            elif name == "new_group" and not self.distributed_owner:
                self.report(node, "shard-map-axes",
                            f"{callee}() outside parallel/sharding.py: a hand-built group drifts "
                            f"from the policy's axis roles")


def lint_source(src: str, path: str = "<string>") -> list[LintFinding]:
    """Lint one module's source text."""
    tree = ast.parse(src, filename=path)
    waived: dict[int, set] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _WAIVER.search(line)
        if m:
            waived.setdefault(i, set()).update(re.findall(r"allow-([a-z-]+)", m.group(1)))
    in_policy_module = "/tune/" in path or "/runtime/" in path
    captured = next((names for suffix, names in CAPTURED.items() if path.endswith(suffix)), ())
    findings: list[LintFinding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _FunctionLint(node, path=path, findings=findings, waived=waived,
                          captured=node.name in captured,
                          distributed_owner=path.endswith("parallel/sharding.py"),
                          ).run(in_policy_module=in_policy_module)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def lint_file(path) -> list[LintFinding]:
    p = pathlib.Path(path)
    return lint_source(p.read_text(), str(p).replace("\\", "/"))


def lint_paths(paths) -> list[LintFinding]:
    findings: list[LintFinding] = []
    for path in paths:
        p = pathlib.Path(path)
        for fp in (sorted(p.rglob("*.py")) if p.is_dir() else [p]):
            findings.extend(lint_file(fp))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific PyTorch-pitfall linter (see module docstring)",
    )
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    args = ap.parse_args(argv)
    findings = lint_paths(args.paths)
    for f in findings:
        print(f)
    print(f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
