"""The port's linter, ``repro_torch.analysis.lint``: each of its seven rules
fires on the bug pattern it is named for, a waiver on the line or the line
above suppresses it, clean code stays clean, and the port's own tree lints
clean (``python -m repro_torch.analysis.lint src/repro_torch`` exits 0).
The rules keep the JAX linter's names (``repro.analysis.lint.RULES``)."""
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.analysis.lint import RULES as JAX_RULES
from repro_torch.analysis import lint

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"


def _codes(src: str, path: str = "src/repro_torch/models/x.py"):
    return [f.code for f in lint.lint_source(textwrap.dedent(src), path)]


def test_the_rules_are_jax_s():
    assert lint.RULES == JAX_RULES


#: (rule, module path, a snippet that must fire, its fix that must not)
CASES = {
    "host-sync-item": ("host-sync", "models/x.py", """
        def f(x):
            s = torch.sum(x)
            return s.item()
        """, """
        def f(x):
            return torch.sum(x)
        """),
    "host-sync-float": ("host-sync", "launch/x.py", """
        def f(x: torch.Tensor):
            return float(x.abs().max())
        """, """
        def f(x: torch.Tensor):
            return float(x.shape[0])
        """),
    "host-sync-cpu": ("host-sync", "launch/x.py", """
        def f(n):
            t = torch.arange(n, device="cuda")
            return t.cpu()
        """, """
        def f(n):
            return torch.arange(n, device="cuda")
        """),
    "host-sync-tolist": ("host-sync", "launch/x.py", """
        def f(x: torch.Tensor):
            return x.sum(0).tolist()
        """, """
        def f(x: torch.Tensor):
            return x.sum(0)
        """),
    "np-on-device": ("np-on-device", "launch/x.py", """
        def f(x: torch.Tensor):
            return np.mean(x)
        """, """
        def f(x: torch.Tensor):
            return np.mean(x.shape)
        """),
    "loop-fetch": ("loop-fetch", "sparse_train/x.py", """
        def f(scores, paths):
            out = {}
            for p in paths:
                out[p] = np.asarray(scores[p])
            return out
        """, """
        def f(scores, paths):
            host = {p: scores[p] for p in paths}
            return host
        """),
    "loop-fetch-method": ("loop-fetch", "sparse_train/x.py", """
        def f(scores, paths):
            return [scores[p].cpu() for p in paths]
        """, """
        def f(scores: dict, paths):
            return [scores[p] for p in paths]
        """),
    "traced-stats": ("traced-stats", "serve/engine.py", """
        def _chunk(self):
            row = self.logits.float()
            if bool(torch.isfinite(row).all()):
                return row
            return row * 0
        """, """
        def _chunk(self):
            row = self.logits.float()
            return torch.where(torch.isfinite(row), row, 0.0)
        """),
    "traced-stats-item": ("traced-stats", "models/ssm.py", """
        def ssm_decode(params, cfg, x, cache):
            n = x.sum().item()
            return n
        """, """
        def ssm_decode(params, cfg, x, cache):
            return x.sum()
        """),
    "traced-stats-branch": ("traced-stats", "models/hybrid.py", """
        def hybrid_decode(params, cfg, x, caches):
            h = torch.relu(x)
            if h.any():
                h = h + 1
            return h
        """, """
        def hybrid_decode(params, cfg, x, caches):
            return torch.relu(x) + 1
        """),
    "workqueue-dropped": ("workqueue-dropped", "models/x.py", """
        def f(plan, a, b):
            return tensordash_matmul_planned(plan.nnz, plan.idx, a, b, bm=plan.bm)
        """, """
        def f(plan, a, b):
            return tensordash_matmul_planned(plan.nnz, plan.idx, a, b, bm=plan.bm,
                                             workqueue=plan.workqueue())
        """),
    "shard-map-axes": ("shard-map-axes", "parallel/x.py", """
        def f(x):
            dist.all_reduce(x)
            return x
        """, """
        def f(x, policy):
            _, _, group = policy.spmm_axes("K")
            dist.all_reduce(x, group=group)
            return x
        """),
    "shard-map-axes-new-group": ("shard-map-axes", "models/x.py", """
        def f(x):
            g = torch.distributed.new_group([0, 1])
            dist.all_reduce(x, group=g)
            return x
        """, """
        def f(x, group):
            dist.all_reduce(x, group=group)
            return x
        """),
    "hand-geometry": ("hand-geometry", "models/x.py", """
        def f(rt, a, b):
            return rt.replace(bm=64).matmul(a, b)
        """, """
        def f(rt, a, b):
            return rt.matmul(a, b)
        """),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_rule_fires_on_its_bug_and_not_on_the_fix(case):
    rule, module, bug, fix = CASES[case]
    path = f"src/repro_torch/{module}"
    assert rule in _codes(bug, path)
    assert _codes(fix, path) == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_waiver_suppresses(case):
    rule, module, bug, _ = CASES[case]
    path = f"src/repro_torch/{module}"
    lines = textwrap.dedent(bug).splitlines()
    flagged = {f.line for f in lint.lint_source("\n".join(lines), path) if f.code == rule}
    for line in sorted(flagged, reverse=True):  # on the line above
        lines.insert(line - 1, " " * 4 + f"# lint: allow-{rule}: a test's reason")
    assert rule not in [f.code for f in lint.lint_source("\n".join(lines), path)]
    other = next(r for r in lint.RULES if r != rule)
    lines = textwrap.dedent(bug).splitlines()
    for line in flagged:  # a waiver of another rule does not
        lines[line - 1] += f"  # lint: allow-{other}"
    assert rule in [f.code for f in lint.lint_source("\n".join(lines), path)]


def test_geometry_is_free_in_the_policy_modules():
    bug = CASES["hand-geometry"][2]
    assert _codes(bug, "src/repro_torch/runtime/x.py") == []
    assert _codes(bug, "src/repro_torch/tune/x.py") == []


def test_captured_rules_apply_only_to_captured_functions():
    src = """
        def step(self):
            return self.tok.tolist()
        """
    assert _codes(src, "src/repro_torch/serve/engine.py") == []


def test_the_ports_tree_lints_clean():
    findings = lint.lint_paths([SRC])
    assert findings == [], "\n".join(map(str, findings))


def test_the_command_lines():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", str(SRC)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert run.returncode == 0 and "0 finding(s)" in run.stdout
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert run.returncode == 0 and "clean=True" in run.stdout


def test_a_finding_fails_the_command(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f(x):\n    s = torch.sum(x)\n    return s.item()\n")
    assert lint.main([str(bad)]) == 1
