"""The port stands alone: no module of ``repro_torch`` and no line of
``chip_smoke.py`` imports JAX (``jax``, ``jaxlib``), the JAX package
``repro`` (as distinct from ``repro_torch``) or ``ml_dtypes`` (JAX's dtype
package, which the card's installation lacks).  Checked on the source with
``ast``, so a lazy import inside a function counts too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def test_the_port_has_modules_and_chip_smoke():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()
    for module in ("mla.py", "ssm.py", "hybrid.py"):
        assert ROOT / "src" / "repro_torch" / "models" / module in FILES
    for module in ("parallel/sharding.py", "parallel/spmm.py", "parallel/rehearsal.py", "optim/compress.py"):
        assert ROOT / "src" / "repro_torch" / module in FILES
    for module in ("core/compress.py", "core/energy.py", "core/powergate.py", "checkpoint/codec.py",
                   "kernels/ops.py", "kernels/schedule.py", "analysis/lint.py", "analysis/__main__.py",
                   "launch/mesh.py"):
        assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_checker_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from repro.kernels import ref\n    import jax.numpy\n"
                     "    import ml_dtypes\n")
    assert set(_imported_roots(probe)) == {"repro", "jax", "ml_dtypes"} <= FORBIDDEN
