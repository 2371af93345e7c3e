"""The port's training examples (``repro_torch.examples.train_lm`` and
``train_pruned``) against the JAX package's (``examples/train_lm.py``,
``examples/train_pruned.py``) on the CPU, run as
``tests/test_torch_examples.py`` runs the others: the JAX example's
``main`` under a patched ``sys.argv``, the port's with ``--device cpu`` on
the JAX example's initial parameters carried across.

Both packages train fp32 parameters here (the JAX examples' initialiser
patched to fp32, the port's handed the same tree): in bf16 one projection's
rounding flipped early moves every later step (``test_torch_train.py``
holds a bf16 step only within 1e-2).  JAX's step metrics are read where
its example calls them (its jitted step and its ``measure``,
``simulate_conv``, ``encode`` and ``compressed_bytes`` wrapped), the port's
from what its ``main`` returns.

Tolerances, and why:

* losses and gradient norms within 1e-4 relative: ``make_train_step`` on the
  port's ``reference`` backend against JAX's ``dense`` in fp32, whose
  products sum in another order (``test_torch_train.py``'s fp32 step is
  held at 1e-4 too); the learning rates within 1e-6 relative (a float32
  schedule in both, rounded in another order: one float32 step apart).
* the resume line equal: both resume from their step-12 checkpoint.
* train_lm's FFN sparsity within 2 elements of its ``[256, 128]``
  activation (an fp32 rounding may put a value on the other side of 1e-8)
  and its projection equal where the fractions are equal (the cycle model
  is exact), otherwise within 2%; ``--relu-ffn`` so the fraction is
  measured on real zeros (a SiLU's is 0).
* train_pruned's weight sparsity within 1e-3 (a magnitude cut keeps an
  exact count in both, so the fraction agrees but for a tie at the cut)
  and the codec's compressed share within 1e-3 (its bytes follow the zero
  pattern, which a near-tie at the cut can move by a row).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import init_params as jinit_params
from repro_torch.convert import params_from_jax
from repro_torch.examples import train_lm as tlm
from repro_torch.examples import train_pruned as tpruned
from test_torch_examples import load_jax_example, run_jax_example, run_port_example

RTOL = 1e-4
fp32_init = functools.partial(jinit_params, dtype=jnp.float32)


class RecordingJax:
    """The ``jax`` module as an example sees it, with ``jax.jit`` wrapped so
    that every call's third output (the step's metrics) is recorded."""

    def __init__(self):
        self.metrics = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        step = jax.jit(fn)

        def run(*args):
            out = step(*args)
            self.metrics.append({k: float(v) for k, v in out[2].items() if np.ndim(v) == 0})
            return out
        return run


def recorder(fn, log: list, pick=lambda args, kw, out: out):
    """``fn`` that appends ``pick(args, kw, out)`` to ``log`` at every call."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        log.append(pick(args, kw, out))
        return out
    return wrapped


def carried(jax_tree: dict):
    """The port's initialiser handing in the JAX example's initial tree."""
    tree = jax.tree.map(np.asarray, jax_tree)
    return lambda cfg, device: params_from_jax(tree, cfg, device=device)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= RTOL * abs(want)


def test_train_lm_and_its_resume_match_jax(tmp_path, monkeypatch):
    jmod = load_jax_example("train_lm")
    rec, fracs, speedups = RecordingJax(), [], []
    monkeypatch.setattr(jmod, "jax", rec)
    monkeypatch.setattr(jmod, "init_params", fp32_init)
    monkeypatch.setattr(jmod, "measure", recorder(jmod.measure, fracs, lambda a, k, out: float(out.fraction)))
    monkeypatch.setattr(jmod, "simulate_conv", recorder(jmod.simulate_conv, speedups,
                                                        lambda a, k, out: out.speedup))
    flags = ["--preset", "tiny", "--ckpt-every", "6", "--relu-ffn"]
    runs = {}
    for steps in (12, 18):  # 12 steps with checkpoints at 6 and 12, then a resume to 18
        argv = [*flags, "--steps", str(steps)]
        want = run_jax_example(jmod, [*argv, "--ckpt-dir", str(tmp_path / "jax")], monkeypatch)
        jax_tree = fp32_init(jmod.M.param_specs(jmod.ModelConfig(
            name="lm-tiny", family="dense", **{k: v for k, v in jmod.PRESETS["tiny"].items()
                                               if k not in ("seq", "batch")},
            activation="relu", remat=False, q_chunk=jmod.PRESETS["tiny"]["seq"])), jax.random.PRNGKey(0))
        monkeypatch.setattr(tlm, "init_model", carried(jax_tree))
        got, res = run_port_example(tlm, [*argv, "--ckpt-dir", str(tmp_path / "port")])
        runs[steps] = (want, got, res)
    jsteps = rec.metrics
    (w12, g12, r12), (w18, g18, r18) = runs[12], runs[18]
    assert len(jsteps) == 18 and [h["step"] for h in r12["history"] + r18["history"]] == list(range(1, 19))
    for h, jm in zip(r12["history"] + r18["history"], jsteps):
        assert _close(h["loss"], jm["loss"]) and _close(h["grad_norm"], jm["grad_norm"]), h["step"]
        assert abs(h["lr"] - jm["lr"]) <= 1e-6 * jm["lr"]
    # the tables: the same lines, the numbers above; the resume line equal
    assert r12["resumed_from"] is None and r18["resumed_from"] == 12
    assert g18[0] == w18[0] == "resuming from checkpoint step 12"
    for got, want in ((g12, w12), (g18, w18)):
        assert len(got) == len(want)
        assert [ln.split()[:2] for ln in got] == [ln.split()[:2] for ln in want]
        assert got[-1].split(" ")[:3] == want[-1].split(" ")[:3] == ["FFN", "activation", "sparsity"]
    n = 8 * 32 * 128  # the measured [batch * seq, d_ff] activation
    for res, frac, speedup in ((r12, fracs[0], speedups[0]), (r18, fracs[1], speedups[1])):
        assert 0.2 < frac < 0.8 and abs(res["ffn_sparsity"] - frac) * n <= 2
        if res["ffn_sparsity"] == frac:
            assert res["projection"] == speedup
        else:
            assert abs(res["projection"] - speedup) <= 0.02 * speedup


def test_train_pruned_matches_jax(monkeypatch):
    jmod = load_jax_example("train_pruned")
    rec, sparsities, encoded, packed = RecordingJax(), [], [], []
    monkeypatch.setattr(jmod, "jax", rec)
    monkeypatch.setattr(jmod, "init_params", fp32_init)
    monkeypatch.setattr(jmod, "simulate_conv", recorder(jmod.simulate_conv, sparsities,
                                                        lambda a, k, out: (k["sparsity"], out.speedup)))
    monkeypatch.setattr(jmod, "encode", recorder(jmod.encode, encoded, lambda a, k, out: np.asarray(a[0]).nbytes))
    monkeypatch.setattr(jmod, "compressed_bytes", recorder(jmod.compressed_bytes, packed))
    argv = ["--steps", "20", "--refresh-every", "10"]
    want = run_jax_example(jmod, argv, monkeypatch)
    jax_tree = fp32_init(jmod.M.param_specs(jmod.reduce_config(jmod.get_config("deepseek-7b"))),
                         jax.random.PRNGKey(0))
    monkeypatch.setattr(tpruned, "init_model", carried(jax_tree))
    got, res = run_port_example(tpruned, argv)
    assert got[0] == want[0] and got[-1] == want[-1] and len(got) == len(want) == 5
    rows = res["rows"]
    assert [r["step"] for r in rows] == [10, 20] and len(rec.metrics) == 20
    for r, (frac, speedup), nbytes, cbytes in zip(rows, sparsities, encoded, packed):
        assert _close(r["loss"], rec.metrics[r["step"] - 1]["loss"]), r["step"]
        assert abs(r["sparsity"] - frac) <= 1e-3 and 0.5 < frac
        assert r["projection"] == speedup if r["sparsity"] == frac else abs(r["projection"] - speedup) <= 0.02 * speedup
        assert abs(r["codec_ratio"] - cbytes / nbytes) <= 1e-3
