"""The port's examples (``repro_torch.examples``) against the JAX package's
(``examples/*.py``) on the CPU: quickstart, serve_batched and
train_cnn_sparsity.

Each JAX example is loaded from its file and its ``main`` run under a
patched ``sys.argv`` with stdout captured; the port's counterpart runs with
``--device cpu`` on the same initial parameters, carried across from the
JAX example's initialiser, and the printed tables are compared with the
timing columns left out.

Tolerances, and why:

* quickstart: every line equal but for the backend's name (JAX's
  ``interpret``, the port's ``reference``, each package's executor of the
  planned kernel on the host) and the runtime's ``|err|``: each package's
  product against its own dense product (XLA's dot, torch's matmul), whose
  last bits are not pinned; both must be below the kernels' fp32 tolerance
  2e-4.
* serve_batched runs both examples on fp32 parameters (the JAX example's
  initialiser patched to fp32): in bf16 a logit near-tie rounds to either
  side of a greedy pick once a product sums in another order (the engine
  tests of ``test_torch_serve.py`` are fp32 for the same reason).
* serve_batched, greedy: every request's tokens equal, the ``tokens_out``
  and chunk counts equal, the plan-cache misses equal and the hits equal
  once the port's decode steps are taken out (JAX's decode chunk is jitted:
  its one head plan is ``traced`` there; the port's eager chunk replays the
  cached plan, a hit a step).  Sampled (the default temperature 0.8): the
  port replays JAX's per-request key streams, so every request's tokens
  equal JAX's sampled run's, and each emits exactly its budget.
* train_cnn_sparsity: the forward logits and the gradients within 1e-5
  relative (fp32: the convolutions sum in another order); each epoch's A
  and G_O zero fractions within 2 elements of each tensor (a conv output
  within an fp32 rounding of 0 may fall on the other side of the ReLU); the
  projected speedups equal where the fractions are equal (the cycle model
  is exact), otherwise within 2%.
"""
import functools
import importlib.util
import io
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import model as JM
from repro.models.common import init_params as jinit_params
from repro_torch.convert import params_from_jax
from repro_torch.configs import get_config, reduce_config
from repro_torch.examples import quickstart as tquick
from repro_torch.examples import serve_batched as tserve
from repro_torch.examples import train_cnn_sparsity as tcnn

ROOT = Path(__file__).resolve().parents[1]
#: the runtime's |err| bound: the kernels' fp32 tolerance (kernel_tolerance)
ERR_BOUND = 2e-4


def load_jax_example(name: str):
    """``examples/<name>.py`` as a fresh module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_example(mod, argv: list, monkeypatch) -> list[str]:
    """``mod.main()`` under ``sys.argv = [file] + argv``: its stdout lines."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main()
    return out.getvalue().splitlines()


def run_port_example(mod, argv: list) -> tuple[list[str], dict]:
    """``mod.main(argv + --device cpu)``: its stdout lines and its result."""
    out = io.StringIO()
    with redirect_stdout(out):
        res = mod.main([*argv, "--device", "cpu"])
    return out.getvalue().splitlines(), res


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_prints_jax_numbers(monkeypatch):
    want = run_jax_example(load_jax_example("quickstart"), [], monkeypatch)
    got, res = run_port_example(tquick, [])
    assert len(got) == len(want) == 6
    assert got[:4] == want[:4]  # PE, MAC fidelity, codec, conv projection: exactly
    err = re.compile(r"\|err\| = ([0-9.e+-]+)")
    assert re.sub(err, "", got[4]) == re.sub(err, "", want[4]).replace("runtime[interpret]", "runtime[reference]")
    errs = [float(err.search(line).group(1)) for line in (got[4], want[4])]
    assert max(errs) < ERR_BOUND and f"{res['runtime_err']:.1e}" == f"{errs[0]:.1e}"
    # the plan cache's counts; JAX's dict adds ``traced`` (plans built inside a jit trace: 0 here)
    assert got[5] == want[5].replace("interpret", "reference").replace(", 'traced': 0", "")
    assert res["ambient"] == "reference" and res["exact"]


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------

SERVE = ["--backend", "reference"]


def _serve_table(lines: list[str]) -> dict:
    """The numbers of serve_batched's table, timing left out."""
    served = re.search(r"served (\d+) tokens in .*traced (\d+)x for (\d+) chunks", lines[1])
    cache = re.search(r"backend=(\w+) plan cache: (\d+) hits / (\d+) misses / (\d+) traced", lines[2])
    reqs = {int(m.group(1)): eval(m.group(2)) for m in (re.match(r"\s+req(\d+): (\[.*\])", ln) for ln in lines[3:])}
    return {"head": lines[0], "tokens_out": int(served.group(1)), "traced": int(served.group(2)),
            "chunks": int(served.group(3)), "backend": cache.group(1), "hits": int(cache.group(2)),
            "misses": int(cache.group(3)), "plans_traced": int(cache.group(4)), "requests": reqs}


#: the parameters' dtype in both serve examples (see the module docstring)
fp32_init = functools.partial(jinit_params, dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_serve_params():
    """The JAX example's parameters (``init_params`` at key 0, fp32) as numpy."""
    cfg = jreduce_config(jget_config("qwen3-4b"))
    return jax.tree.map(np.asarray, fp32_init(JM.param_specs(cfg), jax.random.PRNGKey(0)))


def run_jax_serve(argv: list, monkeypatch) -> tuple[dict, dict]:
    """The JAX serve_batched example on fp32 parameters: its table and every
    request's tokens (not only the two it prints)."""
    jserve = load_jax_example("serve_batched")
    monkeypatch.setattr(jserve, "init_params", fp32_init)
    jax_tokens = {}

    class Recording(jserve.ServeEngine):
        def run(self):
            out = super().run()
            jax_tokens.update({rid: [int(t) for t in toks] for rid, toks in out.items()})
            return out

    monkeypatch.setattr(jserve, "ServeEngine", Recording)
    return _serve_table(run_jax_example(jserve, argv, monkeypatch)), jax_tokens


def test_serve_batched_greedy_tokens_equal_jax(monkeypatch, jax_serve_params):
    want, jax_tokens = run_jax_serve([*SERVE, "--temperature", "0"], monkeypatch)
    monkeypatch.setattr(tserve, "init_model", lambda cfg, device: params_from_jax(jax_serve_params, cfg,
                                                                                 device=device))
    lines, res = run_port_example(tserve, [*SERVE, "--temperature", "0"])
    got = _serve_table(lines)
    assert got["head"] == want["head"] and got["backend"] == want["backend"] == "reference"
    assert got["requests"] == want["requests"] and len(got["requests"]) == 2
    assert res["tokens"] == jax_tokens and len(jax_tokens) == 8
    assert (got["tokens_out"], got["chunks"]) == (want["tokens_out"], want["chunks"])
    # one miss: the LM-head plan at the first prefill; the later prefills' hits equal,
    # and the port's eager decode hits once a step where JAX's jit traced the plan once
    st = res["stats"]
    assert got["misses"] == want["misses"] == 1
    assert got["hits"] - st["steps_run"] == want["hits"] and want["plans_traced"] == 1
    assert got["traced"] == st["decode_graph_captures"] == 0  # eager on the CPU: no graph captured


def test_serve_batched_sampled_keeps_budgets(jax_serve_params, monkeypatch):
    """The documented default, temperature 0.8: every request emits its
    budget, and every request's tokens and the table equal JAX's sampled
    run's (the port replays JAX's per-request key streams)."""
    want, jax_tokens = run_jax_serve(SERVE, monkeypatch)
    monkeypatch.setattr(tserve, "init_model", lambda cfg, device: params_from_jax(jax_serve_params, cfg,
                                                                                 device=device))
    lines, res = run_port_example(tserve, SERVE)
    got = _serve_table(lines)
    budgets = res["budgets"]
    assert len(budgets) == 8 and {rid: len(t) for rid, t in res["tokens"].items()} == budgets
    # the greedy run's count (JAX's table: every request runs to its budget)
    assert got["tokens_out"] == want["tokens_out"] == sum(budgets.values()) == 92
    vocab = reduce_config(get_config("qwen3-4b")).vocab_size
    assert all(0 <= tok < vocab for toks in res["tokens"].values() for tok in toks)
    assert res["tokens"] == jax_tokens and got["requests"] == want["requests"]
    assert (got["head"], got["chunks"]) == (want["head"], want["chunks"])


# ---------------------------------------------------------------------------
# train_cnn_sparsity
# ---------------------------------------------------------------------------

CNN_RTOL = 1e-5


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def jcnn():
    return load_jax_example("train_cnn_sparsity")


def test_cnn_forward_and_gradients_equal_jax(jcnn):
    jp = jcnn.init_cnn(jax.random.PRNGKey(0))
    x, y = jcnn.make_data(np.random.default_rng(0), 64)
    tp = tcnn.cnn_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    xt = torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()
    yt = torch.from_numpy(np.array(y))
    (jl, jacts), jg = jax.value_and_grad(lambda p: jcnn.loss_fn(p, x, y), has_aux=True)(jp)
    logits, acts = tcnn.forward(tp, xt)
    assert _rel(logits.numpy(), np.asarray(jcnn.forward(jp, x)[0])) <= CNN_RTOL
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss = tcnn.loss_fn(leaves, xt, yt)[0]
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(float(loss.detach()) - float(jl)) <= CNN_RTOL * abs(float(jl))
    for k, g in grads.items():
        want = np.asarray(jg[k])
        got = g.numpy().transpose(2, 3, 1, 0) if k.startswith("conv") else g.numpy()  # OIHW -> HWIO
        assert _rel(got, want) <= CNN_RTOL, k
    for k, a in acts.items():  # the post-ReLU activations, NCHW against NHWC
        assert _rel(a.detach().numpy().transpose(0, 2, 3, 1), np.asarray(jacts[k])) <= CNN_RTOL


def test_cnn_max_pool_routes_a_window_of_zeros_to_one_element_as_jax(jcnn):
    """After the ReLU whole pool windows are 0: both packages send such a
    window's gradient to its first element (and a tie of equal positives
    too), so G_O's zero pattern is the same element for element."""
    x, y = jcnn.make_data(np.random.default_rng(0), 128)
    jp = jcnn.init_cnn(jax.random.PRNGKey(0))
    tp = tcnn.cnn_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    _, jacts = jcnn.forward(jp, x)
    jprobes = {f"g{i}": jax.numpy.zeros_like(jacts[f"a{i}"]) for i in range(2)}
    jg = jax.grad(lambda pr: jcnn.loss_fn(jp, x, y, pr)[0])(jprobes)
    xt = torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()
    _, acts = tcnn.forward(tp, xt)
    probes = {f"g{i}": torch.zeros_like(acts[f"a{i}"], requires_grad=True) for i in range(2)}
    tg = torch.autograd.grad(tcnn.loss_fn(tp, xt, torch.from_numpy(np.array(y)), probes)[0],
                             list(probes.values()))
    for i, g in enumerate(tg):
        want = np.asarray(jg[f"g{i}"]) != 0
        got = g.numpy().transpose(0, 2, 3, 1) != 0
        zero_windows = int((np.asarray(jacts[f"a{i}"]) == 0).reshape(128, want.shape[1] // 2, 2,
                                                                    want.shape[2] // 2, 2, -1).all(axis=(2, 4)).sum())
        assert zero_windows > 0  # windows of equal zeros occur here
        assert int((got != want).sum()) <= 2, f"g{i}"
        # one selected element per window: 3 of every 4 gradients are zero
        assert int(got.sum()) <= got.size // 4


def test_cnn_example_table_matches_jax(jcnn, monkeypatch):
    seen = {"measure": [], "speedup": []}
    measure, speedup = jcnn.measure_epoch, jcnn.model_speedup

    def jmeasure(params, x, y):
        out = measure(params, x, y)
        seen["measure"].append(out)
        return out

    def jspeedup(*args, **kw):
        out = speedup(*args, **kw)
        seen["speedup"].append(out)
        return out

    monkeypatch.setattr(jcnn, "measure_epoch", jmeasure)
    monkeypatch.setattr(jcnn, "model_speedup", jspeedup)
    argv = ["--epochs", "2", "--steps-per-epoch", "5"]
    want = run_jax_example(jcnn, argv, monkeypatch)
    jp = jax.tree.map(np.asarray, jcnn.init_cnn(jax.random.PRNGKey(0)))
    monkeypatch.setattr(tcnn, "init_cnn", lambda device: tcnn.cnn_params_from_jax(jp, device))
    got, res = run_port_example(tcnn, argv)
    assert got[0] == want[0] and len(got) == len(want) == 5
    assert len(seen["measure"]) == len(seen["speedup"]) == len(res["epochs"]) == 2
    sizes = {"a0": 128 * 12 * 12 * 16, "a1": 128 * 6 * 6 * 32}
    for ep, ((ja, jg), jproj) in zip(res["epochs"], zip(seen["measure"], seen["speedup"])):
        for k, n in sizes.items():
            g = "g" + k[1:]
            assert abs(ep["a_sp"][k] - ja[k]) * n <= 2, (ep["epoch"], k)
            assert abs(ep["g_sp"][g] - jg[g]) * n <= 2, (ep["epoch"], g)
        same = ep["a_sp"] == ja and ep["g_sp"] == jg
        for conv, v in jproj.items():
            if same:
                assert ep["projection"][conv] == v, (ep["epoch"], conv)
            else:
                assert abs(ep["projection"][conv] - v) <= 0.02 * v, (ep["epoch"], conv)
    # the printed columns: the loss (the last training step's, 3 decimals) to its
    # printed digits or one unit of the last; the rest equal where the fractions are
    for ep, (ja, jg), g_line, w_line in zip(res["epochs"], seen["measure"], got[1:3], want[1:3]):
        g_loss, w_loss = float(g_line.split()[1]), float(w_line.split()[1])
        assert abs(g_loss - w_loss) <= 1e-3 + 1e-5 * abs(w_loss)
        if ep["a_sp"] == ja and ep["g_sp"] == jg:
            assert g_line.split()[2:] == w_line.split()[2:]
