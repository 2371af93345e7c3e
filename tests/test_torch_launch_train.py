"""The port's train launcher (``repro_torch.launch.train``) on the CPU.

* Against the step: ``main(["--smoke", "--device", "cpu", "--backend",
  "reference", ...])`` gives the same losses and gradient norms, bit for
  bit, as the port's ``make_train_step`` driven directly on the same seed,
  config and batches (plain, and microbatched with taps and dynamic
  sparsity through the controller).  The JAX launcher cannot be the
  reference: it fails under its mesh on this JAX (ROADMAP queue 3).
* The four train cases of ``tests/test_launch_resilience.py``, on the
  port's launcher: a straggler past ``--step-deadline`` checkpoints and
  aborts, an injected preemption checkpoints and exits, an isolated NaN
  step is skipped, repeated NaN steps checkpoint before exit code 3.
* Resume: a run restarted from its checkpoint prints ``resumed at step N``
  and continues with the uninterrupted run's losses.
"""
import dataclasses

import pytest
import torch

from repro_torch import runtime as trt
from repro_torch.checkpoint.manager import all_steps
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.models.common import init_params
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.runtime import BackendCapabilityError
from repro_torch.train.step import make_train_step

_CPU = ["--smoke", "--device", "cpu", "--backend", "reference"]
_TRAIN_ARGS = _CPU + ["--steps", "4", "--batch", "8", "--seq", "16", "--fault-backoff", "0.01"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def step_metrics(monkeypatch):
    """Every step's metrics as the launcher's step function returns them."""
    seen = []
    orig = launch_train.make_train_step

    def spy(*args, **kw):
        fn = orig(*args, **kw)

        def step(*a, **k):
            out = fn(*a, **k)
            seen.append(out[2])
            return out
        return step

    monkeypatch.setattr(launch_train, "make_train_step", spy)
    return seen


@pytest.mark.parametrize("extra", [[], ["--microbatches", "2", "--sparsity-taps",
                                        "--dynamic-sparsity", "target=0.5,update_every=1,end=3"]],
                         ids=["plain", "microbatched-taps-dst"])
def test_launcher_losses_equal_make_train_step(extra, step_metrics, capsys):
    launch_train.main(_CPU + ["--steps", "3", "--seq", "16", "--batch", "4"] + extra)
    out = capsys.readouterr().out
    assert "done" in out and "step     1 loss" in out

    dst = "--dynamic-sparsity" in extra
    cfg = dataclasses.replace(reduce_config(get_config("qwen3-4b")), remat=False)
    rt = trt.Runtime(backend="reference", device="cpu", bm=8, bk=16, bn=16)
    with rt.use():
        params = init_params(TM.param_specs(cfg), seed=0, device="cpu")
        opt = init_opt_state(params)
        data = SyntheticLM(cfg.vocab_size, 16, 4)
        ctrl = masks = None
        if dst:
            from repro_torch.sparse_train import DynamicSparsityConfig, DynamicSparsityController

            ctrl = DynamicSparsityController(DynamicSparsityConfig(target=0.5, update_every=1, end=3), params)
            masks = ctrl.masks()
        step = make_train_step(cfg, OptConfig(total_steps=100), microbatches=2 if dst else 1,
                               sparsity_taps=dst, dynamic_sparsity=ctrl, guard_nonfinite=True)
        want = []
        for i in range(3):
            params, opt, m = step(params, opt, data.batch_at(i, device="cpu"), masks, poison=0)
            want.append(m)
            if ctrl is not None and ctrl.should_update(i):
                ctrl.update(i, m["dst_w_scores"], m["dst_g_scores"])
                masks = ctrl.masks()
    assert len(step_metrics) == 3
    for got, w in zip(step_metrics, want):
        assert float(got["loss"]) == float(w["loss"])
        assert float(got["grad_norm"]) == float(w["grad_norm"])
        if dst:
            assert float(got["dst_density"]) == float(w["dst_density"])
    if dst:
        assert "dst refresh step" in out and "plan-edit" in out and "Wdens=" in out
        assert float(step_metrics[-1]["dst_density"]) < 1.0


def test_train_straggler_deadline_checkpoints_and_aborts(tmp_path, capsys):
    launch_train.main(_TRAIN_ARGS + [
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "100",
        "--step-deadline", "2", "--inject-faults", "step_stall@1:secs=3",
    ])
    out = capsys.readouterr().out
    assert "exceeded deadline" in out
    assert all_steps(tmp_path) == [2]  # aborted at step 1: saved i+1
    assert "deadline -> checkpoint-abort" in out


def test_train_preemption_guard_checkpoints_and_exits(tmp_path, capsys):
    launch_train.main(_TRAIN_ARGS + [
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "100", "--inject-faults", "preempt@1",
    ])
    out = capsys.readouterr().out
    assert "preemption: saved, exiting" in out
    assert all_steps(tmp_path) == [2]
    assert "preempt -> checkpoint-exit" in out


def test_train_isolated_nan_step_is_skipped_and_run_completes(capsys):
    launch_train.main(_TRAIN_ARGS + ["--inject-faults", "nan_loss@1"])
    out = capsys.readouterr().out
    assert "update skipped (1/3 consecutive)" in out
    assert out.rstrip().endswith("done")
    assert "nonfinite -> skip-step x1" in out


def test_train_repeated_nan_checkpoint_before_abort(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        launch_train.main(_TRAIN_ARGS + [
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "100",
            "--inject-faults", "nan_loss@1:count=3", "--max-faults", "3",
        ])
    assert exc.value.code == 3
    out = capsys.readouterr().out
    assert "checkpointed, aborting" in out
    assert all_steps(tmp_path) == [4]  # the last healthy params are on disk
    assert "nonfinite -> checkpoint-abort" in out


def test_resume_continues_the_uninterrupted_run(tmp_path, step_metrics, capsys):
    args = _CPU + ["--steps", "6", "--seq", "16", "--batch", "4"]
    launch_train.main(args + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4"])
    assert all_steps(tmp_path) == [4]
    full = [float(m["loss"]) for m in step_metrics]
    first = capsys.readouterr().out
    step_metrics.clear()
    launch_train.main(args + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "100"])
    out = capsys.readouterr().out
    assert "resumed at step 4" in out
    assert [float(m["loss"]) for m in step_metrics] == full[4:]
    line = lambda text: next(x for x in text.splitlines() if x.startswith("step     5 loss"))
    assert line(out).rsplit(" ", 1)[0] == line(first).rsplit(" ", 1)[0]  # all but the seconds


def test_launcher_refusals():
    # the production mesh needs its 512 ranks (tests/test_torch_launch_mesh.py runs it on 4)
    with pytest.raises(ValueError, match="needs a process group of 512 ranks; this one has 1"):
        launch_train.main(_CPU + ["--multi-pod"])
    with pytest.raises(SystemExit):  # argparse: an unknown --dynamic-sparsity key
        launch_train.main(_CPU + ["--dynamic-sparsity", "frob=1"])
    assert launch_train.parse_dynamic_sparsity("target=0.9, update-every=100,exclude=embed+lm") == {
        "target": 0.9, "update_every": 100, "exclude": ("embed", "lm")}
    if not torch.cuda.is_available():  # the defaults ask for the card: refused at once
        with pytest.raises(BackendCapabilityError):
            launch_train.main(["--smoke", "--steps", "1"])
