"""repro_torch.serve's resilience hooks and decode graph against repro.serve
on the CPU.

The JAX suite's reduced deepseek-7b with a ReLU FFN, fp32 weights carried by
``params_from_jax``, the ``reference`` backend on both sides.  Each case of
``tests/test_resilience.py``'s serve chaos suite and of the serve replays of
``tests/test_launch_resilience.py`` runs through the port: a NaN/Inf-poisoned
slot is retired by the watchdog while its batch-mates stay bit-identical to
the clean run, and tokens, finish reasons and the ``ResilienceLog``'s kinds,
sites and actions equal the JAX engine's on the same fault plan, greedy and
at temperature 0.8 (the port replays JAX's per-request key streams); TTL
expiry, ``QueueFull``,
work-budget shedding (the shed rids equal JAX's), slot halving and admission
retries.  The CUDA-graph bookkeeping (warm-up, one capture, replays, a
recapture for a changed LM head) runs here with stand-ins for the
``torch.cuda`` graph calls; capture itself needs the card (``chip_smoke.py``).
"""
import contextlib
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import model as JM
from repro.models.common import init_params as jinit_params
from repro.resilience import FaultPlan as JFaultPlan
from repro.resilience import ResilienceLog as JResilienceLog
from repro.serve import engine as jengine_mod
from repro.serve.engine import QueueFull as JQueueFull
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import runtime as trt
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import tensordash_spmm as T
from repro_torch.launch import serve as launch_serve
from repro_torch.resilience import FaultPlan, ResilienceLog
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import QueueFull, ServeEngine

GEOM = dict(bm=8, bk=16, bn=16)
#: the chaos suite's serve shape: 2 slots, chunks of 3, room for every budget
SLOTS, MAX_LEN, CHUNK = 2, 32, 3


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jreduce_config(jget_config("deepseek-7b")), activation="relu")
    tcfg = dataclasses.replace(reduce_config(get_config("deepseek-7b")), activation="relu")
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _port(tp, tcfg, **kw):
    kw = {"slots": SLOTS, "max_len": MAX_LEN, "chunk": CHUNK, **kw}
    rt = kw.pop("rt", None) or trt.Runtime(backend="reference", device="cpu", **GEOM)
    return ServeEngine(tp, tcfg, rt=rt, **kw)


def _jax(jp, jcfg, **kw):
    kw = {"slots": SLOTS, "max_len": MAX_LEN, "chunk": CHUNK, **kw}
    return JServeEngine(jp, jcfg, rt=jrt.Runtime(backend="reference", **GEOM), **kw)


def _run(eng, prompts, budgets, **submit):
    for p, n in zip(prompts, budgets):
        eng.submit(torch.from_numpy(p) if isinstance(eng, ServeEngine) else p, max_new=n, **submit)
    return eng.run()


def _events(log):
    return [(e.kind, e.site, e.action, e.detail.get("rid")) for e in log.events]


def _reasons(eng):
    return {rid: r.finish_reason for rid, r in eng._requests.items()}


def test_prefill_step_and_decode_one_match_jax(model):
    """The engine module's one-call helpers: prompt logits and caches, then
    one decode step at per-row positions, against JAX's on the same
    weights (fp32, ``reference``; ``test_torch_model``'s tolerance)."""
    jcfg, tcfg, jp, tp = model
    prompts = np.stack(_prompts(tcfg.vocab_size, (6, 6), 9))
    jr, tr = jrt.Runtime(backend="reference", **GEOM), trt.Runtime(backend="reference", device="cpu", **GEOM)
    with jrt.use(jr):
        jlogits, jcaches = jengine_mod.prefill_step(jp, jcfg, {"tokens": jnp.asarray(prompts)})
        jcaches = jr.grow_caches(jcfg, jcaches, 2, 8)
        nxt = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)
        jstep, _ = jengine_mod.decode_one(jp, jcfg, jcaches, {"tokens": nxt[:, None]}, jnp.asarray([6, 6], jnp.int32))
    with torch.inference_mode(), tr.use():
        tlogits, tcaches = engine_mod.prefill_step(tp, tcfg, {"tokens": torch.from_numpy(prompts).long()})
        tcaches = tr.grow_caches(tcfg, tcaches, 2, 8)
        tnxt = torch.tensor(np.asarray(nxt), dtype=torch.int64)
        tstep, _ = engine_mod.decode_one(tp, tcfg, tcaches, {"tokens": tnxt[:, None]}, torch.tensor([6, 6]))
    # test_torch_model's fp32 bound: the bf16 KV cache rounds K/V, and a
    # last-bit difference before that rounding can flip a bf16 value
    for got, want in ((tlogits, jlogits), (tstep, jstep)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("kind", ["nan_logits", "inf_logits"])
def test_watchdog_retires_poisoned_slot_healthy_bitident(model, kind, temperature):
    """Poison slot 1's logits in the first chunk: that request errors, its
    batch-mates' tokens are bit-identical to the clean run, and the whole
    replay equals the JAX engine's on the same plan, sampled too."""
    jcfg, tcfg, jp, tp = model
    prompts, budgets = _prompts(tcfg.vocab_size, (5, 8, 5), 0), (6, 7, 5)
    clean = _run(_port(tp, tcfg, temperature=temperature, seed=0), prompts, budgets)
    log = ResilienceLog()
    eng = _port(tp, tcfg, temperature=temperature, seed=0, log=log,
                fault_plan=FaultPlan.parse(f"{kind}@0:slot=1"))
    out = _run(eng, prompts, budgets)
    victim = eng._requests[1]
    assert victim.finish_reason == "error" and not victim.ok and "watchdog" in victim.error
    for rid in (0, 2):
        assert out[rid] == clean[rid], f"rid {rid} perturbed by the slot 1 fault"
        assert eng._requests[rid].ok
    ev = log.by_kind("nonfinite")
    assert len(ev) == 1 and ev[0].action == "retire-slot" and ev[0].detail["rid"] == 1
    assert eng.stats()["resilience_events"] == len(log)
    jlog = JResilienceLog()
    jeng = _jax(jp, jcfg, temperature=temperature, seed=0, log=jlog,
                fault_plan=JFaultPlan.parse(f"{kind}@0:slot=1"))
    assert out == _run(jeng, prompts, budgets)
    assert _reasons(eng) == _reasons(jeng)
    assert _events(log) == _events(jlog)


def test_watchdog_off_propagates_poison(model):
    """Without the watchdog the poisoned slot keeps emitting tokens: the
    fault is real, the watchdog is what contains it."""
    _, tcfg, _, tp = model
    log = ResilienceLog()
    eng = _port(tp, tcfg, log=log, watchdog=False, fault_plan=FaultPlan.parse("nan_logits@0:slot=0"))
    out = _run(eng, _prompts(tcfg.vocab_size, (5,), 0), (6,))
    req = eng._requests[0]
    assert req.finish_reason == "length" and req.error is None
    assert len(out[0]) == 6
    assert not log.by_kind("nonfinite")


# ---------------------------------------------------------------------------
# deadlines, the bounded queue, shedding
# ---------------------------------------------------------------------------


def test_ttl_expires_pending_and_running(model):
    """Both deadlines forced into the past: the running request is evicted
    (its ``active`` lane cleared in place) and the pending one dropped, with
    the JAX engine's finish reasons, tokens and log events."""
    jcfg, tcfg, jp, tp = model
    (p,) = _prompts(tcfg.vocab_size, (5,), 1)
    runs = []
    for eng, conv in ((_port(tp, tcfg, slots=1, chunk=2, log=ResilienceLog()), torch.from_numpy),
                      (_jax(jp, jcfg, slots=1, chunk=2, log=JResilienceLog()), lambda x: x)):
        active = eng.active
        r_run = eng.submit(conv(p), max_new=20, ttl=1000.0)
        r_wait = eng.submit(conv(p), max_new=4, ttl=1000.0)
        eng.step()  # admits r_run into the only slot; r_wait pending
        assert eng._requests[r_run].slot == 0
        eng._requests[r_run].deadline = eng.now() - 1.0
        eng._requests[r_wait].deadline = eng.now() - 1.0
        finished = eng.step()
        assert {r.rid: r.finish_reason for r in finished} == {r_run: "expired", r_wait: "expired"}
        assert {e.site for e in eng.log.by_kind("deadline")} == {"serve.slot", "serve.pending"}
        assert not eng.sched.has_work and not bool(np.asarray(eng.active)[0])
        runs.append((_reasons(eng), _events(eng.log), [r.tokens for r in eng._requests.values()]))
        if isinstance(eng, ServeEngine):
            assert eng.active is active  # the lane was cleared in place
    assert runs[0] == runs[1]


def test_queue_full_is_typed_and_drains(model):
    jcfg, tcfg, jp, tp = model
    (p,) = _prompts(tcfg.vocab_size, (5,), 2)
    runs = []
    for eng, conv in ((_port(tp, tcfg, slots=1, chunk=2, max_pending=2, log=ResilienceLog()),
                       torch.from_numpy),
                      (_jax(jp, jcfg, slots=1, chunk=2, max_pending=2, log=JResilienceLog()),
                       lambda x: x)):
        eng.submit(conv(p), max_new=2)
        eng.submit(conv(p), max_new=2)
        with pytest.raises((QueueFull, JQueueFull), match="retry with backoff"):
            eng.submit(conv(p), max_new=2)
        assert len(eng._requests) == 2  # the rejected one was never registered
        assert eng.log.by_kind("queue")[0].action == "reject"
        eng.step()  # drains one pending into the slot
        rid = eng.submit(conv(p), max_new=2)
        out = eng.run()
        assert eng._requests[rid].ok
        runs.append((out, _events(eng.log)))
    assert runs[0] == runs[1]


def test_plan_aware_shedding_is_not_queue_full(model):
    """Cold: a dense runtime prices a token at 1.0 and sheds the
    lowest-priority submit past the budget.  Warm: once the LM-head plan is
    cached a token costs its ``total_work``, and the same traffic sheds the
    same rids as the JAX engine."""
    jcfg, tcfg, jp, tp = model
    p = _prompts(tcfg.vocab_size, (5,), 3)[0]
    log = ResilienceLog()
    eng = _port(tp, tcfg, slots=1, chunk=2, work_budget=10.0, log=log,
                rt=trt.Runtime(backend="dense", device="cpu"))
    assert eng._plan_cost() == 1.0
    keep = eng.submit(torch.from_numpy(p), max_new=8, priority=5)
    victim = eng.submit(torch.from_numpy(p), max_new=8, priority=0)  # 16 > 10
    assert eng._requests[victim].finish_reason == "shed"
    assert not eng._requests[keep].finished
    ev = log.by_kind("queue")
    assert ev and ev[-1].action == "shed" and ev[-1].detail["rid"] == victim
    eng.run()
    assert eng._requests[keep].ok

    prompts = _prompts(tcfg.vocab_size, (5, 6, 5, 7, 5), 4)
    shed = []
    for make, log in ((_port, ResilienceLog()), (_jax, JResilienceLog())):
        e = make(*((tp, tcfg) if make is _port else (jp, jcfg)), slots=1, chunk=2, log=log)
        conv = torch.from_numpy if make is _port else (lambda x: x)
        e.submit(conv(prompts[0]), max_new=4)
        e.step()  # the first prefill caches the LM-head plan
        cost = e._plan_cost()
        e.work_budget = cost * 12
        for i, p in enumerate(prompts[1:]):
            e.submit(conv(p), max_new=4, priority=i % 2)
        e.run()
        shed.append(([r.rid for r in e._requests.values() if r.finish_reason == "shed"], cost,
                     _events(log)))
    assert shed[0] == shed[1] and shed[0][0] and shed[0][1] > 1.0


# ---------------------------------------------------------------------------
# allocation failures
# ---------------------------------------------------------------------------


def test_alloc_failure_halves_slots(model):
    jcfg, tcfg, jp, tp = model
    log = ResilienceLog()
    eng = _port(tp, tcfg, slots=4, chunk=2, log=log,
                fault_plan=FaultPlan.parse("alloc_fail@0:where=slot_caches"))
    assert eng.sched.num_slots == 2 and len(eng.sched.table) == 2
    assert eng.tok.shape == (2,) and eng.caches["layers"][0].k.shape[0] == 2
    assert log.by_kind("alloc")[0].action == "halve-slots"
    prompt = _prompts(tcfg.vocab_size, (5,), 4)[0]
    out = _run(eng, [prompt], (3,))
    assert eng._requests[0].ok
    jeng = _jax(jp, jcfg, slots=4, chunk=2, fault_plan=JFaultPlan.parse("alloc_fail@0:where=slot_caches"))
    assert out == _run(jeng, [prompt], (3,))


def test_alloc_failure_at_admission_requeues_and_recovers(model):
    jcfg, tcfg, jp, tp = model
    prompts, budgets = _prompts(tcfg.vocab_size, (5, 5), 5), (4, 4)
    clean = _run(_port(tp, tcfg), prompts, budgets)
    log, jlog = ResilienceLog(), JResilienceLog()
    eng = _port(tp, tcfg, log=log, fault_plan=FaultPlan.parse("alloc_fail@0:where=grow_caches"))
    out = _run(eng, prompts, budgets)
    assert "requeue" in [e.action for e in log.by_kind("alloc")]
    for rid in (0, 1):  # the transient failure cost a retry, not the result
        assert eng._requests[rid].ok and out[rid] == clean[rid]
    jeng = _jax(jp, jcfg, log=jlog, fault_plan=JFaultPlan.parse("alloc_fail@0:where=grow_caches"))
    assert out == _run(jeng, prompts, budgets)
    assert _events(log) == _events(jlog)


def test_alloc_failure_exhausts_retries_fails_one_request(model):
    _, tcfg, _, tp = model
    (p,) = _prompts(tcfg.vocab_size, (5,), 6)
    log = ResilienceLog()
    eng = _port(tp, tcfg, slots=1, chunk=2, log=log,
                fault_plan=FaultPlan.parse("alloc_fail@0:count=99,where=grow_caches"))
    rid = eng.submit(torch.from_numpy(p), max_new=3)
    for _ in range(2 * eng.MAX_ADMIT_RETRIES + 4):
        if eng._requests[rid].finished:
            break
        eng.step()
    req = eng._requests[rid]
    assert req.finished and req.finish_reason == "error" and "admission failed" in req.error
    assert req.retries > eng.MAX_ADMIT_RETRIES
    assert log.by_kind("alloc")[-1].action == "fail-request"
    assert not eng.sched.has_work  # the engine loop survived


def test_step_stall_fires_on_the_step_tick(model, monkeypatch):
    _, tcfg, _, tp = model
    slept = []
    monkeypatch.setattr(engine_mod.rfaults._time, "sleep", slept.append)
    eng = _port(tp, tcfg, fault_plan=FaultPlan.parse("step_stall@1:secs=0.25"))
    _run(eng, _prompts(tcfg.vocab_size, (5,), 7), (8,))
    assert slept == [0.25] and eng._requests[0].ok


# ---------------------------------------------------------------------------
# the launcher's replays
# ---------------------------------------------------------------------------

_SERVE_ARGS = ["--smoke", "--activation", "relu", "--device", "cpu", "--backend", "reference",
               "--requests", "4", "--slots", "2", "--new", "4", "--prompt-len", "8", "--chunk", "4",
               "--block", "2", "16", "16"]


@pytest.mark.parametrize("spec,code", [("nan_logits@0:count=999", 2), ("nan_logits@1:slot=0", None)])
def test_serve_launcher_fault_replay(spec, code, capsys):
    """All requests poisoned: ``n/a`` percentiles, ``error=4`` and exit code
    2; one slot poisoned at chunk 1: mixed finish reasons, the resilience
    summary, exit 0."""
    if code is None:
        assert launch_serve.main(_SERVE_ARGS + ["--inject-faults", spec]) is None
    else:
        with pytest.raises(SystemExit) as exc:
            launch_serve.main(_SERVE_ARGS + ["--inject-faults", spec])
        assert exc.value.code == code
    cap = capsys.readouterr()
    latency = cap.out.split("latency", 1)[1].split("\n", 1)[0]
    assert "nan" not in latency
    if code is None:
        assert "error=" in cap.out and "length=" in cap.out
        assert "resilience:" in cap.out and "retire-slot" in cap.out
    else:
        assert "e2e p50=n/a" in latency and "error=4" in cap.out
        assert "no request finished cleanly" in cap.err


# ---------------------------------------------------------------------------
# the decode graph
# ---------------------------------------------------------------------------


class _Stream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


def _fake_cuda(monkeypatch, graph_cls, graph_ctx):
    """Stand-ins for the ``torch.cuda`` stream and graph calls of
    ``_DecodeGraph`` (the CPU build has no CUDA streams)."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", graph_cls)
    monkeypatch.setattr(torch.cuda, "graph", graph_ctx)


def _state(eng):
    """An engine's static buffers and caches: what a decode chunk writes
    (a bf16 KV cache's scale fields are ``None``)."""
    return [eng.tok, eng.pos, eng.active, eng.remaining, eng.poison, eng.keys,
            *(t for c in eng.caches["layers"] for t in c if t is not None)]


def test_decode_graph_warms_up_captures_once_and_recaptures_for_a_new_head(monkeypatch):
    calls = []

    class Graph:
        def replay(self):
            calls.append("replay")

    @contextlib.contextmanager
    def capture(graph, stream=None):
        calls.append("capture")
        yield

    _fake_cuda(monkeypatch, Graph, capture)
    dg = engine_mod._DecodeGraph(torch.device("cpu"))
    head = torch.zeros(3)
    chunk = lambda: calls.append("chunk") or len(calls)
    outs = [dg.run(chunk, head) for _ in range(4)]
    assert calls == ["chunk", "capture", "chunk", "replay", "replay", "replay"]
    assert (dg.captures, dg.replays) == (1, 3) and outs[1:] == [outs[1]] * 3
    head.add_(1)  # modified in place: its version moved
    calls.clear()
    dg.run(chunk, head), dg.run(chunk, head)
    assert calls == ["chunk", "capture", "chunk", "replay"] and dg.captures == 2
    calls.clear()
    dg.run(chunk, torch.zeros(3)), dg.run(chunk, head)  # another tensor, then the old one
    assert calls == ["chunk", "capture", "chunk", "replay"] and dg.captures == 3


def test_graph_chunk_over_static_buffers_equals_the_eager_loop(model, monkeypatch):
    """The engine's decode through ``_DecodeGraph`` with a stand-in graph
    whose capture records the chunk without letting it change the buffers
    and whose replay runs it again into the captured outputs: tokens, finish
    reasons and log equal the eager engine's under backfill and a poisoned
    slot; the static buffers and caches never move; one capture, a replay
    for every chunk after the warm-up."""
    _, tcfg, _, tp = model
    prompts, budgets = _prompts(tcfg.vocab_size, (5, 8, 5, 6, 7), 8), (6, 4, 7, 5, 3)
    spec = "nan_logits@2:slot=0"
    log = ResilienceLog()
    want = _run(_port(tp, tcfg, log=log, fault_plan=FaultPlan.parse(spec)), prompts, budgets)
    eng = _port(tp, tcfg, log=ResilienceLog(), fault_plan=FaultPlan.parse(spec))

    class Graph:
        def replay(self):
            for o, n in zip(eng._graph.out, eng._chunk()):
                o.copy_(n)

    @contextlib.contextmanager
    def capture(graph, stream=None):
        saved = [t.clone() for t in _state(eng)]
        yield
        for t, s in zip(_state(eng), saved):
            t.copy_(s)

    _fake_cuda(monkeypatch, Graph, capture)
    eng._graph = engine_mod._DecodeGraph(eng.device)
    ptrs = [t.data_ptr() for t in _state(eng)]
    got = _run(eng, prompts, budgets)
    assert got == want and _events(eng.log) == _events(log)
    assert [r.finish_reason for r in eng._requests.values()].count("error") == 1
    assert [t.data_ptr() for t in _state(eng)] == ptrs
    st = eng.stats()
    assert st["decode_graph_captures"] == 1 and st["decode_graph_replays"] == st["chunks_run"] - 1 >= 3


def test_sampled_graph_chunk_equals_jax(model, monkeypatch):
    """Sampled decoding through the decode graph (the same stand-ins: the
    capture leaves the buffers, the keys among them, as it found them; a
    replay runs the chunk into the captured outputs): with backfill and a
    poisoned slot, tokens, finish reasons and the log equal the JAX
    engine's at temperature 0.8 on the same seed and plan, with one
    capture."""
    jcfg, tcfg, jp, tp = model
    # the watchdog cases' prompt lengths: JAX's prefills are compiled already
    prompts, budgets = _prompts(tcfg.vocab_size, (5, 8, 5, 8, 5), 8), (6, 4, 7, 5, 3)
    spec = "nan_logits@2:slot=0"
    jlog = JResilienceLog()
    jeng = _jax(jp, jcfg, temperature=0.8, seed=3, log=jlog, fault_plan=JFaultPlan.parse(spec))
    want = _run(jeng, prompts, budgets)
    eng = _port(tp, tcfg, temperature=0.8, seed=3, log=ResilienceLog(), fault_plan=FaultPlan.parse(spec))

    class Graph:
        def replay(self):
            for o, n in zip(eng._graph.out, eng._chunk()):
                o.copy_(n)

    @contextlib.contextmanager
    def capture(graph, stream=None):
        saved = [t.clone() for t in _state(eng)]
        yield
        for t, s in zip(_state(eng), saved):
            t.copy_(s)

    _fake_cuda(monkeypatch, Graph, capture)
    eng._graph = engine_mod._DecodeGraph(eng.device)
    assert _run(eng, prompts, budgets) == want
    assert _reasons(eng) == _reasons(jeng) and _events(eng.log) == _events(jlog)
    assert list(_reasons(eng).values()).count("error") == 1
    st = eng.stats()
    assert st["decode_graph_captures"] == 1 and st["decode_graph_replays"] == st["chunks_run"] - 1 >= 3


def test_decode_graph_holds_its_plans_when_the_caches_drop_them(model, monkeypatch):
    """Two engines on one runtime whose LM heads differ, with room for one
    plan in the cache: the second engine's prefill evicts the first's
    LM-head plan, and the dense-plan memo is cleared after the capture.  The
    first engine's graph holds every plan its captured chunk read, so none
    of them is freed under its replays, and its tokens equal its run
    alone."""
    _, tcfg, _, tp = model
    prompts, budgets = _prompts(tcfg.vocab_size, (5, 6), 11), (9, 8)
    want = _run(_port(tp, tcfg), prompts, budgets)
    rt = trt.Runtime(backend="reference", device="cpu", plan_cache=trt.PlanCache(capacity=1), **GEOM)
    first = _port(tp, tcfg, rt=rt)
    second = _port(dict(tp, lm_head=tp["lm_head"] * 2), tcfg, rt=rt)

    class Graph:
        def replay(self):
            for o, n in zip(first._graph.out, first._chunk()):
                o.copy_(n)

    @contextlib.contextmanager
    def capture(graph, stream=None):  # records the chunk, runs nothing
        saved = [t.clone() for t in _state(first)]
        yield
        for t, s in zip(_state(first), saved):
            t.copy_(s)

    _fake_cuda(monkeypatch, Graph, capture)
    first._graph = engine_mod._DecodeGraph(first.device)
    for p, n in zip(prompts, budgets):
        first.submit(torch.from_numpy(p), max_new=n)
    while first._graph.captures == 0:
        first.step()
    plans = [h for h in first._graph.held if isinstance(h, trt.SparsityPlan)]
    head_plan = next(p for src, _, p in rt.plan_cache._entries.values() if src is tp["lm_head"])
    assert any(p is head_plan for p in plans) and len(plans) == CHUNK * (2 * tcfg.num_layers + 1)
    refs = [weakref.ref(t) for p in plans for t in (p.nnz, p.idx)]
    del plans, head_plan
    second.submit(torch.from_numpy(prompts[0]), max_new=2)
    second.step()
    assert all(src is not tp["lm_head"] for src, _, _ in rt.plan_cache._entries.values())
    T.dense_plan_csr.cache_clear()
    T.dense_plan.cache_clear()
    gc.collect()
    assert all(r() is not None for r in refs)
    assert first.run() == want and first.stats()["decode_graph_captures"] == 1


def test_decode_graph_captures_with_the_collector_off(monkeypatch):
    """A CUDA graph destroyed while another captures invalidates that
    capture, and an old engine's graph may wait in a reference cycle: the
    cyclic collector is off for the whole capture and on again after it,
    also when the capture fails."""
    seen = []

    class Graph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def capture(graph, stream=None):
        seen.append(gc.isenabled())
        yield
        if len(seen) == 2:
            raise RuntimeError("capture invalidated")

    _fake_cuda(monkeypatch, Graph, capture)
    dg = engine_mod._DecodeGraph(torch.device("cpu"))
    dg.warm = True
    dg.run(lambda: 1, torch.zeros(3))
    assert gc.isenabled()
    dg.graph = None
    with pytest.raises(RuntimeError, match="cuda_graph=False"):
        dg.run(lambda: 1, torch.zeros(3))
    assert gc.isenabled() and seen == [False, False]


def test_holding_collects_only_inside_its_block(monkeypatch):
    """``hold`` outside a ``holding`` block keeps nothing; inside, the
    plans and the counter workspace a launch takes are collected."""
    monkeypatch.setattr(T, "_ARRIVALS", {})
    T.hold(object())
    plan = object()
    with T.holding() as held:
        T.hold(plan)
        ws = T._arrivals(torch.device("cpu"), 7, 4)
    T.hold(object())
    assert [id(h) for h in held] == [id(plan), id(ws)]


@pytest.mark.parametrize("device,temperature", [("cpu", 0.0), ("cpu", 0.8)])
def test_cuda_graph_true_where_it_cannot_hold_raises(model, device, temperature):
    """On a CPU runtime, greedy or sampled, ``cuda_graph=True`` is refused
    before anything is allocated; never a quiet eager run.  (A mesh of
    several ranks is refused too: ``test_torch_sharded_serve.py``.)"""
    _, tcfg, _, tp = model
    rt = trt.Runtime(backend="dense", device=device)
    with pytest.raises(ValueError, match="cuda_graph=True"):
        ServeEngine(tp, tcfg, slots=1, max_len=8, rt=rt, temperature=temperature, cuda_graph=True)
    eng = ServeEngine(tp, tcfg, slots=1, max_len=8, rt=trt.Runtime(backend="dense", device="cpu"))
    assert eng._graph is None and eng.stats()["decode_graph_captures"] == 0
