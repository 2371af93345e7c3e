"""repro_torch.serve against repro.serve on the CPU.

Five requests with mixed prompt lengths run through two slots (so slots
backfill) on the JAX suite's ReLU language model with fp32 parameters under
the ``reference`` backend; the greedy tokens equal the JAX ServeEngine's
token for token, and ``generate()`` on two of the prompts gives the same
tokens.  The LM-head plan is built once (one miss) and every later prefill
and decode step replays it (hits).  These counts are not compared with JAX's: the JAX
decode chunk is jitted, so its decode-time plans are ``traced``, not hits.
"""
import dataclasses

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
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import runtime as trt
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import QueueFull, Request, Scheduler, ServeEngine, generate

GEOM = dict(bm=8, bk=16, bn=16)
PLENS = [5, 8, 5, 7, 8]
BUDGETS = [4, 6, 3, 5, 4]


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


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PLENS]


def test_engine_and_generate_greedy_tokens_match_jax_and_lm_head_plan_replays(model):
    jcfg, tcfg, jp, tp = model
    prompts = _prompts(jcfg.vocab_size)
    jeng = JServeEngine(jp, jcfg, slots=2, max_len=16, chunk=3,
                        rt=jrt.Runtime(backend="reference", **GEOM))
    teng = ServeEngine(tp, tcfg, slots=2, max_len=16, chunk=3,
                       rt=trt.Runtime(backend="reference", device="cpu", **GEOM))
    groups = []
    admit = teng._admit_group
    teng._admit_group = lambda placements: (groups.append(len(placements)), admit(placements))
    for p, n in zip(prompts, BUDGETS):
        jeng.submit(p, max_new=n)
        teng.submit(torch.from_numpy(p), max_new=n)
    jout, tout = jeng.run(), teng.run()
    assert tout == jout
    assert [len(tout[r]) for r in range(5)] == BUDGETS
    st = teng.stats()
    assert st["tokens_out"] == sum(BUDGETS) and st["decode_chunks"] >= 3
    # the LM head: one plan built at the first prefill, every later prefill
    # group and decode step replays it
    pc = st["plan_cache"]
    assert pc["misses"] == 1
    assert pc["hits"] == len(groups) + st["steps_run"] - 1
    assert all(r.ok for r in teng._requests.values())
    # generate(): the two length-8 prompts as one batch; greedy tokens are
    # the same prefix whatever shares the batch
    gen = generate(tp, tcfg, torch.from_numpy(np.stack([prompts[1], prompts[4]])), max_new=4,
                   rt=trt.Runtime(backend="reference", device="cpu", **GEOM))
    assert gen.dtype == torch.int32 and gen.shape == (2, 4)
    assert gen.tolist() == [jout[1][:4], jout[4][:4]]


def test_temperature_sampling_is_seeded_per_request(model):
    _, tcfg, _, tp = model
    prompt = torch.arange(12).reshape(2, 6)
    rt = trt.Runtime(backend="dense", device="cpu")
    a = generate(tp, tcfg, prompt, max_new=5, temperature=1.0, seed=11, rt=rt)
    b = generate(tp, tcfg, prompt, max_new=5, temperature=1.0, seed=11, rt=rt)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


def test_scheduler_priority_aging_and_bounded_queue():
    s = Scheduler(1, max_pending=2, age_boost=1.0)
    low = Request(rid=0, prompt=None, max_new=1, priority=0, t_submit=0.0)
    high = Request(rid=1, prompt=None, max_new=1, priority=5, t_submit=9.0)
    s.submit(low)
    s.submit(high)
    with pytest.raises(QueueFull):
        s.submit(Request(rid=2, prompt=None, max_new=1))
    assert s.admit(now=9.0) == [(0, low)]  # aged: 0 + 9 > 5 + 0
    s.evict(0)
    assert s.admit(now=9.0) == [(0, high)]
    assert not s.pending and s.has_work


def test_submit_validates_lengths(model):
    _, tcfg, _, tp = model
    eng = ServeEngine(tp, tcfg, slots=1, max_len=8, rt=trt.Runtime(backend="dense", device="cpu"))
    with pytest.raises(ValueError):
        eng.submit(torch.zeros(6, dtype=torch.int64), max_new=3)
    with pytest.raises(ValueError):
        eng.submit(torch.zeros((2, 2), dtype=torch.int64), max_new=1)


def _pinned_v1_dbs(cfg):
    """The same DB in both packages: the FFN cells (gate and ``w_down``, every
    row bucket a prefill or decode reaches) pin ``GEOM`` on the v1 grid."""
    from repro import tune as jtune
    from repro_torch import tune as ttune

    tdb, jdb = ttune.TuningDB(platform="cpu"), jtune.TuningDB(platform="cpu")
    d, d_ff = cfg.d_model, cfg.d_ff
    for rows in (1 << i for i in range(6)):
        for op, k, n in (("matmul_fused", d, d_ff), ("matmul", d_ff, d)):
            tdb.store(tdb.key(op=op, m=rows, k=k, n=n, dtype=torch.float32),
                      ttune.TunedPolicy(compact_grid="v1", **GEOM))
            jdb.store(jdb.key(op=op, m=rows, k=k, n=n, dtype=jnp.float32),
                      jtune.TunedPolicy(compact_grid="v1", **GEOM))
    return tdb, jdb


def test_geometry_auto_engine_pinned_to_v1_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    prompts = _prompts(jcfg.vocab_size)
    tdb, jdb = _pinned_v1_dbs(tcfg)
    jeng = JServeEngine(jp, jcfg, slots=2, max_len=16, chunk=3,
                        rt=jrt.Runtime(backend="reference", geometry="auto", tuning_db=jdb, **GEOM))
    trt_auto = trt.Runtime(backend="reference", device="cpu", geometry="auto", tuning_db=tdb, **GEOM)
    teng = ServeEngine(tp, tcfg, slots=2, max_len=16, chunk=3, rt=trt_auto)
    for p, n in zip(prompts, BUDGETS):
        jeng.submit(p, max_new=n)
        teng.submit(torch.from_numpy(p), max_new=n)
    assert teng.run() == jeng.run()
    # the decode call sites resolved to the pinned v1 policy (memo warmed at
    # construction), the LM head to the explicit ragged default
    d, d_ff, v = tcfg.d_model, tcfg.d_ff, tcfg.vocab_size
    gate = trt_auto._resolved("matmul_fused", (2, d), (d, d_ff), torch.float32)
    head = trt_auto._resolved("matmul", (2, d), (d, v), torch.float32)
    assert gate.compact_grid == "v1" and head.compact_grid == "ragged"
    assert tdb.stats()["hits"] > 0
