"""repro_torch.serve against repro.serve on the CPU.

Five requests with mixed prompt lengths run through two slots (so slots
backfill) on the JAX suite's ReLU language model with fp32 parameters under
the ``reference`` backend; the greedy tokens equal the JAX ServeEngine's
token for token, and ``generate()`` on two of the prompts gives the same
tokens; sampled ``generate()`` gives JAX's sampled tokens for the same
seed.  The LM-head plan is built once (one miss) and every later prefill
and decode step replays it (hits).  These counts are not compared with JAX's: the JAX
decode chunk is jitted, so its decode-time plans are ``traced``, not hits.

Reduced mamba2-780m and zamba2-2.7b (fp32) run the same prompts and
budgets through two slots: their greedy tokens equal JAX's engine's (with
both packages' SSM conv tails in fp32, the one layout JAX's engine can
carry for an fp32 model), and, on the port's default bf16 tails, each
request's tokens equal a solo run's, so a reused slot keeps nothing of its
last request's state.

Reduced gemma2-2b (fp32, GELU as registered; sliding window 8, so the
local layers mask keys once a request passes 8 tokens) serves the same
prompts and budgets through two slots: the greedy tokens equal JAX's
engine's.  Reduced deepseek-7b-ReLU with the int8 KV cache
(``kv_cache_quant``) serves them too: the greedy tokens equal JAX's
engine's and, through reused slots, each request's solo run, and the
packed cache is int8 with fp32 scales.
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
from repro.serve.engine import generate as jgenerate
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
    assert st["tokens_out"] == sum(BUDGETS) and st["chunks_run"] >= 3
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
    """Sampled ``generate()`` replays JAX's per-request key streams: the
    same seed gives JAX's ``generate`` tokens, and the same tokens again."""
    jcfg, tcfg, jp, tp = model
    prompt = torch.arange(12).reshape(2, 6)
    rt = trt.Runtime(backend="dense", device="cpu")
    a = generate(tp, tcfg, prompt, max_new=5, temperature=1.0, seed=11, rt=rt)
    b = generate(tp, tcfg, prompt, max_new=5, temperature=1.0, seed=11, rt=rt)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size
    want = jgenerate(jp, jcfg, prompt.numpy().astype(np.int32), max_new=5, temperature=1.0, seed=11,
                     rt=jrt.Runtime(backend="dense"))
    assert a.tolist() == np.asarray(want).tolist()


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


@pytest.fixture(scope="module")
def moe_model():
    """Reduced qwen3-moe-235b-a22b with a ReLU gate, fp32: 8 experts top-2, so
    a decode step over 2 slots has expert capacity 1."""
    jcfg = dataclasses.replace(jreduce_config(jget_config("qwen3-moe-235b-a22b")), activation="relu")
    tcfg = dataclasses.replace(reduce_config(get_config("qwen3-moe-235b-a22b")), activation="relu")
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def test_moe_engine_greedy_tokens_match_jax_with_an_inactive_slot(moe_model):
    """Every decode row is routed, an inactive slot's too, and at capacity 1
    it can take an expert's only slot: the port must feed inactive slots
    what JAX's engine feeds them (the pad token at a frozen position) and
    prefill in the same groups, or the greedy tokens diverge."""
    jcfg, tcfg, jp, tp = moe_model
    rng = np.random.default_rng(11)
    plens, budgets = [5, 8, 5, 7], [2, 7, 4, 3]
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32) for n in plens]
    jeng = JServeEngine(jp, jcfg, slots=2, max_len=16, chunk=3,
                        rt=jrt.Runtime(backend="reference", **GEOM))
    teng = ServeEngine(tp, tcfg, slots=2, max_len=16, chunk=3,
                       rt=trt.Runtime(backend="reference", device="cpu", **GEOM))
    starts = []
    decode = teng._decode
    teng._decode = lambda: (starts.append(teng.active.tolist()), decode())[1]
    for p, n in zip(prompts, budgets):
        jeng.submit(p, max_new=n)
        teng.submit(torch.from_numpy(p), max_new=n)
    jout, tout = jeng.run(), teng.run()
    assert tout == jout
    assert [len(tout[r]) for r in range(4)] == budgets
    assert [True, False] in starts or [False, True] in starts  # a chunk with an inactive slot
    assert all(r.ok for r in teng._requests.values())


def test_decode_sites_warm_the_moe_expert_cell():
    from repro_torch.serve.engine import _decode_sites

    dense = reduce_config(get_config("deepseek-7b"))
    moe = reduce_config(get_config("qwen3-moe-235b-a22b"))
    d, v = dense.d_model, dense.vocab_size
    assert _decode_sites(dense, 4) == [("matmul_fused", (4, d), (d, 128)), ("matmul", (4, 128), (128, d)),
                                       ("matmul", (4, d), (d, v))]
    # 4 tokens x top-2 over 8 experts x 1.25: capacity 1
    assert _decode_sites(moe, 4) == [("moe_expert", (1, 32), (32, d)), ("matmul", (4, d), (d, v))]
    mixed = dataclasses.replace(moe, first_dense_layers=1, num_layers=3)
    assert [s[0] for s in _decode_sites(mixed, 16)] == ["matmul_fused", "matmul", "moe_expert", "matmul"]
    assert _decode_sites(mixed, 16)[2] == ("moe_expert", (5, 32), (32, d))


#: the SSM and hybrid engine cases: reduced mamba2-780m (2 Mamba2 layers)
#: and reduced zamba2-2.7b (2 groups of 2 Mamba2 layers, each after the
#: shared attention block), fp32
SSM_ARCHS = ["mamba2-780m", "zamba2-2.7b"]


@pytest.fixture(scope="module", params=SSM_ARCHS)
def ssm_model(request):
    jcfg = jreduce_config(jget_config(request.param))
    tcfg = reduce_config(get_config(request.param))
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _fp32_conv_tails(monkeypatch):
    """Both packages' SSM decode caches with fp32 conv tails.  With fp32
    activations JAX's ``_conv_step`` returns fp32 tails, and its engine's
    decode scan must carry the dtypes it started from, so JAX's engine runs
    an fp32 model only on fp32 tails (on the default bf16 ones it raises a
    carry-type error); the port's in-place writes take either."""
    import functools

    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm

    monkeypatch.setattr(jssm, "init_ssm_cache", functools.partial(jssm.init_ssm_cache, dtype=jnp.float32))
    monkeypatch.setattr(tssm, "init_ssm_cache", functools.partial(tssm.init_ssm_cache, dtype=torch.float32))


def test_ssm_and_hybrid_engine_greedy_tokens_match_jax(ssm_model, monkeypatch):
    """PLENS/BUDGETS through two slots, so slots backfill (a request decodes
    from a state and conv tails another request left, each overwritten by
    the slot write) and a chunk runs with an inactive slot: the greedy tokens
    equal JAX's ``ServeEngine``'s; the LM head, the model's only planned
    product, is planned once and hit after."""
    jcfg, tcfg, jp, tp = ssm_model
    _fp32_conv_tails(monkeypatch)
    prompts = _prompts(jcfg.vocab_size)
    jeng = JServeEngine(jp, jcfg, slots=2, max_len=16, chunk=3,
                        rt=jrt.Runtime(backend="reference", **GEOM))
    teng = ServeEngine(tp, tcfg, slots=2, max_len=16, chunk=3,
                       rt=trt.Runtime(backend="reference", device="cpu", **GEOM))
    leaf = teng.caches[0] if tcfg.family == "ssm" else teng.caches.ssm[0][0]
    assert leaf.conv_x.dtype == torch.float32
    groups, starts = [], []
    admit, decode = teng._admit_group, teng._decode
    teng._admit_group = lambda placements: (groups.append(len(placements)), admit(placements))
    teng._decode = lambda: (starts.append(teng.active.tolist()), decode())[1]
    for p, n in zip(prompts, BUDGETS):
        jeng.submit(p, max_new=n)
        teng.submit(torch.from_numpy(p), max_new=n)
    jout, tout = jeng.run(), teng.run()
    assert tout == jout
    assert [len(tout[r]) for r in range(5)] == BUDGETS
    assert [True, False] in starts or [False, True] in starts  # a chunk with an inactive slot
    st = teng.stats()
    pc = st["plan_cache"]
    assert pc["misses"] == 1 and pc["entries"] == 1
    assert pc["hits"] == len(groups) + st["steps_run"] - 1
    assert all(r.ok for r in teng._requests.values())


def test_ssm_and_hybrid_reused_slot_equals_a_solo_run(ssm_model):
    """On the default bf16 conv tails: every request's greedy tokens through
    two backfilled slots equal its tokens served alone in a fresh one-slot
    engine, so a slot write leaves nothing of the slot's last request (a KV
    row past ``pos`` is masked; an SSM state is not, and must be
    overwritten whole)."""
    _, tcfg, _, tp = ssm_model
    prompts = _prompts(tcfg.vocab_size)
    rt = lambda: trt.Runtime(backend="reference", device="cpu", **GEOM)
    eng = ServeEngine(tp, tcfg, slots=2, max_len=16, chunk=3, rt=rt())
    slots = {}
    admit = eng._admit_group
    eng._admit_group = lambda placements: (slots.update((r.rid, s) for s, r in placements), admit(placements))
    for p, n in zip(prompts, BUDGETS):
        eng.submit(torch.from_numpy(p), max_new=n)
    out = eng.run()
    assert len(set(slots.values())) == 2 and len(slots) == 5  # slots reused
    for rid, (p, n) in enumerate(zip(prompts, BUDGETS)):
        solo = ServeEngine(tp, tcfg, slots=1, max_len=16, chunk=3, rt=rt())
        solo.submit(torch.from_numpy(p), max_new=n)
        assert solo.run()[0] == out[rid], rid


def test_decode_sites_of_ssm_and_hybrid_are_the_lm_head():
    from repro_torch.serve.engine import _decode_sites

    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        assert _decode_sites(cfg, 4) == [("matmul", (4, cfg.d_model), (cfg.d_model, cfg.vocab_size))]


def test_profile_decode_cuts_a_hybrid_only_at_whole_groups():
    from repro_torch.launch import profile_decode
    from repro_torch.runtime.backends import BackendCapabilityError

    with pytest.raises(ValueError, match="multiple of 6"):
        profile_decode.main(["--arch", "zamba2-2.7b", "--layers", "8"])
    if not torch.cuda.is_available():  # 12 layers pass the check and reach the card's
        with pytest.raises(BackendCapabilityError):
            profile_decode.main(["--arch", "zamba2-2.7b", "--layers", "12"])


@pytest.mark.parametrize("arch,kw", [("gemma2-2b", {}), ("deepseek-7b", dict(activation="relu", kv_cache_quant=True))],
                         ids=["gemma2", "deepseek-relu-int8-kv"])
def test_engine_greedy_tokens_match_jax_windowed_and_int8_kv(arch, kw):
    """PLENS/BUDGETS through two slots (backfilled; requests reach position
    13, past reduced gemma2's window of 8): the greedy tokens equal JAX's
    ``ServeEngine``'s on ``reference``, fp32."""
    jcfg = dataclasses.replace(jreduce_config(jget_config(arch)), **kw)
    tcfg = dataclasses.replace(reduce_config(get_config(arch)), **kw)
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    prompts = _prompts(jcfg.vocab_size)
    assert max(len(p) + n for p, n in zip(prompts, BUDGETS)) - 1 > (tcfg.sliding_window or 0)
    jeng = JServeEngine(jp, jcfg, slots=2, max_len=16, chunk=3,
                        rt=jrt.Runtime(backend="reference", **GEOM))
    teng = ServeEngine(tp, tcfg, slots=2, max_len=16, chunk=3,
                       rt=trt.Runtime(backend="reference", device="cpu", **GEOM))
    for p, n in zip(prompts, BUDGETS):
        jeng.submit(p, max_new=n)
        teng.submit(torch.from_numpy(p), max_new=n)
    jout, tout = jeng.run(), teng.run()
    assert tout == jout
    assert [len(tout[r]) for r in range(5)] == BUDGETS
    assert all(r.ok for r in teng._requests.values())
    cache = teng.caches["layers"][0]
    want = (torch.int8, torch.float32) if tcfg.kv_cache_quant else (torch.bfloat16, None)
    assert (cache.k.dtype, None if cache.k_scale is None else cache.k_scale.dtype) == want


def test_int8_kv_reused_slot_equals_a_solo_run():
    """Reduced deepseek-7b-ReLU with the int8 KV cache: each request's
    greedy tokens through two backfilled slots equal its tokens served
    alone, so a slot write replaces the slot's int8 rows and scales."""
    tcfg = dataclasses.replace(reduce_config(get_config("deepseek-7b")), activation="relu", kv_cache_quant=True)
    jcfg = dataclasses.replace(jreduce_config(jget_config("deepseek-7b")), activation="relu", kv_cache_quant=True)
    jp = jinit_params(JM.param_specs(jcfg), jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    prompts = _prompts(tcfg.vocab_size)
    rt = lambda: trt.Runtime(backend="reference", device="cpu", **GEOM)
    eng = ServeEngine(tp, tcfg, slots=2, max_len=16, chunk=3, rt=rt())
    slots = {}
    admit = eng._admit_group
    eng._admit_group = lambda placements: (slots.update((r.rid, s) for s, r in placements), admit(placements))
    for p, n in zip(prompts, BUDGETS):
        eng.submit(torch.from_numpy(p), max_new=n)
    out = eng.run()
    assert len(set(slots.values())) == 2 and len(slots) == 5  # slots reused
    for rid, (p, n) in enumerate(zip(prompts, BUDGETS)):
        solo = ServeEngine(tp, tcfg, slots=1, max_len=16, chunk=3, rt=rt())
        solo.submit(torch.from_numpy(p), max_new=n)
        assert solo.run()[0] == out[rid], rid


@pytest.mark.parametrize("argv", [["--arch", "starcoder2-3b"], ["--arch", "gemma2-2b", "--activation", "relu"]])
def test_profile_decode_takes_starcoder2_and_gemma2(argv):
    """The launcher resolves both archs by name and takes their arguments
    up to the card's check (here, with no card, its refusal)."""
    from repro_torch.launch import profile_decode
    from repro_torch.runtime.backends import BackendCapabilityError

    if torch.cuda.is_available():
        pytest.skip("runs the full-width model on a card: chip_smoke.py and the README's GPU lines drive it")
    with pytest.raises(BackendCapabilityError):
        profile_decode.main(argv)
