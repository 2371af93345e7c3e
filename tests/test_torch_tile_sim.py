"""The paper's cycle model on the tile kernel's wrapper, and the split
schedule, against the JAX package on the CPU.

``simulate_tile``/``simulate_stream`` with ``device="cpu"`` run the tile
wrapper's plain loop (``kernels.schedule.tile_cycles_ref``): their cycles
equal JAX's ``lax.scan`` over rows 1 to 33, lookahead 1 and 2, 16 and 8
lanes, streams shorter than the window, odd lengths, all-zero and all-one
tiles; ``model_speedup``/``speedup_from_densities`` equal JAX's dicts.  The
default device is the card: with none visible the calls raise and nothing
runs on the host.  ``td_tile_kernel`` runs only on the card; here a spy
library stands in for the build (one launch per ``model_speedup``, each
tile's ``T`` and offset as ``pack_tiles`` packs them, the cycles the spy
writes giving JAX's dict), and the kernel's lockstep arithmetic, its tiles
packed into a warp and their rows staged, is re-enacted in Python against
the plain loop; ``tile_launch_shape`` makes only launch shapes ``td_tile``
takes (its refusals mirrored from the source).  The split
schedule's host version (``schedule_streams_split_ref``) equals the one-walk
plain loop bit for bit over segment lengths and overlaps, also where segments
find no hand-over and the walk falls back to the sequential one.  Cycle
counts and schedules are integers: every comparison is exact.
"""
import contextlib
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pe as jpe
from repro.core import perf_model as jpm
from repro_torch.core import pe as tpe
from repro_torch.core import perf_model as tpm
from repro_torch.kernels import _build, block_mask, schedule

ROWS = [1, 2, 3, 4, 8, 16, 33]


def _tiles(seed, g, r, t, n_lanes):
    """``g`` tiles: all zero, all one, then seeded clustered densities."""
    rng = np.random.default_rng(seed)
    z = rng.random((g, r, t, n_lanes)) < rng.uniform(0.1, 0.9, size=(g, r, 1, 1))
    z[0], z[1] = False, True
    return z


@pytest.mark.parametrize("n_lanes", [16, 8])
@pytest.mark.parametrize("lookahead", [1, 2])
@pytest.mark.parametrize("rows", ROWS)
def test_tile_and_stream_cycles_equal_jax(rows, lookahead, n_lanes):
    z = _tiles(rows * 10 + lookahead, 4, rows, 37, n_lanes)
    got = tpe.simulate_tile(z, n_lanes=n_lanes, lookahead=lookahead, device="cpu")
    assert got.cycles.dtype == np.int32 and int(got.dense) == 37
    for g in range(z.shape[0]):
        want = jpe.simulate_tile(jnp.asarray(z[g]), n_lanes=n_lanes, lookahead=lookahead).cycles
        assert int(got.cycles[g]) == int(want)
    s = tpe.simulate_stream(z[:, 0], n_lanes=n_lanes, lookahead=lookahead, device="cpu").cycles
    for g in range(z.shape[0]):
        assert int(s[g]) == int(jpe.simulate_stream(jnp.asarray(z[g, 0]), n_lanes=n_lanes,
                                                    lookahead=lookahead).cycles)


@pytest.mark.parametrize("lookahead", [1, 2])
@pytest.mark.parametrize("t", [1, 2, 3])
def test_streams_shorter_than_the_window_equal_jax(t, lookahead):
    z = _tiles(t, 3, 4, t, 16)
    got = tpe.simulate_tile(z, lookahead=lookahead, device="cpu").cycles
    for g in range(3):
        assert int(got[g]) == int(jpe.simulate_tile(jnp.asarray(z[g]), lookahead=lookahead).cycles)


def test_a_torch_tensor_runs_where_it_lives():
    z = _tiles(3, 5, 4, 21, 16)
    got = tpe.simulate_tile(torch.from_numpy(z)).cycles
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tpe.simulate_tile(z, device="cpu").cycles)


def test_model_speedup_and_densities_equal_jax():
    kw = dict(tile=tpm.TileConfig(rows=2, cols=4, n_lanes=8, lookahead=1), clustering=0.7, sample_groups=3,
              max_t=48, seed=5)
    jkw = dict(kw, tile=jpm.TileConfig(rows=2, cols=4, n_lanes=8, lookahead=1))
    shapes = [(64, 3, 32, 4), (96, 1, 48, 2), (40, 3, 16, 1)]
    tl = [tpm.ConvLayer(f"l{i}", c, k, k, o, x, x) for i, (c, k, o, x) in enumerate(shapes)]
    jl = [jpm.ConvLayer(f"l{i}", c, k, k, o, x, x) for i, (c, k, o, x) in enumerate(shapes)]
    per_layer = [{jpm.FWD: 0.2 * i, jpm.BWD_INPUT: 0.9 - 0.2 * i, jpm.BWD_WEIGHT: 0.5} for i in range(3)]
    assert tpm.model_speedup(tl, per_layer, device="cpu", **kw) == jpm.model_speedup(jl, per_layer, **jkw)
    a, g = [0.3, 0.5, 0.9], [0.6, 0.1, 1.0]
    assert (tpm.speedup_from_densities(a, g, tl, device="cpu", **kw)
            == jpm.speedup_from_densities(a, g, jl, **jkw))
    got, want = tpm.simulate_conv(tl[0], sparsity=0.4, device="cpu", **kw), jpm.simulate_conv(jl[0], sparsity=0.4,
                                                                                                **jkw)
    assert (got.td_cycles, got.dense_cycles) == (want.td_cycles, want.dense_cycles)


def test_the_default_device_is_the_card(monkeypatch):
    """With no card visible every entry point raises; none runs its plain
    loop instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def host_loop(*a, **k):
        raise AssertionError("the cycle model fell back to the host")

    monkeypatch.setattr(schedule, "tile_cycles_ref", host_loop)
    z = _tiles(0, 2, 4, 9, 16)
    layer = tpm.ConvLayer("l", 32, 1, 1, 16, 1, 1)
    calls = [lambda: tpe.simulate_tile(z), lambda: tpe.simulate_stream(z[0, 0]),
             lambda: tpm.simulate_conv(layer, sparsity=0.5),
             lambda: tpm.model_speedup([layer], {tpm.FWD: 0.5, tpm.BWD_INPUT: 0.5, tpm.BWD_WEIGHT: 0.5}),
             lambda: tpm.speedup_from_densities([0.5], [0.5], [layer]),
             lambda: tpm.simulate_conv(layer, sparsity=0.5, device="cuda")]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card is visible"):
            call()


# ---------------------------------------------------------------------------
# the tile kernel's wrapper, with a spy in place of the built library


class _SpyLibrary:
    """Records each ``td_tile`` call's arguments and the tiles it would
    read, and writes the plain loop's cycles where the kernel would."""

    def __init__(self):
        self.calls, self.rc, self.sms = [], 0, 132

    def td_tile(self, args_ref, stream):
        a = args_ref._obj
        call = {f: getattr(a, f) for f, _ in _build.TileArgs._fields_}
        call.update(opt_step=list(a.opt_step), opt_rot=list(a.opt_rot), level_mask=list(a.level_mask))
        g, r, n = a.G, a.R, a.N
        off = np.frombuffer(ctypes.string_at(a.offset, 8 * g), np.int64)
        t = np.frombuffer(ctypes.string_at(a.t, 4 * g), np.int32)
        call.update(offsets=off.tolist(), t=t.tolist())
        cycles = np.zeros(g, np.int32)
        for i in range(g):
            size = r * int(t[i]) * n
            tile = np.frombuffer(ctypes.string_at(a.z + int(off[i]), size), np.uint8)
            cycles[i] = schedule.tile_cycles_ref(tile.reshape(1, r, int(t[i]), n) != 0, n, a.depth - 1)[0]
        ctypes.memmove(a.cycles, cycles.ctypes.data, 4 * g)
        self.calls.append(call)
        return self.rc


@pytest.fixture
def spy(monkeypatch):
    """The spy library behind the wrapper; the card stands in as the CPU
    (the "card" tensors are CPU tensors the dispatch takes for card ones)."""
    lib = _SpyLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(block_mask, "_card_stream", lambda dev: (0, contextlib.nullcontext()))
    monkeypatch.setattr(block_mask, "on_card", lambda t: True)
    monkeypatch.setattr(tpe, "card_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(block_mask, "sm_count", lambda dev: lib.sms)
    schedule.reset_launch_counts()
    return lib


def test_model_speedup_on_the_card_is_one_tile_launch(spy):
    shapes = [(64, 3, 32, 4), (130, 1, 48, 2)]  # t 36 and 9 at 16 lanes
    tl = [tpm.ConvLayer(f"l{i}", c, k, k, o, x, x) for i, (c, k, o, x) in enumerate(shapes)]
    jl = [jpm.ConvLayer(f"l{i}", c, k, k, o, x, x) for i, (c, k, o, x) in enumerate(shapes)]
    spars = {jpm.FWD: 0.6, jpm.BWD_INPUT: 0.3, jpm.BWD_WEIGHT: 0.7}
    got = tpm.model_speedup(tl, spars, max_t=64)
    assert len(spy.calls) == 1 and schedule.LAUNCHES["td_tile_kernel"] == 1
    call = spy.calls[0]
    steps, rot, masks = schedule.schedule_tables(16, 2)
    assert (call["G"], call["R"], call["N"], call["depth"]) == (2 * 3 * 2, 4, 16, 3)
    # 12 tiles on 132 SMs: a tile a warp, the longest tile's 36 rows staged
    assert (call["pack"], call["stage_words"]) == (1, 4 * 37)
    assert call["opt_step"][:len(steps)] == steps and call["opt_rot"][:len(steps)] == rot
    assert call["level_mask"][:len(masks)] == masks
    # three convolutions a layer, two sampled groups each, in the draw's order
    ts = [36] * 6 + [9] * 6
    assert call["t"] == ts
    sizes = [-(-4 * t * 16 // 16) * 16 for t in ts]
    assert call["offsets"] == np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    assert got == jpm.model_speedup(jl, spars, max_t=64)
    # the train step's estimator: one more launch, its dict JAX's
    a, g = [0.3, 0.8], [0.5, 0.2]
    assert tpm.speedup_from_densities(a, g, tl, max_t=32) == jpm.speedup_from_densities(a, g, jl, max_t=32)
    assert len(spy.calls) == 2 and schedule.LAUNCHES["td_tile_kernel"] == 2
    # the defaults' 256-row tiles, staged; on a card of 2 SMs (8 warps) 12 tiles go 2 a warp
    tpm.model_speedup([tpm.ConvLayer("ffn", 4096, 1, 1, 16, 1, 1)], spars, sample_groups=1)
    assert (spy.calls[-1]["pack"], spy.calls[-1]["stage_words"]) == (1, 4 * 257)
    spy.sms = 2
    assert tpm.model_speedup(tl, spars, max_t=64) == got
    assert (spy.calls[-1]["pack"], spy.calls[-1]["stage_words"]) == (2, 4 * 37)
    src = (Path(_build.CSRC) / "schedule.cu").read_text()
    assert all(_tile_launch_ok(c, src) for c in spy.calls)


def test_a_failed_tile_launch_raises(spy):
    spy.rc = 719  # cudaErrorLaunchFailure
    with pytest.raises(RuntimeError, match="cudaError 719"):
        tpe.simulate_tile(_tiles(1, 2, 4, 9, 16))
    assert schedule.LAUNCHES["td_tile_kernel"] == 0


def test_what_the_tile_kernel_refuses_raises(spy):
    for kw, shape in ((dict(lookahead=3), (1, 4, 8, 16)), (dict(n_lanes=33), (1, 4, 8, 33)),
                      (dict(), (1, 1025, 8, 16))):
        with pytest.raises(ValueError):
            tpe.simulate_tile(np.zeros(shape, bool), **kw)
    assert spy.calls == []


def test_a_cpu_tensor_never_reaches_the_tile_library(monkeypatch):
    lib = _SpyLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    z = _tiles(2, 3, 4, 11, 16)
    tpe.simulate_tile(z, device="cpu")
    tpe.simulate_tile(torch.from_numpy(z))
    tpm.model_speedup([tpm.ConvLayer("l", 32, 1, 1, 16, 1, 1)],
                      {tpm.FWD: 0.5, tpm.BWD_INPUT: 0.5, tpm.BWD_WEIGHT: 0.5}, device="cpu")
    assert lib.calls == []


def test_pack_tiles_layout():
    parts = [torch.from_numpy(_tiles(4, 3, 2, 5, 3)), torch.from_numpy(_tiles(5, 2, 2, 1, 3))]
    packed = schedule.pack_tiles(parts)
    z, t, off = schedule.tile_views(packed, 5)
    assert t.tolist() == [5] * 3 + [1] * 2
    assert off.tolist() == [0, 32, 64, 96, 112]  # 30- and 6-byte tiles at multiples of 16
    assert (packed.numel() - z.numel()) % 16 == 0
    for i, (p, g) in enumerate([(0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]):
        size = parts[p][g].numel()
        assert torch.equal(z[off[i]:off[i] + size], parts[p][g].reshape(-1).to(torch.uint8))


def test_tile_arguments_match_the_cuda_struct():
    """``TileArgs`` lists the C struct's fields in its order, with the
    tables' lengths."""
    src = (Path(_build.CSRC) / "schedule.cu").read_text()
    body = src[src.index("struct TdTileArgs {"):].split("};")[0].split("{", 1)[1]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = decl.split(",")
        names += [first.split()[-1].lstrip("*")] + [r.strip().lstrip("*") for r in rest]
    fields = [f if not hasattr(t, "_length_") else f"{f}[{t._length_}]" for f, t in _build.TileArgs._fields_]
    assert names == fields


@pytest.mark.parametrize("lookahead", [1, 2])
def test_the_compiled_in_tables_are_the_schedulers(lookahead):
    """``csrc/schedule.cu`` compiles in the 16-lane tables; they must be
    :func:`schedule_tables`' (the host functions take them only when the
    launch's tables equal them, so a stale copy would go unused, not wrong)."""
    src = (Path(_build.CSRC) / "schedule.cu").read_text()

    def macro(name):
        body = re.search(rf"#define {name} ([^\n]*)", src).group(1)
        return [int(x.strip().rstrip("u"), 0) for x in body.split(",")]

    steps, rot, masks = schedule.schedule_tables(16, lookahead)
    d = lookahead + 1
    assert macro(f"TD_STEP_16X{d}") == steps and macro(f"TD_ROT_16X{d}") == rot
    assert macro("TD_LEVELS_16") == masks


# the tile kernel's lockstep arithmetic (csrc/schedule.cu, td_tile_kernel),
# re-enacted on Python ints


def _tile_kernel_model(tiles, n: int, lookahead: int, pack: int = 1, stage_words: int | None = None) -> list:
    """``td_tile_kernel``'s launch on a ragged batch ``tiles`` of ``[R, T_g,
    n]`` tiles: each CTA's warp stages its ``pack`` tiles' rows into shared
    words (a slot of ``stage_words`` a tile, default the longest tile's;
    a tile that does not fit reads its rows from the bytes), then lane ``kk
    R + r`` walks tile ``kk``'s PE row ``r``, the tile's advance the minimum
    over its lanes.  Returns each tile's cycles."""
    steps, rot, masks = schedule.schedule_tables(n, lookahead)
    depth, r = lookahead + 1, tiles[0].shape[0]
    if stage_words is None:
        stage_words = r * (max(x.shape[1] for x in tiles) | 1)
    full = (1 << n) - 1
    assert 1 <= pack <= 32 // r

    def rot_down(x, k):
        return ((x >> k) | (x << (n - k))) & full if k else x

    def rot_up(x, k):
        return rot_down(x, (n - k) % n)

    def word(tile, row, j):  # tb.row: PE row j's row `row` as an n-bit word
        return sum(int(b) << i for i, b in enumerate(tile[j, row]))

    out = [None] * len(tiles)
    for g0 in range(0, len(tiles), pack):  # a CTA
        words = [None] * (pack * stage_words)
        for s in range(min(pack, len(tiles) - g0)):
            tile = tiles[g0 + s]
            t = tile.shape[1]
            ts = t | 1
            if r * ts > stage_words:
                continue
            for i in range(r * t):  # every lane's share; the order does not matter
                j, row = divmod(i, t)
                words[s * stage_words + j * ts + row] = word(tile, row, j)
        for kk in range(min(pack, len(tiles) - g0)):
            tile = tiles[g0 + kk]
            t = tile.shape[1]
            ts = t | 1
            staged = r * ts <= stage_words

            def at(j, row):
                if row >= t:
                    return 0
                return words[kk * stage_words + j * ts + row] if staged else word(tile, row, j)

            w = [[at(j, 0), at(j, 1), at(j, 2) if depth > 2 else 0] for j in range(r)]
            p = c = 0
            while p < t:
                advs = []
                for j in range(r):
                    win = w[j]
                    for m in masks:
                        avail, gone = m, [0, 0, 0]
                        for st, rt in zip(steps, rot):
                            take = rot_down(win[st], rt) & avail
                            avail &= ~take
                            gone[st] |= rot_up(take, rt)
                        win = [win[k] & ~gone[k] for k in range(3)]
                    w[j] = win
                    advs.append(1 if win[0] or win[1] else 3 if depth > 2 and not win[2] else 2)
                a = min(advs)  # __reduce_min_sync over the tile's lanes
                for j in range(r):
                    r0, r1, r2 = (at(j, p + depth + i) for i in range(3))
                    win = w[j]
                    if depth > 2:
                        w[j] = [win[1], win[2], r0] if a == 1 else [win[2], r0, r1] if a == 2 else [r0, r1, r2]
                    else:
                        w[j] = [win[1], r0, 0] if a == 1 else [r0, r1, 0]
                p, c = p + a, c + 1
            out[g0 + kk] = c
    return out


@pytest.mark.parametrize("lookahead", [1, 2])
@pytest.mark.parametrize("n_lanes,rows", [(16, 4), (8, 3), (5, 2), (16, 1)])
def test_the_tile_kernels_arithmetic_equals_the_plain_loop(n_lanes, rows, lookahead):
    z = _tiles(n_lanes + rows + lookahead, 6, rows, 23, n_lanes)
    want = schedule.tile_cycles_ref(z, n_lanes, lookahead)
    assert _tile_kernel_model(list(z), n_lanes, lookahead) == want.tolist()


@pytest.mark.parametrize("lookahead", [1, 2])
@pytest.mark.parametrize("rows,pack,stage", [(4, 8, None), (4, 3, None), (3, 10, None), (8, 4, 8 * 9),
                                             (16, 2, 0), (32, 1, None)])
def test_the_tile_kernels_packing_equals_the_plain_loop(rows, pack, stage, lookahead):
    """Ragged tiles (all-zero, all-one, 1 to 30 rows) packed into warps,
    the last CTA not full, and tiles whose rows are not staged (a slot too
    small for some, ``0`` for all): each tile's cycles are the plain loop's."""
    rng = np.random.default_rng(rows * 10 + pack + lookahead)
    ts = [9, 30, 1, 2, 17, 8, 25, 3, 12, 30, 5][:2 * pack + 1]
    tiles = [np.zeros((rows, ts[0], 16), bool), np.ones((rows, ts[1], 16), bool)]
    tiles += [rng.random((rows, t, 16)) < rng.uniform(0.1, 0.9) for t in ts[2:]]
    want = [schedule.tile_cycles_ref(x[None], 16, lookahead)[0] for x in tiles]
    assert _tile_kernel_model(tiles, 16, lookahead, pack, stage) == want


def _tile_launch_ok(args: dict, src: str) -> bool:
    """``tile_shape_ok`` of ``csrc/schedule.cu`` (its constant read from
    the source): the packing and staging ``td_tile`` takes."""
    smem = eval(re.search(r"constexpr int kTileSmem = ([^;]+);", src).group(1))  # an integer product
    a = args
    if a["R"] > 32:
        return a["pack"] == 1 and a["stage_words"] == 0
    return 1 <= a["pack"] <= 32 // a["R"] and a["stage_words"] >= 0 and 4 * a["pack"] * a["stage_words"] <= smem - 64


@pytest.mark.parametrize("sms", [132, 1])
def test_tile_launch_shape(sms):
    """A tile a warp until the launch would put more than
    ``TILE_WARPS_PER_SM`` warps on a SM, then the fewest tiles a warp that
    keep it there (at most 32 / R); rows staged where a CTA's slots fit;
    every shape one ``td_tile`` takes, and it refuses the shapes the host
    never makes."""
    src = (Path(_build.CSRC) / "schedule.cu").read_text()
    cap = schedule.TILE_WARPS_PER_SM * sms
    assert schedule.tile_launch_shape(180, 256, 4, sms) == ((1 if sms == 132 else 8), 4 * 257)
    assert schedule.tile_launch_shape(cap, 688, 4, sms)[0] == 1
    assert schedule.tile_launch_shape(cap + 1, 688, 4, sms)[0] == 2
    assert schedule.tile_launch_shape(10**6, 688, 4, sms) == (8, 4 * 689)
    assert schedule.tile_launch_shape(1, None, 4, sms) == (1, 0)
    assert schedule.tile_launch_shape(5, 9, 40, sms) == (1, 0)
    assert schedule.tile_launch_shape(10**6, 5000, 32, sms) == (1, 0)  # 32 x 5001 words do not fit
    for g in (1, 2, 100, 528, 529, 1000, 5000, 10**5):
        for t in (None, 1, 2, 64, 256, 688, 1024, 2048, 10**5):
            for rows in (1, 2, 3, 4, 8, 16, 32, 33, 100):
                pack, words = schedule.tile_launch_shape(g, t, rows, sms)
                assert _tile_launch_ok(dict(R=rows, pack=pack, stage_words=words), src)
                if rows <= 32:
                    assert pack == 32 // rows or -(-g // pack) <= cap  # within the cap where it can be
                    assert pack == 1 or -(-g // (pack - 1)) > cap  # and no more tiles a warp than that needs
                    fits = t is not None and 4 * pack * rows * (t | 1) <= 227 * 1024 - 64
                    assert words == (rows * (t | 1) if fits else 0)
    good = dict(R=4, pack=4, stage_words=4 * 257)
    assert _tile_launch_ok(good, src)
    for bad in (dict(pack=0), dict(pack=9), dict(stage_words=-1), dict(stage_words=15000), dict(R=33)):
        assert not _tile_launch_ok({**good, **bad}, src), bad


# ---------------------------------------------------------------------------
# the split schedule


@pytest.mark.parametrize("lookahead", [1, 2])
@pytest.mark.parametrize("seg_rows,overlap", [(2, 1), (16, 8), (40, 3), (64, 32), (97, 48)])
def test_the_split_schedule_equals_the_plain_loop(seg_rows, overlap, lookahead):
    rng = np.random.default_rng(seg_rows + lookahead)
    z = torch.from_numpy(rng.random((3, 250, 16)) < np.array([0.5, 0.9, 0.15])[:, None, None])
    want = schedule.schedule_streams_ref(z, lookahead=lookahead)
    got = schedule.schedule_streams_split_ref(z, seg_rows, overlap, lookahead=lookahead)
    for name, g, w in zip(("sel", "advance", "n_cycles"), got, want):
        assert torch.equal(g, w), name


def test_the_split_falls_back_where_no_head_matches():
    """An all-zero stream drains three rows a cycle: the true walk visits
    rows 0, 3, 6, 9, a segment of 4 rows starting fresh at 4 or 8 visits
    only its first head row, and neither is on the walk.  No segment takes
    over: segment 0 walks the whole stream.  Then zero rows ahead of random
    ones: the hand-overs skip the segments whose heads the walk misses."""
    z = torch.zeros((1, 12, 16), dtype=torch.bool)
    chains = []
    got = schedule.schedule_streams_split_ref(z, 4, 2, chains=chains)
    assert chains == [[(0, 0, 4, 0)]]
    for g, w in zip(got, schedule.schedule_streams_ref(z)):
        assert torch.equal(g, w)
    rng = np.random.default_rng(9)
    z = torch.from_numpy(np.concatenate([np.zeros((1, 40, 16), bool), rng.random((1, 200, 16)) < 0.5], axis=1))
    chains = []
    got = schedule.schedule_streams_split_ref(z, 4, 2, chains=chains)
    segs = [link[0] for link in chains[0]]
    assert segs[0] == 0 and any(b - a > 1 for a, b in zip(segs, segs[1:]))  # a segment skipped
    for g, w in zip(got, schedule.schedule_streams_ref(z)):
        assert torch.equal(g, w)


def test_split_geometry():
    """One long stream splits (the codec's deepseek-7b ``w_down``); many
    streams, or short ones, keep one thread a stream."""
    assert schedule.split_geometry(1, 2818048) == (2048, 1376, 512)
    assert schedule.split_geometry(768, 4096) is None
    assert schedule.split_geometry(1, 4096) is None
    for s, t in ((1, 8192), (2, 10**6), (512, 9000), (1, 10**8)):
        k, seg, ov = schedule.split_geometry(s, t)
        assert 8 <= k <= 2048 and s * k <= 4096 and (k - 1) * seg < t <= k * seg and 1 <= ov <= seg // 2


def test_a_long_stream_on_the_card_is_one_split_call(monkeypatch):
    calls = []

    class Lib:
        def td_schedule(self, args_ref, stream):
            a = args_ref._obj
            calls.append({f: getattr(a, f) for f in ("S", "T", "n_segs", "seg_rows", "overlap", "work")})
            return 0

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(block_mask, "_card_stream", lambda dev: (0, contextlib.nullcontext()))
    monkeypatch.setattr(block_mask, "on_card", lambda t: True)
    schedule.reset_launch_counts()
    schedule.schedule_streams(torch.zeros((1, 8192, 16), dtype=torch.bool))
    schedule.schedule_streams(torch.zeros((3, 64, 16), dtype=torch.bool))
    assert [(c["S"], c["T"], c["n_segs"], c["seg_rows"], c["overlap"]) for c in calls] == [
        (1, 8192, 8, 1024, 512), (3, 64, 0, 0, 0)]
    assert calls[0]["work"] and not calls[1]["work"]
    assert schedule.LAUNCHES["td_schedule_kernel"] == 2


# the compiled-in 16-lane path of csrc/schedule.cu (Tab16, sched_level_fixed,
# the bit planes td_expand_kernel turns into bytes), re-enacted on Python ints


def _fixed_path_model(z: np.ndarray, lookahead: int):
    steps, rot, masks = schedule.schedule_tables(16, lookahead)
    depth, t, n_opt = lookahead + 1, z.shape[0], len(steps)
    k = 0x01020408

    def word(row):  # word16 on 0/1 bytes, replicated
        v = [int.from_bytes(bytes(int(b) for b in row[4 * i:4 * i + 4]), "little") for i in range(4)]
        w = sum((((x * k) & 0xFFFFFFFF) >> 24) << (4 * i) for i, x in enumerate(v))
        return (w * 0x10001) & 0xFFFFFFFF

    def rot_down(x, r):
        return ((x >> r) | (x << (32 - r))) & 0xFFFFFFFF if r else x

    def rot_up(x, r):
        return ((x << r) | (x >> (32 - r))) & 0xFFFFFFFF if r else x

    rows = [word(z[r]) for r in range(t)] + [0] * 6
    w = [rows[0], rows[1], rows[2] if depth > 2 else 0]
    p, nxt, sel, adv = 0, depth, [], []
    while p < t:
        q, picked = [0, 0, 0, 0], 0
        for m in masks:
            lvl = (m * 0x10001) & 0xFFFFFFFF
            avail, take = lvl, []
            for o in range(n_opt):
                src = rot_down(w[steps[o]], rot[o])
                take.append(src & avail)
                avail &= ~src
            picked |= lvl & ~avail
            gone = [0, 0, 0]
            for o in range(1, n_opt):
                for b in range(3):
                    if o >> b & 1:
                        q[b] |= take[o]
                gone[steps[o]] |= rot_up(take[o], rot[o])
            w = [w[0], w[1] & ~gone[1], w[2] & ~gone[2]]  # row 0 is never cleared
        for b in range(4):
            if n_opt >> b & 1:
                q[b] |= 0xFFFFFFFF & ~picked
        a = 1 if w[1] else 3 if depth > 2 and not w[2] else 2
        row = [(q[0] & 0xFFFF) | (q[1] << 16) & 0xFFFFFFFF, (q[2] & 0xFFFF) | (q[3] << 16) & 0xFFFFFFFF, a, 0]
        planes = [row[0] & 0xFFFF, row[0] >> 16, row[1] & 0xFFFF, row[1] >> 16]  # what td_expand_kernel reads
        sel.append([sum((planes[b] >> i & 1) << b for b in range(4)) for i in range(16)])
        adv.append(row[2])
        r0, r1, r2 = rows[nxt:nxt + 3]
        n0 = w[1] if a == 1 else w[2] if depth > 2 and a == 2 else r0
        n1 = (w[2] if depth > 2 else r0) if a == 1 else r0 if depth > 2 and a == 2 else r1
        n2 = r0 if a == 1 else r1 if a == 2 else r2
        w = [n0, n1, n2 if depth > 2 else 0]
        p, nxt = p + a, nxt + a
    return np.array(sel, np.int8).reshape(-1, 16), np.array(adv, np.int8)


@pytest.mark.parametrize("lookahead", [1, 2])
def test_the_compiled_in_paths_arithmetic_equals_the_plain_loop(lookahead):
    rng = np.random.default_rng(lookahead)
    for density in (0.0, 0.2, 0.5, 0.8, 1.0):
        for t in (1, 2, 3, 57):
            z = (rng.random((t, 16)) < density).astype(np.uint8)
            sel, adv = _fixed_path_model(z, lookahead)
            rs, ra, rc = schedule.schedule_streams_ref(torch.from_numpy(z[None]), 16, lookahead)
            assert len(adv) == int(rc[0])
            np.testing.assert_array_equal(sel, rs[0, :len(adv)].numpy())
            np.testing.assert_array_equal(adv, ra[0, :len(adv)].numpy())


def test_the_row_ring_never_reads_a_row_before_it_lands():
    """The cp.async row ring of ``csrc/schedule.cu`` (its constants read
    from the source): the first ``kAhead + 3`` rows are copied and waited
    for; each cycle waits for all but the last ``kInFlight`` copy groups,
    reads its rows, then copies the three rows ``kAhead`` ahead.  Over
    random advances, every row read has landed in its slot, and no copy
    still in flight targets the slot of a row still to be read (copies are
    modelled as landing at the latest moment the wait allows)."""
    src = (Path(_build.CSRC) / "schedule.cu").read_text()
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("kRing", "kAhead", "kInFlight")}
    ring_n, ahead, in_flight = const["kRing"], const["kAhead"], const["kInFlight"]
    rng = np.random.default_rng(0)
    for _ in range(300):
        t, depth, start = int(rng.integers(1, 300)), int(rng.choice([2, 3])), int(rng.integers(0, 40))
        ring, groups = [None] * ring_n, []

        def land(keep):
            while len(groups) > keep:
                for r in groups.pop(0):
                    ring[r % ring_n] = r

        groups.append([r for r in range(start, start + ahead + 3) if r < t])
        land(0)
        nxt = start
        while nxt - depth < t:
            land(in_flight)
            live = [x for x in range(nxt, nxt + depth) if x < t]
            for x in live:
                assert ring[x % ring_n] == x
            assert not any(y != x and (y - x) % ring_n == 0 for g in groups for y in g for x in live)
            groups.append([r for r in range(nxt + ahead, nxt + ahead + 3) if r < t])
            nxt += int(rng.integers(1, depth + 1))
