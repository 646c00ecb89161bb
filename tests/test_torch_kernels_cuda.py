"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: every test skips without a CUDA device (decided inside the
``cuda`` fixture, never at import).  Run on a GPU machine with
``python -m pytest tests/test_torch_kernels_cuda.py -q``.  Inputs are made
from a seed with numpy and go through the kernel (CUDA tensors) and the plain
version (the same tensors on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu_torch import (_build, compress, dets, probe_reshape, profiling,  # noqa: E402
                             rng as trng, rung, synth)
from fries_tpu_torch.drivers import (fciqmc, frifull, frifull_hh, frimulti, frisys,  # noqa: E402
                                     frisys_hh, observables, power, subspace)
from fries_tpu_torch.ops import heat_bath as hb, hubbard, molecule as mol  # noqa: E402
from fries_tpu_torch.ops import near_uniform as nu  # noqa: E402
from fries_tpu_torch.runtime import arena as ar  # noqa: E402
from fries_tpu_torch.runtime import attempt, emit, merge, merge_multi  # noqa: E402
from fries_tpu_torch.runtime import plan as plan_mod  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# kernel A: sorted-merge accumulate
# ---------------------------------------------------------------------------

def merge_case(rng, n_words, capacity, n_occ, n_spawn, n_universe,
               ini_frac=0.6, invalid_frac=0.1, n_vecs=1):
    """Random arena + spawn stream (the cases of tests/test_pallas_merge.py)."""
    uni = rng.integers(0, 2**20, size=(n_universe, n_words)).astype(np.int64)
    uni[:, -1] &= 0x0FFFFFFF
    uni = np.unique(uni, axis=0)
    occ_idx = rng.choice(uni.shape[0], size=min(n_occ, uni.shape[0]), replace=False)
    okeys = uni[np.sort(occ_idx)]
    okeys = okeys[np.argsort(dets.pack_key(torch.as_tensor(okeys)).numpy(), kind="stable")]
    ovals = rng.standard_normal(okeys.shape[0])
    ovals[rng.random(okeys.shape[0]) < 0.2] = 0.0
    a = ar.make(capacity, n_words, n_vecs)
    keys = a.keys.clone()
    keys[: len(okeys)] = torch.as_tensor(okeys)
    vals = a.vals.clone()
    vals[0, : len(okeys)] = torch.as_tensor(ovals)
    a = ar.Arena(keys=keys, vals=vals, n_used=torch.tensor([len(okeys)]))
    skeys = uni[rng.integers(0, uni.shape[0], n_spawn)].copy()
    skeys[rng.random(n_spawn) < invalid_frac] = dets.WORD_MASK
    svals = rng.standard_normal(n_spawn) * 0.3
    sini = rng.random(n_spawn) < ini_frac
    return a, torch.as_tensor(skeys), torch.as_tensor(svals), torch.as_tensor(sini)


def to_dev(a, device):
    return ar.Arena(keys=a.keys.to(device), vals=a.vals.to(device),
                    n_used=a.n_used.to(device))


def assert_merge_equal(got, gstats, ref, rstats):
    assert bool(gstats["overflow"]) == bool(rstats["overflow"])
    assert int(gstats["nonini_occ_add"]) == int(rstats["nonini_occ_add"])
    assert int(got.n_used[0]) == int(ref.n_used[0])
    np.testing.assert_array_equal(got.keys.cpu().numpy(), ref.keys.cpu().numpy())
    np.testing.assert_allclose(got.vals.cpu().numpy(), ref.vals.cpu().numpy(),
                               rtol=1e-12, atol=1e-12)


def run_merge(cuda, a, sk, sv, si, layout, keep=None):
    n_vecs, origin, dest = layout
    if n_vecs == 2:
        a = ar.Arena(keys=a.keys, vals=torch.cat([a.vals[:1], torch.zeros_like(a.vals[:1])]),
                     n_used=a.n_used)
    ref, rstats = merge.accumulate(a, sk, sv, si, origin, dest, keep_mask=keep)
    before = profiling.total("launch.merge")
    got, gstats = merge.accumulate(
        to_dev(a, cuda), sk.to(cuda), sv.to(cuda), si.to(cuda), origin, dest,
        keep_mask=None if keep is None else keep.to(cuda))
    torch.cuda.synchronize()
    assert profiling.total("launch.merge") == before + 1
    assert_merge_equal(got, gstats, ref, rstats)


@pytest.mark.parametrize("layout", [(1, 0, 0), (2, 0, 1)])
@pytest.mark.parametrize("n_words", [1, 2])
@pytest.mark.parametrize("trial", range(2))
def test_merge_matches_plain(cuda, layout, n_words, trial):
    rng = np.random.default_rng(100 * n_words + trial)
    a, sk, sv, si = merge_case(rng, n_words, 1024, 400, 700, 800)
    run_merge(cuda, a, sk, sv, si, layout)


@pytest.mark.parametrize("trial", range(2))
def test_merge_fused_compaction(cuda, trial):
    rng = np.random.default_rng(80 + trial)
    a, sk, sv, si = merge_case(rng, 2, 1024, 400, 700, 800)
    keep = torch.as_tensor(rng.random(1024) < 0.05)
    run_merge(cuda, a, sk, sv, si, (2, 0, 1), keep)


def test_merge_large_stream_spans_scan_blocks(cuda):
    rng = np.random.default_rng(5)
    a, sk, sv, si = merge_case(rng, 2, 1 << 15, 12000, 40000, 30000)
    keep = torch.as_tensor(rng.random(1 << 15) < 0.1)
    run_merge(cuda, a, sk, sv, si, (2, 0, 1), keep)


@pytest.mark.parametrize("case", ["empty_spawns", "empty_arena", "overflow"])
def test_merge_edge_cases(cuda, case):
    rng = np.random.default_rng(7)
    if case == "empty_spawns":
        a, sk, sv, si = merge_case(rng, 2, 128, 40, 32, 64, invalid_frac=1.0)
    elif case == "empty_arena":
        a = ar.make(128, 2, 1)
        sk = torch.as_tensor(rng.integers(0, 2**16, size=(64, 2)))
        sv = torch.as_tensor(rng.standard_normal(64))
        si = torch.ones(64, dtype=torch.bool)
    else:
        a, sk, sv, si = merge_case(rng, 2, 64, 60, 200, 400, ini_frac=1.0,
                                   invalid_frac=0.0)
    run_merge(cuda, a, sk, sv, si, (1, 0, 0))
    run_merge(cuda, a, sk, sv, si, (2, 0, 1), torch.zeros(a.capacity, dtype=torch.bool))


CARD_REGIMES = ["long_run", "full_arena", "all_found", "none_found", "one_word",
                "runs_cross_tiles", "one_key", "tile_edges", "empty_arena"]


def regime_case(rng, regime):
    """merge_case reshaped into a regime the kernels' tiles and look-backs
    are sensitive to (one value row)."""
    tile = merge.TILE
    if regime == "full_arena":     # every slot holds a key
        a, sk, sv, si = merge_case(rng, 2, 512, 512, 700, 1200)
        assert int(a.n_used[0]) == 512
    elif regime in ("runs_cross_tiles", "one_key"):
        a, sk, sv, si = merge_case(rng, 2, 1 << 15, 12000, 40000, 30000)
        n = int(a.n_used[0])
        if regime == "one_key":    # every spawn on one arena key, 40 reduce tiles
            sk[:] = a.keys[rng.integers(n)]
        else:                      # runs of 5000 (an arena key) and 3000 (a new key)
            sk[:5000] = a.keys[rng.integers(n)]
            sk[5000:8000] = torch.tensor([123, 0x0FFFFFFF])
    elif regime == "tile_edges":   # S = TILE + 1, arena of TILE keys: tiles end at edges
        a, sk, sv, si = merge_case(rng, 2, 4 * tile, tile, tile + 1, 3 * tile)
    elif regime == "empty_arena":  # n_used = 0
        a = ar.make(1024, 2, 1)
        sk = torch.as_tensor(rng.integers(0, 2**16, size=(700, 2)))
        sv = torch.as_tensor(rng.standard_normal(700))
        si = torch.as_tensor(rng.random(700) < 0.6)
    else:
        a, sk, sv, si = merge_case(rng, 1 if regime == "one_word" else 2, 1024, 400, 700, 800)
        n = int(a.n_used[0])
        if regime == "long_run":   # 600 spawns on one key, longer than the Pallas TILE
            sk[:600] = a.keys[rng.integers(n)]
        elif regime == "all_found":
            sk = a.keys[torch.as_tensor(rng.integers(0, n, sk.shape[0]))]
        elif regime == "none_found":
            fresh = torch.as_tensor(rng.integers(0, 2**20, size=(4 * sk.shape[0], 2)))
            fresh = fresh[~torch.isin(dets.pack_key(fresh), dets.pack_key(a.keys[:n]))]
            sk = fresh[: sk.shape[0]]
    return a, sk, sv, si


@pytest.mark.parametrize("layout", [(1, 0, 0), (2, 0, 1)])
@pytest.mark.parametrize("regime", CARD_REGIMES)
def test_merge_regimes(cuda, regime, layout):
    rng = np.random.default_rng(500 + CARD_REGIMES.index(regime))
    a, sk, sv, si = regime_case(rng, regime)
    keep = torch.as_tensor(rng.random(a.capacity) < 0.05) if layout[0] == 2 else None
    run_merge(cuda, a, sk, sv, si, layout, keep)


def chunk_regime_case(rng, capacity, s_ratio, sentinel_frac):
    """The chunked exact-H step's merge: a two-row arena a third full, S =
    ``s_ratio`` * C spawns drawn with heavy repetition from C / 4 targets
    (half of them arena keys), a ``sentinel_frac`` share of them the
    sentinel key."""
    a, _, _, _ = merge_case(rng, 2, capacity, capacity // 3, 8, 2 * capacity, n_vecs=2)
    n = int(a.n_used[0])
    fresh = torch.as_tensor(rng.integers(0, 2**20, size=(capacity // 8, 2)))
    fresh[:, 1] &= 0x0FFFFFFF
    targets = torch.cat([a.keys[torch.as_tensor(rng.integers(0, n, capacity // 8))], fresh])
    s = int(s_ratio * capacity)
    sk = targets[torch.as_tensor(rng.integers(0, targets.shape[0], s))].clone()
    sk[torch.as_tensor(rng.random(s) < sentinel_frac)] = dets.WORD_MASK
    return a, sk, torch.as_tensor(rng.standard_normal(s) * 0.3), \
        torch.as_tensor(rng.random(s) < 0.5)


@pytest.mark.parametrize("sentinel_frac", [0.0, 0.6, 0.95])
@pytest.mark.parametrize("s_ratio", [0.25, 2, 8])
@pytest.mark.parametrize("capacity", [1024, 1 << 18])
def test_merge_chunked_regime(cuda, capacity, s_ratio, sentinel_frac):
    """Kernel A as the chunked exact-H step drives it: layout (2, 0, 1), the
    destination row zero or carrying earlier chunks' sums (rows with a zero
    origin value among them), no keep mask or one with protected bits."""
    rng = np.random.default_rng(int(1000 * sentinel_frac + 10 * s_ratio) + capacity)
    a, sk, sv, si = chunk_regime_case(rng, capacity, s_ratio, sentinel_frac)
    n = int(a.n_used[0])
    keep = torch.as_tensor(rng.random(capacity) < 0.05)
    dest = torch.zeros(capacity, dtype=torch.float64)
    dest[:n] = torch.as_tensor(rng.standard_normal(n))
    for dest_row, mask in ((None, None), (dest, None), (None, keep),
                           # with a mask, a row it lets drop carries no sum yet
                           (torch.where((a.vals[0] != 0) | keep, dest, 0.0), keep)):
        vals = a.vals.clone()
        if dest_row is not None:
            vals[1] = dest_row
        arena = ar.Arena(keys=a.keys, vals=vals, n_used=a.n_used)
        ref, rstats = merge.accumulate(arena, sk, sv, si, 0, 1, keep_mask=mask)
        before = profiling.total("launch.merge")
        got, gstats = merge.accumulate(to_dev(arena, cuda), sk.to(cuda), sv.to(cuda),
                                       si.to(cuda), 0, 1,
                                       keep_mask=None if mask is None else mask.to(cuda))
        torch.cuda.synchronize()
        assert profiling.total("launch.merge") == before + 1
        assert_merge_equal(got, gstats, ref, rstats)
        if mask is None:
            assert int(got.n_used[0]) >= n   # every valid row survives


@pytest.mark.parametrize("sentinel_frac", [0.0, 0.5, 0.9])
def test_merge_fciqmc_regime_exact(cuda, sentinel_frac):
    """Kernel A as the FCIQMC step drives it: layout (1, 0, 0), the origin
    row also the destination, holding integer post-death populations (a
    quarter of the rows died to 0 and stay), integer spawns with a run of
    5,000 on one key (longer than a tile), no keep mask.  The sums are
    integers, so the kernel equals its plain version exactly, values
    included."""
    rng = np.random.default_rng(int(100 * sentinel_frac) + 61)
    capacity, s = 1 << 16, 1 << 17
    a, _, _, _ = merge_case(rng, 1, capacity, 20000, 8, 80000)
    n = int(a.n_used[0])
    pops = rng.integers(-50, 51, n).astype(np.float64)
    pops[rng.random(n) < 0.25] = 0.0
    a.vals[0, :n] = torch.as_tensor(pops)
    fresh = torch.as_tensor(rng.integers(0, 2**20, size=(n // 2, 1)))
    targets = torch.cat([a.keys[torch.as_tensor(rng.integers(0, n, n // 2))], fresh])
    sk = targets[torch.as_tensor(rng.integers(0, targets.shape[0], s))].clone()
    sk[:5000] = a.keys[int(np.argmax(np.abs(pops)))]
    sk[torch.as_tensor(rng.random(s) < sentinel_frac)] = dets.WORD_MASK
    sv = torch.as_tensor(rng.integers(-3, 4, s).astype(np.float64))
    sv[sk[:, 0] == dets.WORD_MASK] = 0.0
    si = torch.as_tensor(rng.random(s) < 0.3)
    ref, rstats = merge.accumulate(a, sk, sv, si, 0, 0)
    before = profiling.total("launch.merge")
    got, gstats = merge.accumulate(to_dev(a, cuda), sk.to(cuda), sv.to(cuda), si.to(cuda),
                                   0, 0)
    torch.cuda.synchronize()
    assert profiling.total("launch.merge") == before + 1
    assert_merge_equal(got, gstats, ref, rstats)
    assert torch.equal(got.vals.cpu(), ref.vals)
    assert int(got.n_used[0]) >= n


def test_merge_shapes_keep_mask_checked(cuda):
    a = to_dev(ar.make(64, 2, 2), cuda)
    with pytest.raises(ValueError):
        merge.accumulate(a, a.keys[:4], torch.zeros(4, dtype=torch.float64, device=cuda),
                         torch.ones(4, dtype=torch.bool, device=cuda), 0, 1,
                         keep_mask=torch.ones(32, dtype=torch.bool, device=cuda))


# ---------------------------------------------------------------------------
# kernel C: multi-row merge
# ---------------------------------------------------------------------------

def multi_case(rng, n_words, n_rows, capacity=1024, n_occ=400, n_spawn=700,
               n_universe=800, **kw):
    a, sk, sv, si = merge_case(rng, n_words, capacity, n_occ, n_spawn, n_universe, **kw)
    n = int(a.n_used[0])
    vals = rng.standard_normal((n_rows, capacity))
    vals[rng.random((n_rows, capacity)) < 0.25] = 0.0
    vals[:, n:] = 0.0
    a = ar.Arena(keys=a.keys, vals=torch.as_tensor(vals), n_used=a.n_used)
    return a, sk, sv, torch.as_tensor(rng.integers(0, n_rows, n_spawn)), si


def run_merge_multi(cuda, a, sk, sv, sr, si):
    ref, rstats = merge_multi.accumulate(a, sk, sv, sr, si)
    before = profiling.total("launch.merge_multi")
    got, gstats = merge_multi.accumulate(to_dev(a, cuda), sk.to(cuda), sv.to(cuda),
                                         sr.to(cuda), si.to(cuda))
    torch.cuda.synchronize()
    assert profiling.total("launch.merge_multi") == before + 1
    assert_merge_equal(got, gstats, ref, rstats)
    return gstats


@pytest.mark.parametrize("n_rows", [1, 2, 5, 14])
@pytest.mark.parametrize("n_words", [1, 2])
def test_merge_multi_matches_plain(cuda, n_rows, n_words):
    rng = np.random.default_rng(10 * n_rows + n_words)
    run_merge_multi(cuda, *multi_case(rng, n_words, n_rows))


def test_merge_multi_large_stream_spans_scan_blocks(cuda):
    rng = np.random.default_rng(6)
    run_merge_multi(cuda, *multi_case(rng, 2, 2, 1 << 15, 12000, 40000, 30000))


@pytest.mark.parametrize("case", ["empty_spawns", "empty_arena", "overflow"])
def test_merge_multi_edge_cases(cuda, case):
    rng = np.random.default_rng(8)
    if case == "empty_spawns":
        args = multi_case(rng, 2, 2, 128, 40, 32, 64, invalid_frac=1.0)
    elif case == "empty_arena":
        args = (ar.make(128, 2, 2), torch.as_tensor(rng.integers(0, 2**16, size=(64, 2))),
                torch.as_tensor(rng.standard_normal(64)),
                torch.as_tensor(rng.integers(0, 2, 64)), torch.ones(64, dtype=torch.bool))
    else:
        args = multi_case(rng, 2, 3, 64, 60, 200, 400, ini_frac=1.0, invalid_frac=0.0)
    stats = run_merge_multi(cuda, *args)
    assert bool(stats["overflow"]) == (case == "overflow")


@pytest.mark.parametrize("regime", CARD_REGIMES + ["rows_14", "rows_32"])
def test_merge_multi_regimes(cuda, regime):
    rng = np.random.default_rng(600 + len(regime))
    n_rows = {"rows_14": 14, "rows_32": 32}.get(regime, 3)
    a, sk, sv, si = regime_case(rng, "runs_cross_tiles" if n_rows > 3 else regime)
    n = int(a.n_used[0])
    vals = rng.standard_normal((n_rows, a.capacity))
    vals[rng.random(vals.shape) < 0.25] = 0.0
    vals[:, n:] = 0.0
    a = ar.Arena(keys=a.keys, vals=torch.as_tensor(vals), n_used=a.n_used)
    run_merge_multi(cuda, a, sk, sv, torch.as_tensor(rng.integers(0, n_rows, sk.shape[0])), si)


def test_merge_multi_rejects_too_many_rows(cuda):
    a = to_dev(ar.make(64, 2, merge_multi.MAX_ROWS + 1), cuda)
    with pytest.raises(NotImplementedError):
        merge_multi.accumulate(a, a.keys[:4], torch.zeros(4, dtype=torch.float64, device=cuda),
                               torch.zeros(4, dtype=torch.int64, device=cuda),
                               torch.ones(4, dtype=torch.bool, device=cuda))


# ---------------------------------------------------------------------------
# kernel B: comp_sub emission, dense and factored row sources
# ---------------------------------------------------------------------------

def emission_case(rng, n, k, n_samp, out_size, uniform_frac, dtype, zero=False):
    values = np.where(rng.random(n) < 0.8, rng.gamma(1.0, 1.0, n), 0.0)
    if zero:
        values[:] = 0.0
    w = rng.random((n, k)) + 1e-6
    mask = rng.random((n, k)) < 0.8
    mask[:, 0] = True
    w = np.where(mask, w, 0.0)
    w /= w.sum(1, keepdims=True)
    ndiv = np.where(rng.random(n) < uniform_frac, rng.integers(1, 17, n), 0)
    plan, _ = compress.comp_sub_plan(
        torch.as_tensor(values), torch.as_tensor(ndiv), torch.as_tensor(w).to(dtype),
        torch.as_tensor(mask), n_samp, float(rng.random()), out_size)
    return plan


def assert_emission_close(plan, got, ref):
    gv, gp, gs = (t.cpu().numpy() for t in got)
    rv, rp, rs = (t.cpu().numpy() for t in ref)
    np.testing.assert_array_equal(gp, rp)
    kept = np.zeros(len(rp), bool)
    live = rp >= 0
    r = np.arange(len(rp))[live] - plan["offsets"].cpu().numpy()[rp[live]]
    kept[live] = r < plan["kept_counts"].cpu().numpy()[rp[live]]
    np.testing.assert_array_equal(gs[kept], rs[kept])
    np.testing.assert_array_equal(gv[kept], rv[kept])
    same = gs == rs
    assert same.mean() >= 0.9999, same.mean()
    np.testing.assert_allclose(gv[same], rv[same], rtol=1e-13, atol=1e-300)
    np.testing.assert_allclose(gv.sum(), rv.sum(), rtol=1e-11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,k,n_samp,out_size,uniform_frac", [
    (3000, 14, 1500, 2048, 0.0),
    (2500, 9, 3000, 4096, 0.4),
    (600, 6, 900, 256, 0.3),        # overflow: total > out_size
    (20000, 28, 15000, 16384, 0.2),
    (300, 2000, 600, 1024, 0.2),   # rows too wide to stage: walked in place
])
def test_emit_matches_plain(cuda, dtype, n, k, n_samp, out_size, uniform_frac):
    rng = np.random.default_rng(n + k)
    plan = emission_case(rng, n, k, n_samp, out_size, uniform_frac, dtype)
    ref = emit.emit(**plan)
    dev_plan = {key: v.to(cuda) if isinstance(v, torch.Tensor) else v
                for key, v in plan.items()}
    before = profiling.total("launch.emit")
    got = emit.emit(**dev_plan)
    torch.cuda.synchronize()
    assert profiling.total("launch.emit") == before + 1
    assert_emission_close(plan, got, ref)


def test_emit_zero_budget(cuda):
    rng = np.random.default_rng(5)
    plan = emission_case(rng, 300, 4, 100, 512, 0.0, torch.float32, zero=True)
    ref = emit.emit(**plan)
    got = emit.emit(**{key: v.to(cuda) if isinstance(v, torch.Tensor) else v
                       for key, v in plan.items()})
    assert_emission_close(plan, got, ref)


def test_emit_unaligned_rows(cuda):
    """Rows that start off a 16-byte boundary are staged element by element."""
    rng = np.random.default_rng(9)
    plan = emission_case(rng, 2000, 7, 1500, 2048, 0.2, torch.float32)
    ref = emit.emit(**plan)
    dev_plan = {key: v.to(cuda) if isinstance(v, torch.Tensor) else v
                for key, v in plan.items()}
    padded = torch.cat([torch.zeros_like(dev_plan["w_sub"][:1]), dev_plan["w_sub"]])
    dev_plan["w_sub"] = padded[1:]
    assert dev_plan["w_sub"].data_ptr() % 16 != 0
    assert_emission_close(plan, emit.emit(**dev_plan), ref)


def factored_inputs(rng, n, e_k, v_k, uniform_frac, dtype, kill, zero=False,
                    one_heavy=False):
    """comp_sub_factored's inputs (values, ndiv, fac_a, fac_b, kill_b0), CPU
    tensors: random factors; 1% of the parents carry 300x the mass (kept
    subs), and with ``one_heavy`` one parent with no zero sub carries nearly
    all of it, so that it keeps all of its K subs."""
    values = np.where(rng.random(n) < 0.8, rng.gamma(1.0, 1.0, n), 0.0)
    values = np.where(rng.random(n) < 0.01, 300.0 * values, values)
    if one_heavy:
        values[n // 2] = 1e4 * values.sum()
    if zero:
        values[:] = 0.0
    fa = rng.random((n, e_k)) * (rng.random((n, e_k)) < 0.8)
    fa[:, 0] += 1e-3
    if one_heavy:
        fa[n // 2] = rng.random(e_k) + 0.5
    fa /= fa.sum(1, keepdims=True)
    fb = rng.random((n, v_k)) + 1e-3
    fb /= fb.sum(1, keepdims=True)
    ndiv = np.where(rng.random(n) < uniform_frac, rng.integers(1, 9, n), 0)
    if one_heavy:
        ndiv[n // 2] = 0
    kill_b0 = torch.as_tensor(rng.random((n, e_k)) < 0.4) if kill else None
    return (torch.as_tensor(values), torch.as_tensor(ndiv), torch.as_tensor(fa).to(dtype),
            torch.as_tensor(fb).to(dtype), kill_b0)


def factored_case(rng, n, e_k, v_k, n_samp, out_size, uniform_frac, dtype, kill,
                  zero=False, one_heavy=False):
    """comp_sub_factored's plan over :func:`factored_inputs`."""
    values, ndiv, fa, fb, kill_b0 = factored_inputs(rng, n, e_k, v_k, uniform_frac, dtype,
                                                    kill, zero, one_heavy)
    plan, _ = compress.comp_sub_factored_plan(values, ndiv, fa, fb, n_samp,
                                              float(rng.random()), out_size, kill_b0=kill_b0)
    return plan


FACTORED_CASES = {  # (n, e, v, n_samp, out_size, uniform_frac, extra)
    "cd_widths_40pct_uniform": (5000, 14, 21, 5000, 6000, 0.4, {}),
    "counts_straddle_blocks": (3 * 256 + 17, 5, 6, 4000, 5000, 0.0, {}),
    "largest_count": (300, 14, 21, 3000, 4096, 0.0, {"one_heavy": True}),
    "overflow": (600, 4, 5, 900, 256, 0.0, {}),
    "zero_budget": (300, 4, 5, 100, 512, 0.0, {"zero": True}),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kill", [False, True])
@pytest.mark.parametrize("case", sorted(FACTORED_CASES))
def test_emit_factored_matches_plain(cuda, dtype, kill, case):
    n, e_k, v_k, n_samp, out_size, uf, extra = FACTORED_CASES[case]
    rng = np.random.default_rng(n + e_k + kill)
    plan = factored_case(rng, n, e_k, v_k, n_samp, out_size, uf, dtype, kill, **extra)
    total = int(plan["total"])
    counts = torch.diff(plan["offsets"], append=plan["total"].reshape(1))
    if case == "largest_count":
        assert int(counts.max()) >= e_k * v_k - e_k * kill   # all its live subs kept
    assert (total > out_size) == (case == "overflow")
    assert (total == 0) == (case == "zero_budget")
    ref = emit.emit_factored(**plan)
    dev_plan = {key: v.to(cuda) if isinstance(v, torch.Tensor) else v
                for key, v in plan.items()}
    before = profiling.total("launch.emit")
    got = emit.emit_factored(**dev_plan)
    torch.cuda.synchronize()
    assert profiling.total("launch.emit") == before + 1
    assert_emission_close(plan, got, ref)
    # the dense kernel over the materialized joint gives the same slots
    joint = emit.factored_rows(dev_plan["fa"], dev_plan["fb"], dev_plan["kill_b0"])
    dense = {key: v for key, v in dev_plan.items() if key not in ("fa", "fb", "kill_b0")}
    for g, d in zip(got, emit.emit(w_sub=joint, **dense)):
        assert torch.equal(g, d)


def test_emit_factored_unaligned_spans(cuda):
    """Factor spans that start off a 16-byte boundary are staged element by
    element."""
    rng = np.random.default_rng(10)
    plan = factored_case(rng, 2000, 14, 21, 2000, 2500, 0.3, torch.float32, True)
    ref = emit.emit_factored(**plan)
    dev_plan = {key: v.to(cuda) if isinstance(v, torch.Tensor) else v
                for key, v in plan.items()}
    for key in ("fa", "fb", "kill_b0"):
        flat = dev_plan[key].reshape(-1)
        padded = torch.cat([flat[:1], flat])[1:]
        assert padded.data_ptr() % 16 != 0
        dev_plan[key] = padded.view(dev_plan[key].shape)
    assert_emission_close(plan, emit.emit_factored(**dev_plan), ref)


# ---------------------------------------------------------------------------
# kernel F: the factored C+D plan's reductions
# ---------------------------------------------------------------------------

def split_parents(values, ndiv, uniform):
    """The plan's (u_uni, w_uni, ndiv) of the uniformly split parents."""
    w_uni = torch.where(uniform, values.to(torch.float64), 0.0)
    return w_uni / ndiv.clamp_min(1).to(torch.float64), w_uni, ndiv


def plan_case(case, dtype, kill):
    """The factors, kill bits, split parents and (stage-dtype) floor of
    FACTORED_CASES' plan (the same draws as :func:`factored_case`), on the
    CPU, with the plan."""
    n, e_k, v_k, n_samp, out_size, uf, extra = FACTORED_CASES[case]
    rng = np.random.default_rng(n + e_k + kill)
    values, ndiv, fac_a, fac_b, kill_b0 = factored_inputs(rng, n, e_k, v_k, uf, dtype, kill,
                                                          **extra)
    p, _ = compress.comp_sub_factored_plan(values, ndiv, fac_a, fac_b, n_samp,
                                           float(rng.random()), out_size, kill_b0=kill_b0)
    uni = split_parents(values, ndiv, p["uniform"])
    return p["fa"], p["fb"], kill_b0, uni, p["w_floor"].to(dtype), p


def on_card(cuda, *tensors):
    return [None if t is None else t.to(cuda) for t in tensors]


def straddling_thresholds(fa, fb, kill_b0, thr_f):
    """Five f64 thresholds around the kept set: the plan's own, two joint
    values (ties with ``>=``), the f64 successor of one (between two f32
    values) and infinity."""
    joint = emit.factored_rows(fa, fb, kill_b0).to(torch.float64).reshape(-1)
    pos = joint[joint > 0].sort().values
    if pos.numel() == 0:
        return [float(thr_f), 0.0, 1e-30, 1.0, float("inf")]
    a, b = float(pos[int(0.9 * (pos.numel() - 1))]), float(pos[int(0.999 * (pos.numel() - 1))])
    return [float(thr_f), a, float(np.nextafter(a, np.inf)), b, float("inf")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kill", [False, True])
@pytest.mark.parametrize("case", sorted(FACTORED_CASES))
def test_plan_total_and_seed_match_plain(cuda, dtype, kill, case):
    fa, fb, kill_b0, uni, _, p = plan_case(case, dtype, kill)
    d_fa, d_fb, d_kill = on_card(cuda, fa, fb, kill_b0)
    tot = plan_mod.total_plain(fa, fb, kill_b0)
    got_tot = plan_mod.launch(plan_mod.TOTAL, d_fa, d_fb, d_kill)
    np.testing.assert_allclose(float(got_tot), float(tot), rtol=1e-13, atol=0)
    n_samp = FACTORED_CASES[case][3]
    edges = compress._seed_edges(tot, n_samp)
    mass, cost = plan_mod.seed_plain(fa, fb, kill_b0, uni, edges)
    g_mass, g_cost = plan_mod.launch(plan_mod.SEED, d_fa, d_fb, d_kill, uni=on_card(cuda, *uni),
                                     edges=edges.to(cuda))
    assert torch.equal(g_cost.cpu(), cost)
    np.testing.assert_allclose(g_mass.cpu().numpy(), mass.numpy(), rtol=1e-6, atol=0)
    assert float(compress._seed_finish(g_mass.cpu(), g_cost.cpu(), n_samp, tot)) == float(
        compress._seed_finish(mass, cost, n_samp, tot))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kill", [False, True])
@pytest.mark.parametrize("case", sorted(FACTORED_CASES))
def test_plan_counts_and_parents_match_plain(cuda, dtype, kill, case):
    fa, fb, kill_b0, uni, w_floor, p = plan_case(case, dtype, kill)
    d_fa, d_fb, d_kill, d_floor = on_card(cuda, fa, fb, kill_b0, w_floor)
    d_uni = on_card(cuda, *uni)
    for thr in straddling_thresholds(fa, fb, kill_b0, p["thr"]):
        thr = torch.tensor(thr, dtype=torch.float64)
        loc, used = plan_mod.counts_plain(fa, fb, kill_b0, uni, w_floor, thr)
        g_loc, g_used = plan_mod.launch(plan_mod.COUNTS, d_fa, d_fb, d_kill, uni=d_uni,
                                        w_floor=d_floor, thr=thr.to(cuda))
        assert int(g_used) == int(used), float(thr)
        np.testing.assert_allclose(float(g_loc), float(loc), rtol=1e-13, atol=0)
        rem, kept = plan_mod.parents_plain(fa, fb, kill_b0, w_floor, thr)
        g_rem, g_kept = plan_mod.launch(plan_mod.PARENTS, d_fa, d_fb, d_kill, w_floor=d_floor,
                                        thr=thr.to(cuda))
        assert torch.equal(g_kept.cpu(), kept), float(thr)
        np.testing.assert_allclose(g_rem.cpu().numpy(), rem.numpy(), rtol=1e-13, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kill", [False, True])
@pytest.mark.parametrize("case", sorted(FACTORED_CASES))
def test_comp_sub_factored_kernels_match_plain(cuda, dtype, kill, case):
    """The whole round on the card (kernel F's plan, kernel B's emission)
    against the plain plan and emission on the CPU; kernel F launches R + 3
    times for R fixpoint rounds."""
    n, e_k, v_k, n_samp, out_size, uf, extra = FACTORED_CASES[case]
    rng = np.random.default_rng(n + e_k + kill)
    values, ndiv, fa, fb, kill_b0 = factored_inputs(rng, n, e_k, v_k, uf, dtype, kill, **extra)
    rn = float(rng.random())
    ref_plan, _ = compress.comp_sub_factored_plan(values, ndiv, fa, fb, n_samp, rn, out_size,
                                                  kill_b0=kill_b0)
    ref = compress.comp_sub_factored(values, ndiv, fa, fb, n_samp, rn, out_size, kill_b0=kill_b0)
    before = {c: profiling.total(c) for c in ("launch.plan", "fixpoint.comp_sub")}
    got = compress.comp_sub_factored(*on_card(cuda, values, ndiv, fa, fb), n_samp, rn,
                                     out_size, kill_b0=None if kill_b0 is None
                                     else kill_b0.to(cuda))
    torch.cuda.synchronize()
    rounds = profiling.total("fixpoint.comp_sub") - before["fixpoint.comp_sub"]
    assert rounds >= 1
    assert profiling.total("launch.plan") - before["launch.plan"] == rounds + 3
    assert int(got[3]) == int(ref[3]) and bool(got[4]) == bool(ref[4])
    assert_emission_close(ref_plan, got[:3], ref[:3])


@pytest.mark.parametrize("n,e_k,v_k,dtype", [
    (64, 900, 1000, torch.float32),          # a tile of 32 parents past shared memory
    (64, 500, 500, torch.float64),
    (0, 10, 21, torch.float32),              # no parent
])
def test_plan_raises_past_its_bounds(cuda, n, e_k, v_k, dtype):
    """Card factors the kernel takes no tile of raise; nothing runs plain."""
    fa = torch.ones(n, e_k, dtype=dtype, device=cuda)
    fb = torch.ones(n, v_k, dtype=dtype, device=cuda)
    before = profiling.total("launch.plan")
    with pytest.raises(ValueError, match="kernel F takes no"):
        plan_mod.total(fa, fb)
    assert profiling.total("launch.plan") == before


def test_plan_repeats_bit_for_bit(cuda):
    """At the N2 cell's widths over many tiles a block: every mode, and the
    whole round, twice from the same inputs give the same bits; each mode
    against the plain version on the card (counts exact, f64 sums at 1e-12,
    the seed's masses at 1e-6)."""
    rng = np.random.default_rng(77)
    n, e_k, v_k, n_samp = 300_000, 10, 21, 290_000
    values, ndiv, fac_a, fac_b, kill_b0 = on_card(cuda, *factored_inputs(
        rng, n, e_k, v_k, 0.3, torch.float32, True))
    p, _ = compress.comp_sub_factored_plan(values, ndiv, fac_a, fac_b, n_samp, 0.3,
                                           n_samp + 4096, kill_b0=kill_b0)
    fa, fb, w_floor, thr = p["fa"], p["fb"], p["w_floor"].float(), p["thr"]
    uni = split_parents(values, ndiv, p["uniform"])
    edges = compress._seed_edges(plan_mod.total_plain(fa, fb, kill_b0), n_samp)
    for mode, kw, plain in (
            (plan_mod.TOTAL, {}, lambda: [plan_mod.total_plain(fa, fb, kill_b0)]),
            (plan_mod.SEED, {"uni": uni, "edges": edges},
             lambda: plan_mod.seed_plain(fa, fb, kill_b0, uni, edges)),
            (plan_mod.COUNTS, {"uni": uni, "w_floor": w_floor, "thr": thr},
             lambda: plan_mod.counts_plain(fa, fb, kill_b0, uni, w_floor, thr)),
            (plan_mod.PARENTS, {"w_floor": w_floor, "thr": thr},
             lambda: plan_mod.parents_plain(fa, fb, kill_b0, w_floor, thr))):
        first, second = (plan_mod.launch(mode, fa, fb, kill_b0, **kw) for _ in range(2))
        if mode == plan_mod.TOTAL:
            first, second = [first], [second]
        exact = [mode == plan_mod.SEED and i == 1 or a.dtype == torch.int64
                 for i, a in enumerate(first)]
        for a, b, r, ex in zip(first, second, plain(), exact):
            assert torch.equal(a, b), mode
            if ex:
                assert torch.equal(a, r.to(a.dtype)), mode
            else:
                torch.testing.assert_close(a, r, atol=0,
                                           rtol=1e-6 if mode == plan_mod.SEED else 1e-12)
    runs = [compress.comp_sub_factored(values, ndiv, fac_a, fac_b, n_samp, 0.3, n_samp + 4096,
                                       kill_b0=kill_b0) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_probe_reshape_kernel(cuda):
    x = torch.randint(-2**31, 2**31 - 1, (probe_reshape.RB, probe_reshape.LANES),
                      dtype=torch.int32, device=cuda)
    before = profiling.total("launch.probe_reshape")
    got = probe_reshape.reshape(x)
    torch.cuda.synchronize()
    assert profiling.total("launch.probe_reshape") == before + 1
    assert torch.equal(got, probe_reshape.reshape_plain(x))
    assert probe_reshape.probe(cuda)


def test_probe_copy_kernel(cuda):
    """Kernel #5, the backend probe: the loader has launched it once; a copy
    of a random (16, 128) tile equals the plain version."""
    _build.load()
    assert profiling.total("launch.probe_copy") >= 1
    x = torch.randn(_build.PROBE_SHAPE, device=cuda)
    before = profiling.total("launch.probe_copy")
    got = _build.probe_copy(x)
    torch.cuda.synchronize()
    assert profiling.total("launch.probe_copy") == before + 1
    assert torch.equal(got, _build.probe_copy_plain(x))


# ---------------------------------------------------------------------------
# the main path: one step on the card vs the same step on the CPU
# ---------------------------------------------------------------------------

def test_frisys_step_cuda_matches_cpu(cuda):
    symm = np.array([0, 1, 0, 1, 0, 1, 2, 3])
    cfg = frisys.FrisysConfig(eps=0.02, vec_nonz=60, matr_samp=150, capacity=256,
                              spawn_cap=200, target_norm=200.0, shift_interval=2)
    built = {dev: frisys.build(synth.make_system(8, 4, symm=symm, seed=3, device=dev),
                               cfg, seed=4)
             for dev in ("cpu", cuda)}
    step_c, run_c, state, aux_c = built["cpu"]
    step_g, _, _, aux_g = built[cuda]
    args = lambda aux: (aux["num_keys"], aux["num_vals"], aux["den_keys"],
                        aux["den_vals"], aux["ref_key"])
    state, _ = run_c(state, *args(aux_c), 20)
    rng = np.random.default_rng(0)
    m0, e0 = profiling.total("launch.merge"), profiling.total("launch.emit")
    for _ in range(5):
        rns, rn = rng.random(6), float(rng.random())
        g_state = frisys.power.PowerState(to_dev(state.arena, cuda),
                                          state.en_shift.to(cuda),
                                          state.last_norm.to(cuda), state.iterat,
                                          state.generator)
        state, mc = step_c(state, *args(aux_c), rns=rns, rn_vec=rn)
        g_state, mg = step_g(g_state, *args(aux_g), rns=rns, rn_vec=rn)
        np.testing.assert_array_equal(g_state.arena.keys.cpu().numpy(),
                                      state.arena.keys.numpy())
        np.testing.assert_allclose(g_state.arena.vals.cpu().numpy(),
                                   state.arena.vals.numpy(), rtol=1e-10, atol=1e-12)
        for key in mc:
            np.testing.assert_allclose(float(mg[key]), float(mc[key]), rtol=1e-10,
                                       atol=1e-12, err_msg=key)
    assert profiling.total("launch.merge") - m0 == 5 and profiling.total("launch.emit") - e0 == 15


@pytest.mark.parametrize("spin_parity", [0, 1])
def test_subspace_step_cuda_matches_cpu(cuda, spin_parity):
    """Pivotal subspace steps on the card and on the CPU from the same state
    with the same key tree, across a restart and a norm-factor update, in
    the whole space and in the even time-reversal sector (folded trial
    vectors, H * trial, diagonal and spawner)."""
    symm = np.array([0, 1, 0, 1, 0, 1, 2, 3])
    hf = dets.hf_det(8, 4)
    d1, _ = dets.single_parity(hf[None], torch.tensor([1]), torch.tensor([5]))
    tk, tv = torch.stack([hf[None], d1]).numpy(), np.ones((2, 1))
    cfg = subspace.SubspaceConfig(eps=0.02, n_trial=2, vec_nonz=60, matr_samp=150,
                                  capacity=256, spawn_cap=200, restart_int=3,
                                  shift_interval=3, spin_parity=spin_parity)
    built = {dev: subspace.build(synth.make_system(8, 4, symm=symm, seed=3, device=dev),
                                 cfg, tk, tv, seed=4)
             for dev in ("cpu", cuda)}
    step_c, run_c, state, _ = built["cpu"]
    step_g = built[cuda][0]
    state, _ = run_c(state, 4)
    c0 = profiling.total("launch.merge_multi")
    for _ in range(4):
        g_state = subspace.SubspaceState(to_dev(state.arena, cuda),
                                         state.norm_factors.to(cuda),
                                         state.last_norms.to(cuda),
                                         trng.KeyTree(4, cuda), state.iterat)
        state, mc = step_c(state)
        g_state, mg = step_g(g_state)
        np.testing.assert_array_equal(g_state.arena.keys.cpu().numpy(),
                                      state.arena.keys.numpy())
        np.testing.assert_allclose(g_state.arena.vals.cpu().numpy(),
                                   state.arena.vals.numpy(), rtol=1e-10, atol=1e-12)
        for key in mc:
            np.testing.assert_allclose(mg[key].cpu().numpy(), mc[key].numpy(),
                                       rtol=1e-10, atol=1e-12, err_msg=key)
    assert profiling.total("launch.merge_multi") - c0 == 4


def card_steps_match_cpu(cuda, built, n_warm, n_steps, **step_kw):
    """Steps on the card and on the CPU from one state with the same
    uniforms; ``built`` maps "cpu" and the card to ``build``'s results."""
    step_c, run_c, state, aux_c = built["cpu"]
    step_g, _, _, aux_g = built[cuda]
    args = lambda aux: (aux["num_keys"], aux["num_vals"], aux["den_keys"],
                        aux["den_vals"], aux["ref_key"])
    kw = lambda aux: {k: aux[v] for k, v in step_kw.items()}
    state, _ = run_c(state, *args(aux_c), n_warm, **kw(aux_c))
    rng = np.random.default_rng(0)
    for _ in range(n_steps):
        rns, rn = rng.random(6), float(rng.random())
        g_state = power.PowerState(to_dev(state.arena, cuda), state.en_shift.to(cuda),
                                   state.last_norm.to(cuda), state.iterat, state.generator)
        state, mc = step_c(state, *args(aux_c), rns=rns, rn_vec=rn, **kw(aux_c))
        g_state, mg = step_g(g_state, *args(aux_g), rns=rns, rn_vec=rn, **kw(aux_g))
        np.testing.assert_array_equal(g_state.arena.keys.cpu().numpy(),
                                      state.arena.keys.numpy())
        np.testing.assert_allclose(g_state.arena.vals.cpu().numpy(),
                                   state.arena.vals.numpy(), rtol=1e-10, atol=1e-12)
        for key in mc:
            np.testing.assert_allclose(float(mg[key]), float(mc[key]), rtol=1e-10,
                                       atol=1e-12, err_msg=key)
    return mc


SYMM8 = np.array([0, 1, 0, 1, 0, 1, 2, 3])


@pytest.mark.parametrize("path", ["semistoch", "spin_parity"])
def test_frisys_options_step_cuda_matches_cpu(cuda, path):
    """The semistochastic step (a deterministic space of 8, protected) and
    the even-sector step on the card against the CPU."""
    cfg = frisys.FrisysConfig(eps=0.02, vec_nonz=60, matr_samp=700, capacity=256,
                              spawn_cap=400, target_norm=110.0, shift_interval=2,
                              spin_parity=int(path == "spin_parity"))
    space = rung.determ_space(synth.make_system(8, 4, symm=SYMM8, seed=3), 8)
    built = {dev: frisys.build(synth.make_system(8, 4, symm=SYMM8, seed=3, device=dev), cfg,
                               seed=4, determ_keys=space if path == "semistoch" else None)
             for dev in ("cpu", cuda)}
    m0, e0 = profiling.total("launch.merge"), profiling.total("launch.emit")
    kw = dict(protected_keys="protected_keys") if path == "semistoch" else {}
    mc = card_steps_match_cpu(cuda, built, 20, 4, **kw)
    assert profiling.total("launch.merge") - m0 == 4 and profiling.total("launch.emit") - e0 == 12
    assert float(mc["shift"]) != 0.0


@pytest.mark.parametrize("dedup_cap", [0, 4096])
@pytest.mark.parametrize("spin_parity", [0, 1])
def test_frifull_step_cuda_matches_cpu(cuda, spin_parity, dedup_cap):
    """The chunked exact-H step on the card against the CPU: one kernel A
    launch per chunk."""
    cfg = power.PowerConfig(eps=0.02, target_nonz=60, capacity=512, target_norm=110.0,
                            shift_interval=2, init_thresh=1.0, batch=32, spawn_rows=256,
                            dedup_cap=dedup_cap)
    built = {dev: frifull.build(synth.make_system(8, 4, symm=SYMM8, seed=3, device=dev), cfg,
                                seed=4, spin_parity=spin_parity)
             for dev in ("cpu", cuda)}
    m0 = profiling.total("launch.merge")
    mc = card_steps_match_cpu(cuda, built, 12, 4)
    assert profiling.total("launch.merge") - m0 == 4 * 8
    assert not bool(mc["overflow"]) and int(mc["nnonz"]) > 30


@pytest.mark.parametrize("dist,integer", [("NU", True), ("NU", False), ("HB", True),
                                          ("HB", False)])
def test_fciqmc_step_cuda_matches_cpu(cuda, dist, integer):
    """FCIQMC on the card against the CPU from one state, both drawing from
    one key tree on the CPU: keys, counts and integer values exact, fp
    values within rtol 1e-12; one kernel A launch per step."""
    cfg = fciqmc.FciqmcConfig(eps=0.02, target_walkers=600.0, capacity=256, attempt_cap=4096,
                              init_thresh=2.0, distribution=dist, integer_walkers=integer,
                              shift_damping=0.25, shift_interval=4,
                              spawn_cap=1024 if integer else 0)
    built = {dev: fciqmc.build(synth.make_system(8, 4, symm=SYMM8, seed=3, device=dev), cfg,
                               seed=4, init_walkers=300)
             for dev in ("cpu", cuda)}
    step_c, run_c, state, aux_c = built["cpu"]
    step_g, _, _, aux_g = built[cuda]
    state, _ = run_c(state, *rung.estimator_args(aux_c), 20)
    m0 = profiling.total("launch.merge")
    for _ in range(4):
        g_state = fciqmc.FciqmcState(to_dev(state.arena, cuda), state.en_shift.to(cuda),
                                     state.last_norm.to(cuda), state.key, state.iterat)
        state, mc = step_c(state, *rung.estimator_args(aux_c))
        g_state, mg = step_g(g_state, *rung.estimator_args(aux_g))
        assert torch.equal(g_state.arena.keys.cpu(), state.arena.keys)
        assert int(g_state.arena.n_used[0]) == int(state.arena.n_used[0])
        if integer:
            assert torch.equal(g_state.arena.vals.cpu(), state.arena.vals)
        else:
            np.testing.assert_allclose(g_state.arena.vals.cpu().numpy(),
                                       state.arena.vals.numpy(), rtol=1e-12, atol=0)
        for key in ("n_dets", "nnonz", "sgn_coh", "overflow"):
            assert int(mg[key]) == int(mc[key]), key
        for key in ("proj_num", "proj_den", "norm", "shift"):
            np.testing.assert_allclose(float(mg[key]), float(mc[key]), rtol=1e-12, atol=0,
                                       err_msg=key)
    assert profiling.total("launch.merge") - m0 == 4


@pytest.mark.parametrize("dist", ["NU", "HB"])
def test_frimulti_step_cuda_matches_cpu(cuda, dist):
    """frimulti on the card against the CPU from one state with one key tree
    on the CPU; one kernel A launch per step."""
    cfg = frimulti.FrimultiConfig(eps=0.02, vec_nonz=40, matr_samp=120, capacity=256,
                                  spawn_cap=200, init_thresh=0.5, target_norm=50.0,
                                  shift_interval=3, distribution=dist)
    built = {dev: frimulti.build(synth.make_system(8, 4, symm=SYMM8, seed=3, device=dev), cfg,
                                 seed=4, init_val=30.0)
             for dev in ("cpu", cuda)}
    step_c, run_c, state, aux_c = built["cpu"]
    step_g, _, _, aux_g = built[cuda]
    args = lambda aux: (aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
                        aux["ref_key"])
    state, _ = run_c(state, *args(aux_c), 10)
    m0 = profiling.total("launch.merge")
    for _ in range(4):
        g_state = power.PowerState(to_dev(state.arena, cuda), state.en_shift.to(cuda),
                                   state.last_norm.to(cuda), state.iterat, state.generator,
                                   state.key)
        state, mc = step_c(state, *args(aux_c))
        g_state, mg = step_g(g_state, *args(aux_g))
        np.testing.assert_array_equal(g_state.arena.keys.cpu().numpy(),
                                      state.arena.keys.numpy())
        np.testing.assert_allclose(g_state.arena.vals.cpu().numpy(),
                                   state.arena.vals.numpy(), rtol=1e-10, atol=1e-12)
        for key in mc:
            np.testing.assert_allclose(float(mg[key]), float(mc[key]), rtol=1e-10,
                                       atol=1e-12, err_msg=key)
    assert profiling.total("launch.merge") - m0 == 4


# ---------------------------------------------------------------------------
# the Hubbard-Holstein regimes and the subspace modes
# ---------------------------------------------------------------------------

def hh_dets(rng, ham, n):
    """``n`` distinct random determinants of ``ham``: n_elec / 2 electrons
    of each spin on random sites, random phonon counters."""
    half = ham.n_elec // 2
    bits = np.zeros((n, ham.n_bits), bool)
    for row in bits:
        row[rng.choice(ham.n_sites, half, replace=False)] = True
        row[ham.n_sites + rng.choice(ham.n_sites, ham.n_elec - half, replace=False)] = True
        ph = rng.integers(0, ham.max_ph + 1, ham.n_sites) if ham.ph_bits else []
        for site, num in enumerate(ph):
            for b in range(ham.ph_bits):
                row[2 * ham.n_sites + site * ham.ph_bits + b] = (num >> b) & 1
    words = dets.pack_bits(torch.as_tensor(bits), ham.n_words)
    return torch.unique(words, dim=0)


def hh_merge_case(rng, ham, capacity, sentinel_frac=0.6):
    """A two-row arena of random HH determinants (half the capacity) and a
    stream of S = 20 C spawns drawn from their exact connections (phonon
    bits in the keys, every target repeated), ``sentinel_frac`` of it the
    sentinel key; a keep mask on a twentieth of the rows."""
    keys = hh_dets(rng, ham, capacity // 2)
    keys = keys[torch.sort(dets.pack_key(keys)).indices]
    n = keys.shape[0]
    a = ar.make(capacity, ham.n_words, 2)
    a.keys[:n] = keys
    a.vals[0, :n] = torch.as_tensor(np.where(rng.random(n) < 0.2, 0.0, rng.standard_normal(n)))
    a = ar.Arena(keys=a.keys, vals=a.vals, n_used=torch.tensor([n]))
    w, amp = hubbard.offdiag_batch(ham, keys, torch.ones(n, dtype=torch.float64), 1.0)
    w = w.reshape(-1, ham.n_words)[amp.reshape(-1) != 0]
    s = 20 * capacity
    sk = w[torch.as_tensor(rng.integers(0, w.shape[0], s))]
    sk[torch.as_tensor(rng.random(s) < sentinel_frac)] = dets.WORD_MASK
    return (a, sk, torch.as_tensor(rng.standard_normal(s) * 0.3),
            torch.as_tensor(rng.random(s) < 0.6), torch.as_tensor(rng.random(capacity) < 0.05))


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("n_sites", [4, 12])
def test_merge_hh_regime(cuda, n_sites, keep):
    """Kernel A on Hubbard-Holstein streams: one-word keys (4 sites) and
    two-word keys whose phonon counters cross the word boundary (12 sites),
    S = 20 C, 60% sentinel keys, layout (2, 0, 1) with and without a keep
    mask."""
    ham = hubbard.HubbardHolstein(n_sites=n_sites, n_elec=n_sites, ph_bits=3, u=2.0,
                                  omega=1.0, g=0.5)
    rng = np.random.default_rng(n_sites + 2 * keep)
    a, sk, sv, si, keep_mask = hh_merge_case(rng, ham, 4096)
    assert a.n_words == (2 if n_sites == 12 else 1)
    run_merge(cuda, a, sk, sv, si, (2, 0, 1), keep_mask if keep else None)


@pytest.mark.parametrize("g", [0.0, 0.5])
def test_emit_hh_level_one(cuda, g):
    """Kernel B at frisys_hh's level 1: K = 2 weighted rows (t, g), the
    phonon column of zero weight when g = 0."""
    rng = np.random.default_rng(int(10 * g) + 1)
    n = 20000
    values = torch.as_tensor(np.where(rng.random(n) < 0.7, rng.gamma(1.0, 1.0, n), 0.0))
    plan, _ = compress.comp_sub_plan(
        values, torch.zeros(n, dtype=torch.int64),
        torch.tensor([[1.0, g]], dtype=torch.float64).expand(n, 2),
        torch.ones((n, 2), dtype=torch.bool), 15000, float(rng.random()), 21000)
    run_emit(cuda, plan)


def test_emit_hh_level_two(cuda):
    """Kernel B at frisys_hh's level 2: K = 1 rows whose live parents are
    all uniform (ndiv 1-24), dead parents with ndiv >= 1 and value 0."""
    rng = np.random.default_rng(3)
    n = 21000
    ndiv = torch.as_tensor(rng.integers(1, 25, n))
    values = torch.as_tensor(np.where(rng.random(n) < 0.3, 0.0, rng.gamma(1.0, 1.0, n)))
    plan, _ = compress.comp_sub_plan(values * ndiv, ndiv, torch.zeros((n, 1), dtype=torch.float64),
                                     torch.zeros((n, 1), dtype=torch.bool), 15000,
                                     float(rng.random()), n)
    run_emit(cuda, plan)


def run_emit(cuda, plan):
    ref = emit.emit(**plan)
    before = profiling.total("launch.emit")
    got = emit.emit(**{key: v.to(cuda) if isinstance(v, torch.Tensor) else v
                       for key, v in plan.items()})
    torch.cuda.synchronize()
    assert profiling.total("launch.emit") == before + 1
    assert_emission_close(plan, got, ref)


@pytest.mark.parametrize("order", ["blocked", "interleaved"])
def test_merge_multi_exact_chunks(cuda, order):
    """Kernel C on an exact-H stream merged chunk by chunk: two chunks of a
    two-vector arena's exact spawns (all initiators), the second merged
    into the arena that holds the first's sums; destination rows 0 and 1 in
    the subspace step's blocked order or interleaved."""
    ham = synth.make_system(8, 4, symm=SYMM8, seed=3)
    tmpl = mol.ExcitationTemplate.build(8, 4)
    hf = dets.hf_det(8, 4)
    w, amp = subspace.exact_spawn(ham, tmpl, hf[None], torch.ones(1, dtype=torch.float64), 1.0)
    keys = torch.unique(torch.cat([hf[None], w[amp != 0]]), dim=0)
    keys = keys[torch.sort(dets.pack_key(keys)).indices]
    n = keys.shape[0]
    rng = np.random.default_rng(8)
    vals = torch.as_tensor(np.where(rng.random((2, n)) < 0.3, 0.0,
                                    rng.standard_normal((2, n))))
    a = ar.make(1024, 1, 2)
    a.keys[:n], a.vals[:, :n] = keys, vals
    a = ar.Arena(keys=a.keys, vals=a.vals, n_used=torch.tensor([n]))
    ref, got = a, to_dev(a, cuda)
    for rows in (slice(0, n // 2), slice(n // 2, n)):
        parts = [subspace.exact_spawn(ham, tmpl, keys[rows], vals[j, rows], -0.02)
                 for j in range(2)]
        sk, sv = (torch.cat(x) for x in zip(*parts))
        sr = torch.arange(2).repeat_interleave(parts[0][1].shape[0])
        if order == "interleaved":
            perm = torch.arange(sk.shape[0]).reshape(2, -1).T.reshape(-1)
            sk, sv, sr = sk[perm], sv[perm], sr[perm]
        si = torch.ones(sk.shape[0], dtype=torch.bool)
        ref, rstats = merge_multi.accumulate(ref, sk, sv, sr, si)
        before = profiling.total("launch.merge_multi")
        got, gstats = merge_multi.accumulate(got, sk.to(cuda), sv.to(cuda), sr.to(cuda),
                                             si.to(cuda))
        torch.cuda.synchronize()
        assert profiling.total("launch.merge_multi") == before + 1
        assert_merge_equal(got, gstats, ref, rstats)
    assert int(ref.n_used[0]) > n


def small_hh(g=0.4, ph_bits=2):
    return hubbard.HubbardHolstein(n_sites=3, n_elec=2, ph_bits=ph_bits, u=1.5, omega=0.7,
                                   g=g, t=1.0)


@pytest.mark.parametrize("driver", ["frifull_hh", "frisys_hh"])
@pytest.mark.parametrize("g,ph_bits", [(0.4, 2), (0.0, 0)])
def test_hh_step_cuda_matches_cpu(cuda, driver, g, ph_bits):
    """frifull_hh and frisys_hh on the card against the CPU from one state
    with the same uniforms; one kernel A launch per step, and frisys_hh's
    two emissions."""
    ham = small_hh(g, ph_bits)
    if driver == "frifull_hh":
        cfg = power.PowerConfig(eps=0.02, target_nonz=20, capacity=256, target_norm=150.0,
                                shift_interval=2)
        built = {dev: frifull_hh.build(ham, 0.1, cfg, seed=3, device=dev)
                 for dev in ("cpu", cuda)}
    else:
        cfg = frisys_hh.FrisysHHConfig(eps=0.02, vec_nonz=20, matr_samp=40, capacity=128,
                                       spawn_cap=64, target_norm=150.0, shift_interval=2)
        built = {dev: frisys_hh.build(ham, 0.1, cfg, seed=3, device=dev)
                 for dev in ("cpu", cuda)}
    m0, e0 = profiling.total("launch.merge"), profiling.total("launch.emit")
    mc = card_steps_match_cpu(cuda, built, 12, 4)
    assert profiling.total("launch.merge") - m0 == 4
    assert profiling.total("launch.emit") - e0 == (8 if driver == "frisys_hh" else 0)
    assert int(mc["n_dets"]) > 5


@pytest.mark.parametrize("mode", ["lowmem", "lowmem_tr", "exact_h", "multi"])
def test_subspace_mode_step_cuda_matches_cpu(cuda, mode):
    """The subspace modes on the card against the CPU from one state with
    one key tree: lowmem (also in the even sector), exact_h in 16-row
    chunks (one kernel C launch per chunk), multi."""
    modes = {"lowmem": dict(lowmem=True), "lowmem_tr": dict(lowmem=True, spin_parity=1),
             "exact_h": dict(exact_h=True, batch=16),
             "multi": dict(compress_mode="multi")}[mode]
    hf = dets.hf_det(8, 4)
    d1, _ = dets.single_parity(hf[None], torch.tensor([1]), torch.tensor([5]))
    tk, tv = torch.stack([hf[None], d1]).numpy(), np.ones((2, 1))
    cfg = subspace.SubspaceConfig(eps=0.02, n_trial=2, vec_nonz=60, matr_samp=150,
                                  capacity=512, spawn_cap=200, restart_int=3,
                                  shift_interval=3, **modes)
    built = {dev: subspace.build(synth.make_system(8, 4, symm=SYMM8, seed=3, device=dev),
                                 cfg, tk, tv, seed=4)
             for dev in ("cpu", cuda)}
    step_c, run_c, state, _ = built["cpu"]
    step_g = built[cuda][0]
    state, _ = run_c(state, 4)
    c0, merges = profiling.total("launch.merge_multi"), 0
    for _ in range(4):
        g_state = subspace.SubspaceState(to_dev(state.arena, cuda),
                                         state.norm_factors.to(cuda),
                                         state.last_norms.to(cuda),
                                         trng.KeyTree(4, cuda), state.iterat)
        state, mc = step_c(state)
        g_state, mg = step_g(g_state)
        np.testing.assert_array_equal(g_state.arena.keys.cpu().numpy(),
                                      state.arena.keys.numpy())
        np.testing.assert_allclose(g_state.arena.vals.cpu().numpy(),
                                   state.arena.vals.numpy(), rtol=1e-10, atol=1e-12)
        for key in mc:
            np.testing.assert_allclose(mg[key].cpu().numpy(), mc[key].numpy(),
                                       rtol=1e-10, atol=1e-12, err_msg=key)
        merges += int(mc.get("n_merges", 1))
    assert profiling.total("launch.merge_multi") - c0 == merges
    assert merges >= (12 if mode == "exact_h" else 4)


# ---------------------------------------------------------------------------
# kernel A in general layouts (the observables' four-row merges), kernel B at
# the unfused frisys levels, and the two paths' steps on the card
# ---------------------------------------------------------------------------

GENERAL_LAYOUTS = [(4, 0, 0), (4, 0, 3), (4, 1, 1), (4, 1, 3), (3, 2, 0), (1, 0, 0),
                   (2, 1, 1), (32, 31, 5), (32, 7, 7)]


@pytest.mark.parametrize("sentinel_frac", [0.1, 0.9])
@pytest.mark.parametrize("n_words", [1, 2])
@pytest.mark.parametrize("layout", GENERAL_LAYOUTS)
def test_merge_general_layouts(cuda, layout, n_words, sentinel_frac):
    """Kernel A without a keep mask at (n_vecs, origin, dest), origin ==
    dest included, every row holding values (zeros in the origin row among
    them), mixed initiator flags, against its plain version."""
    n_vecs, origin, dest = layout
    rng = np.random.default_rng(1000 + 31 * n_vecs + 7 * origin + dest + n_words)
    a, sk, sv, si = merge_case(rng, n_words, 2048, 700, 5000, 1500,
                               invalid_frac=sentinel_frac)
    n = int(a.n_used[0])
    vals = rng.standard_normal((n_vecs, a.capacity))
    vals[rng.random(vals.shape) < 0.3] = 0.0
    vals[:, n:] = 0.0
    a = ar.Arena(keys=a.keys, vals=torch.as_tensor(vals), n_used=a.n_used)
    ref, rstats = merge.accumulate_plain(a, sk, sv, si, origin, dest)
    before = profiling.total("launch.merge")
    got, gstats = merge.accumulate(to_dev(a, cuda), sk.to(cuda), sv.to(cuda), si.to(cuda),
                                   origin, dest)
    torch.cuda.synchronize()
    assert profiling.total("launch.merge") == before + 1
    assert_merge_equal(got, gstats, ref, rstats)
    others = [r for r in range(n_vecs) if r != dest]
    assert torch.equal(got.vals[others].cpu(), ref.vals[others])


def test_merge_refuses_layouts_outside_its_contract(cuda):
    """A keep mask outside (1, 0, 0) and (2, 0, 1), a row outside the arena,
    or more than 32 value rows: refused before any launch."""
    a4 = to_dev(ar.make(64, 2, 4), cuda)
    keys = a4.keys[:4]
    vals = torch.zeros(4, dtype=torch.float64, device=cuda)
    ini = torch.ones(4, dtype=torch.bool, device=cuda)
    keep = torch.ones(64, dtype=torch.bool, device=cuda)
    before = profiling.total("launch.merge")
    for origin, dest, mask in ((0, 3, keep), (0, 0, keep), (1, 1, keep), (0, 4, None),
                               (4, 0, None), (-1, 0, None)):
        with pytest.raises(NotImplementedError):
            merge.accumulate(a4, keys, vals, ini, origin, dest, keep_mask=mask)
    a33 = to_dev(ar.make(64, 2, 33), cuda)
    with pytest.raises(NotImplementedError):
        merge.accumulate(a33, keys, vals, ini, 0, 0)
    assert profiling.total("launch.merge") == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k,uniform_frac", [(2, 0.0), (14, 0.4), (21, 0.3), (14, 0.0)])
def test_emit_unfused_levels(cuda, dtype, k, uniform_frac):
    """Kernel B at the widths of the unfused frisys levels on the rung's
    system (28 orbitals, 14 electrons): level A's K = 2 rows, levels B and C's
    K = n_elec = 14 rows with uniform (single) parents, level D's K = n_virt
    = 21 rows."""
    rng = np.random.default_rng(50 + k)
    plan = emission_case(rng, 20000, k, 15000, 20480, uniform_frac, dtype)
    ref = emit.emit(**plan)
    before = profiling.total("launch.emit")
    got = emit.emit(**{key: v.to(cuda) if isinstance(v, torch.Tensor) else v
                       for key, v in plan.items()})
    torch.cuda.synchronize()
    assert profiling.total("launch.emit") == before + 1
    assert_emission_close(plan, got, ref)


@pytest.mark.parametrize("stages", [dict(fuse_ab=False), dict(fuse_cd=False),
                                    dict(fuse_ab=False, fuse_cd=False)])
def test_frisys_unfused_step_cuda_matches_cpu(cuda, stages):
    """The unfused stages' steps on the card against the CPU: one kernel B
    launch per comp_sub round (4 with one stage unfused, 5 with both)."""
    cfg = frisys.FrisysConfig(eps=0.02, vec_nonz=60, matr_samp=150, capacity=256,
                              spawn_cap=200, target_norm=200.0, shift_interval=2, **stages)
    built = {dev: frisys.build(synth.make_system(8, 4, symm=SYMM8, seed=3, device=dev), cfg,
                               seed=4)
             for dev in ("cpu", cuda)}
    m0, e0 = profiling.total("launch.merge"), profiling.total("launch.emit")
    card_steps_match_cpu(cuda, built, 20, 4)
    assert profiling.total("launch.merge") - m0 == 4
    assert profiling.total("launch.emit") - e0 == 4 * (3 + len(stages))


@pytest.mark.parametrize("target_nonz", [256, 30])
@pytest.mark.parametrize("replica", [False, True])
def test_observables_step_cuda_matches_cpu(cuda, replica, target_nonz):
    """Observable steps on the card against the CPU from one state, one key
    tree (the same bits on both devices): keys exact, values and estimators
    within rtol 1e-10; every merge a kernel A launch, none plain."""
    cfg = observables.ObservablesConfig(eps=0.05, target_nonz=target_nonz, capacity=1024,
                                        obs_des=1, obs_cre=3, burn_in=2, n_obs=2, btw_obs=2,
                                        replica=replica, batch=16)
    built = {dev: observables.build(synth.make_system(8, 4, symm=SYMM8, seed=3, device=dev),
                                    cfg, seed=4)
             for dev in ("cpu", cuda)}
    step_c, _, state_c, _ = built["cpu"]
    step_g, _, state_g, _ = built[cuda]
    m0, merges = profiling.total("launch.merge"), 0
    for _ in range(10):
        state_c, mc = step_c(state_c)
        state_g, mg = step_g(state_g)
        np.testing.assert_array_equal(state_g.arena.keys.cpu().numpy(),
                                      state_c.arena.keys.numpy())
        np.testing.assert_allclose(state_g.arena.vals.cpu().numpy(),
                                   state_c.arena.vals.numpy(), rtol=1e-10, atol=1e-13)
        for key in mc:
            np.testing.assert_allclose(float(mg[key]), float(mc[key]), rtol=1e-10,
                                       atol=1e-13, err_msg=key)
        assert not bool(mc["overflow"])
        merges += int(mc["n_merges"])
    assert profiling.total("launch.merge") - m0 == merges and merges > 20
    assert float(mc["obs_num"]) != 0.0


# ---------------------------------------------------------------------------
# kernels A and C on 128-bit keys (W = 3, 4)
# ---------------------------------------------------------------------------

def wide_case(rng, n_words, capacity, n_occ, n_spawn, n_universe, n_rows=1,
              ini_frac=0.6, invalid_frac=0.1):
    """merge_case's arena and stream over keys of 3 or 4 words: half of the
    rows share most words (zeros), the other half are copies of them with
    one word redrawn, so pairs differ only in the low word or only above the
    64-bit boundary; ``n_rows`` value rows, a quarter of them zero, and a
    destination row per spawn."""
    base = rng.integers(0, 2**32, size=(n_universe // 2, n_words))
    base[rng.random(base.shape) < 0.5] = 0
    base[:, -1] &= 0x00FFFFFF
    var = base.copy()
    var[np.arange(len(var)), rng.integers(0, n_words, len(var))] = rng.integers(
        0, 2**24, len(var))
    uni = np.unique(np.concatenate([base, var]), axis=0)
    uni = uni[dets.sort_dets(torch.as_tensor(uni)).numpy()]
    occ = uni[np.sort(rng.choice(len(uni), min(n_occ, len(uni)), replace=False))]
    a = ar.make(capacity, n_words, n_rows)
    keys = a.keys.clone()
    keys[: len(occ)] = torch.as_tensor(occ)
    vals = rng.standard_normal((n_rows, capacity))
    vals[rng.random(vals.shape) < 0.25] = 0.0
    vals[:, len(occ):] = 0.0
    a = ar.Arena(keys=keys, vals=torch.as_tensor(vals), n_used=torch.tensor([len(occ)]))
    sk = uni[rng.integers(0, len(uni), n_spawn)].copy()
    sk[rng.random(n_spawn) < invalid_frac] = dets.WORD_MASK
    return (a, torch.as_tensor(sk), torch.as_tensor(rng.standard_normal(n_spawn) * 0.3),
            torch.as_tensor(rng.integers(0, n_rows, n_spawn)),
            torch.as_tensor(rng.random(n_spawn) < ini_frac))


WIDE_CASES = {"random": {}, "sentinel_heavy": dict(invalid_frac=0.9),
              "overflow": dict(capacity=256, n_occ=250, ini_frac=1.0, invalid_frac=0.0),
              "empty_arena": dict(n_occ=0), "empty_spawns": dict(invalid_frac=1.0),
              "one_key": {}}


def wide_regime(rng, n_words, case, n_rows=1):
    kw = dict(capacity=1 << 13, n_occ=3000, n_spawn=6000, n_universe=8000, n_rows=n_rows)
    kw.update(WIDE_CASES[case])
    a, sk, sv, sr, si = wide_case(rng, n_words, **kw)
    if case == "one_key":       # a run of one key across several tiles
        sk[:2500] = a.keys[int(a.n_used[0]) // 2]
    return a, sk, sv, sr, si


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("n_words", [3, 4])
def test_merge_wide_matches_plain(cuda, n_words, case):
    rng = np.random.default_rng(700 + 10 * n_words + len(case))
    a, sk, sv, _, si = wide_regime(rng, n_words, case)
    run_merge(cuda, a, sk, sv, si, (1, 0, 0))
    keep = torch.as_tensor(rng.random(a.capacity) < 0.05)
    run_merge(cuda, a, sk, sv, si, (2, 0, 1), keep)


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("n_words", [3, 4])
def test_merge_multi_wide_matches_plain(cuda, n_words, case):
    rng = np.random.default_rng(800 + 10 * n_words + len(case))
    stats = run_merge_multi(cuda, *wide_regime(rng, n_words, case, n_rows=3))
    assert bool(stats["overflow"]) == (case == "overflow")


def test_merges_refuse_five_words(cuda):
    """Past the merges' width limit, 16 words (256 orbitals), W = 17 raises
    before a launch, on both merges."""
    a = to_dev(ar.make(64, 17, 2), cuda)
    sv = torch.zeros(4, dtype=torch.float64, device=cuda)
    si = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(NotImplementedError):
        merge.accumulate(a, a.keys[:4], sv, si, 0, 1)
    with pytest.raises(NotImplementedError):
        merge_multi.accumulate(a, a.keys[:4], sv, torch.zeros(4, dtype=torch.int64,
                                                              device=cuda), si)


def wide_system(device=None):
    return synth.make_system(50, 4, symm=np.arange(50) % 4, seed=3, scale_two=0.1,
                             device=device)


def test_wide_frisys_step_cuda_matches_cpu(cuda):
    """Four-word frisys steps (50 orbitals) on the card and on the CPU from
    one state with the same uniforms."""
    cfg = frisys.FrisysConfig(eps=0.01, vec_nonz=400, matr_samp=2000, capacity=8192,
                              spawn_cap=2600, target_norm=2000.0, shift_interval=2)
    built = {dev: frisys.build(wide_system(dev), cfg, seed=4) for dev in ("cpu", cuda)}
    m0, e0 = profiling.total("launch.merge"), profiling.total("launch.emit")
    card_steps_match_cpu(cuda, built, 3, 3)
    assert profiling.total("launch.merge") - m0 == 3 and profiling.total("launch.emit") - e0 == 9


def test_wide_subspace_step_cuda_matches_cpu(cuda):
    """Four-word subspace steps on the card and on the CPU from one state
    with the same key tree, across a restart."""
    hf = dets.hf_det(50, 4)
    d1, _ = dets.single_parity(hf[None], torch.tensor([1]), torch.tensor([5]))
    tk, tv = torch.stack([hf[None], d1]).numpy(), np.ones((2, 1))
    cfg = subspace.SubspaceConfig(eps=0.02, n_trial=2, vec_nonz=300, matr_samp=1500,
                                  capacity=8192, spawn_cap=2000, restart_int=3,
                                  shift_interval=3)
    built = {dev: subspace.build(wide_system(dev), cfg, tk, tv, seed=4)
             for dev in ("cpu", cuda)}
    step_c, run_c, state, _ = built["cpu"]
    step_g = built[cuda][0]
    state, _ = run_c(state, 1)
    c0 = profiling.total("launch.merge_multi")
    for _ in range(3):
        g_state = subspace.SubspaceState(to_dev(state.arena, cuda),
                                         state.norm_factors.to(cuda),
                                         state.last_norms.to(cuda),
                                         trng.KeyTree(4, cuda), state.iterat)
        state, mc = step_c(state)
        g_state, mg = step_g(g_state)
        np.testing.assert_array_equal(g_state.arena.keys.cpu().numpy(),
                                      state.arena.keys.numpy())
        np.testing.assert_allclose(g_state.arena.vals.cpu().numpy(),
                                   state.arena.vals.numpy(), rtol=1e-10, atol=1e-12)
        for key in mc:
            np.testing.assert_allclose(mg[key].cpu().numpy(), mc[key].numpy(),
                                       rtol=1e-10, atol=1e-12, err_msg=key)
    assert profiling.total("launch.merge_multi") - c0 == 3


# ---------------------------------------------------------------------------
# kernel G: the walker attempt pass
# ---------------------------------------------------------------------------

ATTEMPT_SLOTS = 1 << 20


N2_26_SYMM = [0] * 6 + [5] * 6 + [2] * 3 + [3] * 3 + [6] * 3 + [7] * 3 + [1, 4]


def attempt_system(name, device):
    """A heat-bath system of one (8 orbitals), two (N2-shaped: 28 orbitals,
    whose HF has no single, and the walker cell's 26 orbitals and 10
    electrons) or three (40 orbitals) 32-bit words, or one past kernel G's
    bounds (34 electrons)."""
    if name == "one_word":
        return synth.make_system(8, 4, symm=SYMM8, seed=3, device=device)
    if name == "n2":
        return synth.n2_ccpvdz_like(seed=1, device=device)
    if name == "n2_26":
        return synth.make_system(26, 10, symm=np.array(N2_26_SYMM), seed=1, scale_two=0.08,
                                 device=device)
    if name == "three_words":
        return synth.make_system(40, 8, symm=np.arange(40) % 8, seed=2, device=device)
    assert name == "past_bounds"
    return synth.make_system(36, 34, symm=np.arange(36) % 8, seed=2, device=device)


def attempt_arena(cuda, name, integer, distribution="HB", n_steps=3):
    """(ham, cfg, step, aux, state): ``n_steps`` FCIQMC steps on the card
    from 2e5 walkers on HF, at 2^20 attempt slots."""
    ham = attempt_system(name, cuda)
    cfg = fciqmc.FciqmcConfig(eps=0.01, target_walkers=1e6, capacity=1 << 18,
                              attempt_cap=ATTEMPT_SLOTS, init_thresh=3.0,
                              distribution=distribution, integer_walkers=integer)
    step, _, state, aux = fciqmc.build(ham, cfg, seed=2**31 + 7, init_walkers=2e5)
    for _ in range(n_steps):
        state, _ = step(state, *rung.estimator_args(aux))
    return ham, cfg, step, aux, state


def plain_draws(t, keys, occ, parent, kd, ks):
    """The plain samplers' doubles and singles for every slot."""
    n_orb, n_elec = t.ham.n_orb, t.ham.n_elec
    p_occ = occ[parent]
    p_bits = dets.unpack_bits(keys[parent], 2 * n_orb)
    counts = hb.unocc_symm_counts(n_orb, n_elec, t.symm, t.symm_counts, p_occ)
    d = nu.sample_doubles_heat_bath(kd, t.tens, n_orb, n_elec, t.symm, t.lookup, p_occ, p_bits)
    s = nu.sample_singles(ks, n_orb, n_elec, t.symm, t.lookup, p_occ, p_bits, counts)
    return d, s


def exc_field(exc, i):
    return (exc >> (8 * i)) & 0xFF


def single_condition(ham, s, p_occ):
    """Each single's element's condition number: the sum of its terms'
    magnitudes (``molecule.sing_matr_el``'s hcore, Coulomb and exchange
    terms) over the element's magnitude.  Two orders of the sum differ by a
    few ulps of the terms' scale, so the relative gap of two spawns grows
    with it.  Systems without a frozen core."""
    assert ham.n_frozen == 0
    n = ham.n_orb
    coul3, exch3, _, _ = mol._slices(ham)
    so, su = (s["o"] % n)[:, None], (s["u"] % n)[:, None]
    occ_sp = p_occ % n
    coul = coul3[so, su, occ_sp]
    exch = torch.where(p_occ // n == (s["o"] // n)[:, None], exch3[so, su, occ_sp], 0.0)
    h = ham.hcore[so[:, 0], su[:, 0]]
    scale = h.abs() + coul.abs().sum(-1) + exch.abs().sum(-1)
    return scale / (h + coul.sum(-1) - exch.sum(-1)).abs()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("name", ["one_word", "n2", "n2_26", "three_words"])
def test_attempt_kernel_matches_plain(cuda, name, integer):
    """Kernel G against the plain attempt pass on the same arena and key
    nodes at 2^20 slots: ``is_doub`` and every draw equal, keys equal where
    the spawn is not 0, initiator flags equal, spawns within 1e-13 relative
    (a single's, whose element may cancel, within 1e-13 times its
    condition number); a second launch equal bit for bit."""
    ham, cfg, _, aux, state = attempt_arena(cuda, name, integer)
    t = fciqmc.spawn_tables(ham, cfg, aux["p_doub"])
    assert t.kernel is not None
    args = aux["attempt_args"](state)
    keys, occ, n_walk, walk_sign, parent, valid, k_split, kd, ks = args
    assert int(valid.sum()) > ATTEMPT_SLOTS // 8
    nodes = attempt.node_keys(k_split, kd, ks)
    exc = torch.empty(ATTEMPT_SLOTS, dtype=torch.int64, device=cuda)
    g_words, g_vals, g_ini = attempt.launch(t.kernel, keys, occ, n_walk, walk_sign, parent,
                                            valid, nodes, exc=exc)
    p_words, p_vals, p_ini = fciqmc._attempt_pass_plain(t, *args)

    is_doub = k_split.uniform((ATTEMPT_SLOTS,)).to(cuda) < aux["p_doub"]
    d, s = plain_draws(t, keys, occ, parent, kd, ks)
    assert torch.equal(exc[~valid], torch.full_like(exc[~valid], -1))
    v, dbl = exc[valid], is_doub[valid]
    assert torch.equal((v & 1).bool(), dbl)
    for i, k in enumerate(("o1", "o2", "u1", "u2"), 1):
        assert torch.equal(exc_field(v[dbl], i), d[k][valid][dbl]), k
    for i, k in enumerate(("o", "u"), 1):
        assert torch.equal(exc_field(v[~dbl], i), s[k][valid][~dbl]), k
    want_ok = torch.where(is_doub, d["valid"], s["valid"])[valid]
    assert torch.equal(((v >> 1) & 1).bool(), want_ok)
    assert int(want_ok.sum()) > int(valid.sum()) // 10

    assert torch.equal(g_ini, p_ini)
    live = p_vals != 0
    assert torch.equal(g_vals != 0, live)
    assert torch.equal(g_words[live], p_words[live])
    cond = torch.where(is_doub, 1.0, single_condition(ham, s, occ[parent]).clamp_min(1.0))
    rel = ((g_vals - p_vals).abs() / (p_vals.abs() * cond))[live]
    assert float(rel.max()) <= 1e-13
    doub = live & is_doub
    torch.testing.assert_close(g_vals[doub], p_vals[doub], rtol=1e-13, atol=0)

    again = torch.empty_like(exc)
    words2, vals2, ini2 = attempt.launch(t.kernel, keys, occ, n_walk, walk_sign, parent,
                                         valid, nodes, exc=again)
    assert torch.equal(words2, g_words) and torch.equal(ini2, g_ini)
    assert torch.equal(vals2.view(torch.int64), g_vals.view(torch.int64))
    assert torch.equal(again, exc)


def test_attempt_kernel_launches_once_a_step(cuda):
    """The heat-bath walker step on the card takes kernel G: one launch a
    step, no plain pass on the card."""
    _, _, step, aux, state = attempt_arena(cuda, "n2", True, n_steps=1)
    before = {c: profiling.total(c) for c in ("launch.attempt", "attempt.plain_on_card")}
    for _ in range(3):
        state, m = step(state, *rung.estimator_args(aux))
    assert profiling.total("launch.attempt") - before["launch.attempt"] == 3
    assert profiling.total("attempt.plain_on_card") == before["attempt.plain_on_card"]
    assert int(m["nnonz"]) > 100


@pytest.mark.parametrize("name,distribution", [("n2", "NU")])
def test_attempt_plain_on_card(cuda, name, distribution):
    """Near-uniform doubles take the plain pass on the card, counted in
    ``attempt.plain_on_card`` once a step."""
    before = {c: profiling.total(c) for c in ("launch.attempt", "attempt.plain_on_card")}
    ham, cfg, _, aux, _ = attempt_arena(cuda, name, True, distribution, n_steps=2)
    assert fciqmc.spawn_tables(ham, cfg, aux["p_doub"]).kernel is None
    assert profiling.total("launch.attempt") == before["launch.attempt"]
    assert profiling.total("attempt.plain_on_card") - before["attempt.plain_on_card"] == 2


def test_attempt_kernel_raises_past_bounds(cuda):
    """A heat-bath system past kernel G's bounds (34 electrons) raises on
    the card when its walker step is built: no plain pass runs there."""
    with pytest.raises(ValueError, match="kernel G takes"):
        attempt_arena(cuda, "past_bounds", True, n_steps=0)


def test_attempt_kernel_needs_key_trees(cuda):
    """Kernel G refuses key nodes that are not ``rng.KeyTree`` s on the card
    rather than running the plain pass there."""
    ham, cfg, _, aux, state = attempt_arena(cuda, "one_word", True, n_steps=1)
    t = fciqmc.spawn_tables(ham, cfg, aux["p_doub"])
    keys, occ, n_walk, walk_sign, parent, valid, k_split, kd, ks = aux["attempt_args"](state)
    with pytest.raises(TypeError, match="KeyTree"):
        fciqmc._attempt_pass(t, keys, occ, n_walk, walk_sign, parent, valid, object(), kd, ks,
                             k_split)
