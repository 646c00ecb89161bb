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

from fries_tpu_torch import compress, dets, synth  # noqa: E402
from fries_tpu_torch.drivers import frisys  # noqa: E402
from fries_tpu_torch.runtime import arena as ar  # noqa: E402
from fries_tpu_torch.runtime import emit, merge  # noqa: E402

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
    before = merge.LAUNCHES
    got, gstats = merge.accumulate(
        to_dev(a, cuda), sk.to(cuda), sv.to(cuda), si.to(cuda), origin, dest,
        keep_mask=None if keep is None else keep.to(cuda))
    torch.cuda.synchronize()
    assert merge.LAUNCHES == before + 1
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


# ---------------------------------------------------------------------------
# kernel B: comp_sub emission
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
])
def test_emit_matches_plain(cuda, dtype, n, k, n_samp, out_size, uniform_frac):
    rng = np.random.default_rng(n + k)
    plan = emission_case(rng, n, k, n_samp, out_size, uniform_frac, dtype)
    ref = emit.emit(**plan)
    dev_plan = {key: v.to(cuda) if isinstance(v, torch.Tensor) else v
                for key, v in plan.items()}
    before = emit.LAUNCHES
    got = emit.emit(**dev_plan)
    torch.cuda.synchronize()
    assert emit.LAUNCHES == before + 1
    assert_emission_close(plan, got, ref)


def test_emit_zero_budget(cuda):
    rng = np.random.default_rng(5)
    plan = emission_case(rng, 300, 4, 100, 512, 0.0, torch.float32, zero=True)
    ref = emit.emit(**plan)
    got = emit.emit(**{key: v.to(cuda) if isinstance(v, torch.Tensor) else v
                       for key, v in plan.items()})
    assert_emission_close(plan, got, ref)


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
    m0, e0 = merge.LAUNCHES, emit.LAUNCHES
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
    assert merge.LAUNCHES - m0 == 5 and emit.LAUNCHES - e0 == 10
