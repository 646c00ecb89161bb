"""The C+D plan's reductions (fries_tpu_torch.runtime.plan) off the card:
the plain version against the joint rows formed whole and reduced in numpy,
and the dispatch: CPU tensors take the plain version, card tensors kernel F
whatever their shapes (its bounds are its own, and it raises past them).
Kernel F itself is tested on the card (tests/test_torch_kernels_cuda.py);
the whole C+D round against the reference in tests/test_torch_compress.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu_torch import compress, profiling  # noqa: E402
from fries_tpu_torch.runtime import plan  # noqa: E402

F64 = torch.float64


def inputs(seed, n, e_k, v_k, kill, dtype):
    rng = np.random.default_rng(seed)
    values = np.where(rng.random(n) < 0.8, rng.gamma(1.0, 1.0, n), 0.0)
    values = np.where(rng.random(n) < 0.01, 300.0 * values, values)
    fa = rng.random((n, e_k)) * (rng.random((n, e_k)) < 0.8)
    fa /= np.maximum(fa.sum(1, keepdims=True), 1e-300)
    fb = rng.random((n, v_k)) + 1e-3
    fb /= fb.sum(1, keepdims=True)
    ndiv = np.where(rng.random(n) < 0.3, rng.integers(1, 9, n), 0)
    kill_b0 = torch.as_tensor(rng.random((n, e_k)) < 0.4) if kill else None
    return (torch.as_tensor(values), torch.as_tensor(ndiv), torch.as_tensor(fa).to(dtype),
            torch.as_tensor(fb).to(dtype), kill_b0)


def split(values, ndiv):
    """The plan's (u_uni, w_uni, ndiv) of the uniformly split parents."""
    w_uni = torch.where((ndiv > 0) & (values > 0), values, 0.0)
    return w_uni / ndiv.clamp_min(1).to(F64), w_uni, ndiv


def joint_np(fa, fb, kill_b0):
    """The (N, E, V) joint in the stage dtype, each value one rounded product."""
    w = fa.numpy()[:, :, None] * fb.numpy()[:, None, :]
    if kill_b0 is not None:
        w[:, :, 0] = np.where(kill_b0.numpy(), 0.0, w[:, :, 0])
    return w.reshape(w.shape[0], -1)


@pytest.mark.parametrize("row_chunk", [0, 128])
@pytest.mark.parametrize("kill", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_plan_is_the_joints_reductions(dtype, kill, row_chunk):
    """Each plain reduction against the joint formed whole in numpy: counts
    exact, f64 sums to 1e-12, the seed's masses to 1e-6 (a row's sum in the
    stage dtype), at seed edges and thresholds on joint values (ties) and
    between them."""
    values, ndiv, fa, fb, kill_b0 = inputs(40 + kill, 900, 6, 7, kill, dtype)
    uni = split(values, ndiv)
    u_uni, w_uni, nd = (t.numpy() for t in uni)
    w = joint_np(fa, fb, kill_b0)
    w64 = w.astype(np.float64)
    np.testing.assert_allclose(float(plan.total_plain(fa, fb, kill_b0, row_chunk)),
                               w64.sum(), rtol=1e-12)
    pos = np.sort(w64[w64 > 0])
    edges = torch.tensor(pos[np.linspace(0, len(pos) - 1, plan.SEED_EDGES).astype(int)])
    mass, cost = plan.seed_plain(fa, fb, kill_b0, uni, edges, row_chunk)
    m_u, c_u = compress._seed_hist_part(*uni[:2], uni[2].clamp_min(1).to(F64), edges)
    for k, x in enumerate(edges.to(dtype).numpy()):
        ge = w >= x
        assert float(cost[k] - c_u[k]) == ge.sum()
        np.testing.assert_allclose(float(mass[k] - m_u[k]), w64[ge].sum(), rtol=1e-6)
    w_floor = torch.tensor(1e-9, dtype=dtype)
    for thr in (0.0, pos[len(pos) // 2], np.nextafter(pos[-50], np.inf), pos[-1], np.inf):
        kept = (w > w_floor.numpy()) & (w64 >= thr)
        kept_u = (w_uni > 0) & (u_uni >= thr)
        loc, used = plan.counts_plain(fa, fb, kill_b0, uni, w_floor,
                                      torch.tensor(thr, dtype=F64), row_chunk)
        assert int(used) == kept.sum() + nd[kept_u].sum()
        np.testing.assert_allclose(float(loc), w64[~kept].sum() + w_uni[~kept_u].sum(),
                                   rtol=1e-12)
        rem, kept_counts = plan.parents_plain(fa, fb, kill_b0, w_floor,
                                              torch.tensor(thr, dtype=F64), row_chunk)
        np.testing.assert_array_equal(kept_counts.numpy(), kept.sum(1))
        np.testing.assert_allclose(rem.numpy(), np.where(kept, 0.0, w64).sum(1), rtol=1e-12)


def test_dispatchers_never_launch_off_the_card(monkeypatch):
    """Every dispatcher returns the plain function's result for CPU tensors
    and never calls the kernel's wrapper, nor does the whole C+D plan."""
    def no_launch(*args, **kwargs):
        raise AssertionError("the kernel was launched for CPU tensors")

    monkeypatch.setattr(plan, "launch", no_launch)
    values, ndiv, fa, fb, kill_b0 = inputs(3, 300, 5, 9, True, torch.float32)
    w_uni = torch.where(ndiv > 0, values, 0.0)
    uni = (w_uni / ndiv.clamp_min(1), w_uni, ndiv)
    edges = compress._seed_edges(torch.tensor(200.0, dtype=F64), 150)
    w_floor = torch.tensor(1e-9, dtype=torch.float32)
    thr = torch.tensor(0.02, dtype=F64)
    assert torch.equal(plan.total(fa, fb, kill_b0), plan.total_plain(fa, fb, kill_b0))
    for got, ref in ((plan.seed(fa, fb, kill_b0, uni, edges),
                      plan.seed_plain(fa, fb, kill_b0, uni, edges)),
                     (plan.counts(fa, fb, kill_b0, uni, w_floor, thr),
                      plan.counts_plain(fa, fb, kill_b0, uni, w_floor, thr)),
                     (plan.parents(fa, fb, kill_b0, w_floor, thr),
                      plan.parents_plain(fa, fb, kill_b0, w_floor, thr))):
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    before = profiling.total("launch.plan")
    p, _ = compress.comp_sub_factored_plan(values, ndiv, fa, fb, 150, 0.4, 512, kill_b0=kill_b0)
    assert int(p["total"]) > 0 and profiling.total("launch.plan") == before


def test_plain_counts_agree_with_parents():
    """The per-parent pass sums to the counts at the same threshold, with no
    split parents."""
    _, _, fa, fb, kill_b0 = inputs(4, 500, 8, 11, True, torch.float32)
    zero = torch.zeros(500, dtype=F64)
    uni = (zero, zero, torch.zeros(500, dtype=torch.int64))
    w_floor = torch.tensor(1e-9, dtype=torch.float32)
    for thr in (0.0, 0.01, 0.05, float("inf")):
        thr = torch.tensor(thr, dtype=F64)
        loc, used = plan.counts_plain(fa, fb, kill_b0, uni, w_floor, thr)
        rem, kept = plan.parents_plain(fa, fb, kill_b0, w_floor, thr)
        assert int(kept.sum()) == int(used)
        np.testing.assert_allclose(float(rem.sum()), float(loc), rtol=1e-13)


def test_seed_edges_count_is_the_kernels():
    assert compress._SEED_EDGES == plan.SEED_EDGES == 20


class CardShaped:
    """A stand-in for a factor tensor on the card: only what the dispatch
    reads."""

    is_cuda = True

    def __init__(self, *shape, dtype=torch.float32):
        self.shape, self.dtype = shape, dtype


@pytest.mark.parametrize("shapes", [
    ((1000, 10), (1000, 21)),                # N2/cc-pVDZ less the 1s
    ((1000, 16), (1000, 100)),               # Ne2/cc-pVQZ, 108 orbitals
    ((1000, 900), (1000, 1000)),             # past the kernel's shared memory
    ((0, 10), (0, 21)),                      # no parent
])
def test_card_tensors_take_the_kernel(monkeypatch, shapes):
    """On the card every dispatcher hands its inputs to the kernel's
    wrapper, whatever the shapes; none runs the plain version there."""
    launched = []
    monkeypatch.setattr(plan, "launch", lambda mode, *args, **kwargs: launched.append(mode))
    for name in ("total_plain", "seed_plain", "counts_plain", "parents_plain"):
        monkeypatch.setattr(plan, name, lambda *args, **kwargs: pytest.fail("plain on the card"))
    fa, fb = CardShaped(*shapes[0]), CardShaped(*shapes[1])
    plan.total(fa, fb)
    plan.seed(fa, fb, None, None, None)
    plan.counts(fa, fb, None, None, None, None)
    plan.parents(fa, fb, None, None, None)
    assert launched == [plan.TOTAL, plan.SEED, plan.COUNTS, plan.PARENTS]
