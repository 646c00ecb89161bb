"""The port's sharded compressions in a 2-rank gloo world against the
reference's under ``shard_map`` on a 2-device mesh, fed the same inputs and
draws: find_preserve + sys_comp, piv_comp (the per-rank budgets of
piv_budget / piv_comp_serial and the rank-folded keys), multi_comp,
comp_sub (kernel B's plain version with a nonzero shard offset),
comp_sub_factored and comp_sub_piv.  Keep masks, parents and counts exact;
values at rtol 1e-12; a grid point next to a boundary may flip under
another summation order (0.01% of slots, as tests/test_torch_compress.py
allows).  The pivotal draws reach the ranks through
``torch_world.ReplayKeys``, recorded here from the reference's key.  Also
piv_budget and piv_comp_serial alone against the reference."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_world  # noqa: E402
from fries_tpu import compress as jc  # noqa: E402
from fries_tpu import parallel as jpar  # noqa: E402
from fries_tpu_torch import compress as tc  # noqa: E402
from fries_tpu_torch import parallel  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402

N = 2
AX = jpar.AXIS


class RecordKeys:
    """The reference's key behind the port's key-tree interface, recording
    every draw into ``table`` under its path (what ReplayKeys replays)."""

    def __init__(self, jk, table, path=()):
        self.jk, self.table, self.path = jk, table, path

    def fold(self, i):
        return RecordKeys(self.jk.fold(i), self.table, self.path + (("fold", int(i)),))

    def split(self, n):
        return [RecordKeys(k, self.table, self.path + (("split", n, j),))
                for j, k in enumerate(self.jk.split(n))]

    def uniform(self, shape=()):
        u = self.jk.uniform(shape)
        self.table[(self.path, tuple(shape))] = u.numpy()
        return u


def smap(fn, *arrays):
    """``fn`` on each shard's slice of the (N, ...) ``arrays`` under
    shard_map; outputs stacked (N, ...)."""
    def body(*xs):
        return tuple(jnp.asarray(o)[None] for o in fn(*[x[0] for x in xs]))
    f = jax.jit(jax.shard_map(body, mesh=jpar.make_mesh(N), in_specs=(P(AX),) * len(arrays),
                              out_specs=P(AX), check_vma=False))
    return [np.asarray(o) for o in f(*[jnp.asarray(a) for a in arrays])]


def check_emission(got, ref):
    gv, gp, gs, gn, go = got
    rv, rp, rs, rn_, ro = ref
    assert int(gn) == int(rn_) and bool(go) == bool(ro)
    np.testing.assert_array_equal(gp, rp)
    same = gs == rs
    assert same.mean() >= 0.9999, same.mean()
    np.testing.assert_allclose(gv[same], rv[same], rtol=1e-12, atol=1e-300)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(5)
    nl = 4096
    vals = rng.standard_normal((N, nl)) * rng.gamma(0.5, 1.0, (N, nl))
    vals[rng.random((N, nl)) < 0.2] = 0.0
    vals[1] *= 3.0                     # unequal shard norms
    n, k = 1500, 9
    values = np.where(rng.random((N, n)) < 0.8, rng.gamma(1.0, 1.0, (N, n)), 0.0)
    w = rng.random((N, n, k)) * (rng.random((N, n, k)) < 0.8) + 1e-9
    w /= w.sum(-1, keepdims=True)
    ndiv = np.where(rng.random((N, n)) < 0.3, rng.integers(1, 9, (N, n)), 0)
    fa = rng.random((N, n, 5))
    fa /= fa.sum(-1, keepdims=True)
    fb = rng.random((N, n, 6)) + 1e-3
    fb /= fb.sum(-1, keepdims=True)
    out_size = n * 4
    keys = {name: jax.random.key(s) for name, s in (("piv", 21), ("multi", 22), ("sub", 23))}

    table = {}
    rec = RecordKeys(JaxKeys(keys["piv"]), table, (("fold", 5),))
    tc.piv_budget(rec.fold(1), torch.ones(N, dtype=torch.float64), 10)
    for r in range(N):
        tc.piv_comp_shard(rec.fold(2).fold(r), torch.ones(nl, dtype=torch.float64),
                          torch.zeros(nl, dtype=torch.bool), torch.tensor(5))
    RecordKeys(JaxKeys(keys["multi"]), table, (("fold", 7),)).uniform((nl,))
    rec = RecordKeys(JaxKeys(keys["sub"]), table, (("fold", 11),))
    tc.piv_budget(rec.fold(1), torch.ones(N, dtype=torch.float64), 10)
    for r in range(N):
        tc.piv_select_tree_2d(rec.fold(2).fold(r), torch.zeros(n, max(k, 8),
                                                                 dtype=torch.float64))

    budget, budget_sub, rn = 3000, 1800, 0.3711
    cases = [("find_preserve", {"vals": vals}, budget, rn),
             ("compress_vector", {"vals": vals}, budget, rn),
             ("piv_comp", {"vals": vals}, budget, rn),
             ("multi_comp", {"vals": vals}, budget, rn),
             ("comp_sub", {"values": values, "ndiv": ndiv, "w": w}, budget_sub, rn),
             ("comp_sub_factored", {"values": values, "ndiv": ndiv, "fa": fa, "fb": fb},
              budget_sub, rn),
             ("comp_sub_piv", {"values": values, "ndiv": ndiv, "w": w}, budget_sub, rn)]
    got = parallel.launch(torch_world.compress_cases, N, "gloo", "cpu", args=(cases, table),
                          timeout=100, join_timeout=120)

    ref = {}
    ref["find_preserve"] = smap(lambda v: jc.find_preserve(jnp.abs(v), budget, axis_name=AX),
                                vals)
    ref["compress_vector"] = smap(lambda v: (jc.compress_vector(
        v, budget, jnp.asarray(rn, jnp.float64), axis_name=AX),), vals)
    ref["piv_comp"] = smap(lambda v: (jc.piv_comp(keys["piv"], v, budget, axis_name=AX),), vals)

    def _multi(v):
        keep, n_left, loc = jc.find_preserve(jnp.abs(v), budget, axis_name=AX)
        return (jc.multi_comp(keys["multi"], v, keep, n_left, loc, axis_name=AX),)
    ref["multi_comp"] = smap(_multi, vals)
    ref["comp_sub"] = smap(lambda a, b, c: jc.comp_sub(
        a, b.astype(jnp.int32), c, c != 0, budget_sub, jnp.asarray(rn, jnp.float64), out_size,
        axis_name=AX, pallas_emit=False), values, ndiv, w)
    ref["comp_sub_factored"] = smap(lambda a, b, c, d: jc.comp_sub_factored(
        a, b.astype(jnp.int32), c, d, budget_sub, jnp.asarray(rn, jnp.float64), out_size,
        axis_name=AX), values, ndiv, fa, fb)
    ref["comp_sub_piv"] = smap(lambda a, b, c: jc.comp_sub_piv(
        a, b.astype(jnp.int32), c, c != 0, budget_sub, keys["sub"], out_size, max_ndiv=8,
        axis_name=AX), values, ndiv, w)
    return got, ref, budget


def test_find_preserve_sharded(runs):
    got, ref, _ = runs
    for r in range(N):
        keep, n_left, loc = got[r]["find_preserve"]
        np.testing.assert_array_equal(keep, ref["find_preserve"][0][r])
        assert int(n_left) == int(ref["find_preserve"][1][r])
        np.testing.assert_allclose(loc, ref["find_preserve"][2][r], rtol=1e-12)
    assert 0 < int(n_left) < 3000 and ref["find_preserve"][0].sum() > 10


@pytest.mark.parametrize("name", ["compress_vector", "piv_comp"])
def test_vector_compression_sharded(runs, name):
    got, ref, budget = runs
    for r in range(N):
        g, want = got[r][name][0], ref[name][0][r]
        np.testing.assert_array_equal(g != 0, want != 0)
        np.testing.assert_allclose(g, want, rtol=1e-12, atol=0)
    total = sum(int((got[r][name][0] != 0).sum()) for r in range(N))
    assert 0 < total <= budget + N


def test_multi_comp_sharded(runs):
    """Rank 0 equals the reference; on rank 1 the reference also counts
    rank 0's draws at its first element (a reference fault), so the port is
    held to it past that element, and the counts of the two ranks together
    must be the global budget's."""
    got, ref, _ = runs
    g0, g1 = got[0]["multi_comp"][0], got[1]["multi_comp"][0]
    np.testing.assert_allclose(g0, ref["multi_comp"][0][0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(g1[1:], ref["multi_comp"][0][1][1:], rtol=1e-12, atol=0)
    keep, n_left = got[0]["find_preserve"][0], int(got[0]["find_preserve"][1])
    keep1 = got[1]["find_preserve"][0]
    unit = (np.abs(np.where(keep, 0, g0)).sum() + np.abs(np.where(keep1, 0, g1)).sum()) / n_left
    loc = [np.abs(np.where(kp, 0, v)) for kp, v in ((keep, g0), (keep1, g1))]
    counts = sum(x.sum() for x in loc) / unit
    assert round(counts) == n_left


@pytest.mark.parametrize("name", ["comp_sub", "comp_sub_factored", "comp_sub_piv"])
def test_comp_sub_sharded(runs, name):
    """Rank 1's grid starts at rank 0's norm: kernel B's plain version emits
    with a nonzero offset, and the grid counts summed over the ranks are the
    reference's."""
    got, ref, _ = runs
    for r in range(N):
        check_emission(got[r][name], [x[r] for x in ref[name]])
    assert all(int(got[r][name][3]) > 100 for r in range(N))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_piv_budget_matches_reference(seed):
    rng = np.random.default_rng(seed)
    norms = rng.gamma(1.0, 1.0, 4)
    key = jax.random.key(seed)
    want = np.asarray(jc.piv_budget(key, jnp.asarray(norms), 97))
    got = tc.piv_budget(JaxKeys(key), torch.as_tensor(norms), 97).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 97


def test_piv_budget_of_nothing_is_nothing():
    """No budget gives no rank a sample; the reference gives the rank
    holding all the norm a budget of 1 (which its comp_sub_piv then
    selects at an infinite unit)."""
    norms = np.array([5e-14])
    want = np.asarray(jc.piv_budget(jax.random.key(0), jnp.asarray(norms), 0))
    assert want.tolist() == [1]          # the reference's split
    got = tc.piv_budget(JaxKeys(jax.random.key(0)), torch.as_tensor(norms), 0)
    assert got.tolist() == [0]
    got = tc.piv_budget(JaxKeys(jax.random.key(0)), torch.tensor([3e-14, 1e-14],
                                                                 dtype=torch.float64),
                        torch.tensor(0))
    assert got.tolist() == [0, 0]


def test_piv_comp_serial_matches_reference():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(300)
    keep = rng.random(300) < 0.1
    loc = float(np.abs(np.where(keep, 0, vals)).sum())
    key = jax.random.key(4)
    want = np.asarray(jc.piv_comp_serial(key, jnp.asarray(vals), jnp.asarray(keep), 60, loc))
    got = tc.piv_comp_serial(JaxKeys(key), torch.as_tensor(vals), torch.as_tensor(keep), 60,
                             loc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    np.testing.assert_array_equal(got != 0, want != 0)
