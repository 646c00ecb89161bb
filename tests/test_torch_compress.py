"""fries_tpu_torch.compress against fries_tpu.compress with the same inputs
and the same uniforms: find_preserve, sys_comp, comp_sub (f32 and f64
stages; the reference's XLA emission and its Pallas emission in interpret
mode) and comp_sub_factored.  The port runs its plain emission here (CPU
tensors).  Tolerances are tests/test_pallas_emit.py's: exact parents and
counts, >= 99.99% equal subs (an f32 prefix summed in another order can
flip a grid boundary), values at rtol 1e-13 where subs agree, emitted mass at
rtol 1e-11.

The pivotal functions (piv_select_tree, piv_select_tree_2d, piv_comp,
comp_sub_piv) draw from the reference's jax.random key tree through
``jax_keys.JaxKeys``: selections, parents and subs exact, values at rtol
1e-12 (norms summed in another order move the unit by an ulp)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fries_tpu import compress as jc  # noqa: E402
from fries_tpu_torch import compress as tc, rng as trng  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402


def check_emission(got, ref):
    gv, gp, gs, gn, go = got
    rv, rp, rs, rn_, ro = ref
    assert int(gn) == int(rn_)
    assert bool(go) == bool(ro)
    gv, gp, gs = (x.numpy() for x in (gv, gp, gs))
    rv, rp, rs = (np.asarray(x) for x in (rv, rp, rs))
    np.testing.assert_array_equal(gp, rp)
    same = gs == rs
    assert (same.mean() if same.size else 1.0) >= 0.9999, same.mean()
    np.testing.assert_allclose(gv[same], rv[same], rtol=1e-13, atol=1e-300)
    np.testing.assert_allclose(gv.sum(), rv.sum(), rtol=1e-11)


def emission_inputs(seed, n, k, uniform_frac, zero=False, scale=1.0):
    rng = np.random.default_rng(seed)
    values = np.where(rng.random(n) < 0.8, rng.gamma(1.0, 1.0, n), 0.0) * scale
    if zero:
        values[:] = 0.0
    w = rng.random((n, k)) + 1e-6
    mask = rng.random((n, k)) < 0.8
    mask[:, 0] = True
    w = np.where(mask, w, 0.0)
    w /= w.sum(1, keepdims=True)
    ndiv = np.where(rng.random(n) < uniform_frac, rng.integers(1, 17, n), 0)
    return values, ndiv, w, mask


CASES = {  # (seed, n, k, uniform_frac, n_samp, rn, out_size, zero, scale)
    "weighted": (0, 3000, 14, 0.0, 1500, 0.3711, 2048, False, 1.0),
    "mixed": (1, 2500, 9, 0.4, 3000, 0.0377, 4096, False, 1.0),
    "heavy_kept": (3, 512, 7, 0.2, 1800, 0.5521, 2048, False, 50.0),
    "overflow": (4, 600, 6, 0.0, 900, 0.123, 256, False, 1.0),
    "zero_budget": (5, 300, 4, 0.0, 100, 0.7, 512, True, 1.0),
}


@pytest.mark.parametrize("stage", ["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_comp_sub_matches_reference(case, stage):
    seed, n, k, uf, n_samp, rn, out_size, zero, scale = CASES[case]
    values, ndiv, w, mask = emission_inputs(seed, n, k, uf, zero, scale)
    np_dt, t_dt = (np.float32, torch.float32) if stage == "f32" else (np.float64, torch.float64)
    got = tc.comp_sub(torch.as_tensor(values), torch.as_tensor(ndiv),
                      torch.as_tensor(w).to(t_dt), torch.as_tensor(mask), n_samp, rn,
                      out_size)
    jargs = (jnp.asarray(values), jnp.asarray(ndiv, jnp.int32), jnp.asarray(w.astype(np_dt)),
             jnp.asarray(mask), n_samp, jnp.asarray(rn, jnp.float64), out_size)
    check_emission(got, jc.comp_sub(*jargs, pallas_emit=False))
    if stage == "f32" and case in ("mixed", "overflow"):
        check_emission(got, jc.comp_sub(*jargs, pallas_emit="interpret"))


@pytest.mark.parametrize("stage", ["f32", "f64"])
@pytest.mark.parametrize("kill", [False, True])
def test_comp_sub_factored_matches_reference(stage, kill):
    rng = np.random.default_rng(10 + kill)
    n, e_k, v_k = 700, 5, 6
    values = np.where(rng.random(n) < 0.8, rng.gamma(1.0, 1.0, n), 0.0)
    fa = rng.random((n, e_k))
    fa /= fa.sum(1, keepdims=True)
    fb = rng.random((n, v_k)) + 1e-3
    fb /= fb.sum(1, keepdims=True)
    ndiv = np.where(rng.random(n) < 0.3, rng.integers(1, 9, n), 0)
    kill_b0 = rng.random((n, e_k)) < 0.4 if kill else None
    np_dt, t_dt = (np.float32, torch.float32) if stage == "f32" else (np.float64, torch.float64)
    n_samp, rn, out_size = 1200, 0.61, 1600
    ref = jc.comp_sub_factored(
        jnp.asarray(values), jnp.asarray(ndiv, jnp.int32), jnp.asarray(fa.astype(np_dt)),
        jnp.asarray(fb.astype(np_dt)), n_samp, jnp.asarray(rn, jnp.float64), out_size,
        kill_b0=None if kill_b0 is None else jnp.asarray(kill_b0))
    for row_chunk in (0, 256):
        got = tc.comp_sub_factored(
            torch.as_tensor(values), torch.as_tensor(ndiv), torch.as_tensor(fa).to(t_dt),
            torch.as_tensor(fb).to(t_dt), n_samp, rn, out_size,
            kill_b0=None if kill_b0 is None else torch.as_tensor(kill_b0),
            row_chunk=row_chunk)
        check_emission(got, ref)


@pytest.mark.parametrize("n_samp", [5, 40, 400])
def test_find_preserve_and_sys_comp(n_samp):
    # dyadic values: every partial sum is exact, so the two packages' cumsum
    # orders cannot move a grid boundary
    rng = np.random.default_rng(n_samp)
    vals = rng.integers(-4096, 4096, 600) * rng.integers(1, 64, 600) / 1024.0
    vals[rng.random(600) < 0.3] = 0.0
    jkeep, jleft, jnorm = jc.find_preserve(jnp.abs(jnp.asarray(vals)), n_samp)
    tkeep, tleft, tnorm = tc.find_preserve(torch.as_tensor(vals).abs(), n_samp)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert int(tleft) == int(jleft)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-13)
    for rn in (0.0, 0.25, 0.999):
        jout = jc.sys_comp(jnp.asarray(vals), jkeep, jleft, jnp.asarray(rn), jnorm)
        tout = tc.sys_comp(torch.as_tensor(vals), tkeep, tleft, torch.tensor(rn), tnorm)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-13, atol=0)


def test_adjust_shift():
    t = lambda x: torch.tensor(x, dtype=torch.float64)
    for last in (0.0, 90.0):
        for norm in (50.0, 150.0):
            js = jc.adjust_shift(0.3, norm, last, 100.0, 0.2)
            ts = tc.adjust_shift(t(0.3), t(norm), t(last), 100.0, 0.2)
            for a, b in zip(ts, js):
                np.testing.assert_allclose(float(a), float(b), rtol=1e-15)


def test_adjust_shift2():
    t = lambda x: torch.tensor(x, dtype=torch.float64)
    shift, norms, last = [0.8, 1.3], [120.0, 95.0], [100.0, 110.0]
    js = jc.adjust_shift2(jnp.asarray(shift), jnp.asarray(norms), jnp.asarray(last), 0.05)
    ts = tc.adjust_shift2(t(shift), t(norms), t(last), 0.05)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)


def test_key_tree_draws():
    """The port's counter-based key tree: reproducible, distinct per node,
    uniform in [0, 1)."""
    root = trng.KeyTree(7)
    a = root.fold(3).split(5)[2].uniform((4000,))
    np.testing.assert_array_equal(a.numpy(), trng.KeyTree(7).fold(3).split(5)[2].uniform((4000,)).numpy())
    b = root.fold(4).uniform((4000,))
    assert not np.array_equal(a.numpy(), b.numpy())
    for u in (a, b):
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.02
    assert root.uniform(()).shape == ()


@pytest.mark.parametrize("n", [7, 1024])
def test_piv_select_tree_matches_reference(n):
    rng = np.random.default_rng(n)
    p = rng.random(n) * (rng.random(n) < 0.7)
    key = jax.random.key(n)
    ref = np.asarray(jax.jit(jc.piv_select_tree)(key, jnp.asarray(p)))
    got = tc.piv_select_tree(JaxKeys(key), torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.floor(p.sum()) <= got.sum() <= np.ceil(p.sum())


@pytest.mark.parametrize("shape", [(50, 7), (13, 33)])
def test_piv_select_tree_2d_matches_reference(shape):
    rng = np.random.default_rng(shape[0] + shape[1])
    p = rng.random(shape) * 0.6 * (rng.random(shape) < 0.5)
    key = jax.random.key(shape[1])
    ref = np.asarray(jax.jit(jc.piv_select_tree_2d)(key, jnp.asarray(p)))
    got = tc.piv_select_tree_2d(JaxKeys(key), torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.any()


@pytest.mark.parametrize("n,n_samp", [(600, 150), (4096, 900)])
def test_piv_comp_matches_reference(n, n_samp):
    """n = 4096 takes the blocked duel order (rows of 128)."""
    rng = np.random.default_rng(n)
    vals = rng.standard_normal(n) * rng.gamma(0.5, 1.0, n)
    vals[rng.random(n) < 0.2] = 0.0
    key = jax.random.key(9)
    ref = np.asarray(jc.piv_comp(key, jnp.asarray(vals), n_samp))
    got = tc.piv_comp(JaxKeys(key), torch.as_tensor(vals), n_samp).numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    assert 0 < (ref != 0).sum() <= n_samp + 1


@pytest.mark.parametrize("stage", ["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_comp_sub_piv_matches_reference(case, stage):
    seed, n, k, uf, n_samp, _, out_size, zero, scale = CASES[case]
    values, ndiv, w, mask = emission_inputs(seed, n, k, uf, zero, scale)
    np_dt, t_dt = (np.float32, torch.float32) if stage == "f32" else (np.float64, torch.float64)
    key = jax.random.key(seed)
    rv, rp, rs, rn_, ro = jc.comp_sub_piv(
        jnp.asarray(values), jnp.asarray(ndiv, jnp.int32), jnp.asarray(w.astype(np_dt)),
        jnp.asarray(mask), n_samp, key, out_size, max_ndiv=16)
    gv, gp, gs, gn, go = tc.comp_sub_piv(
        torch.as_tensor(values), torch.as_tensor(ndiv), torch.as_tensor(w).to(t_dt),
        torch.as_tensor(mask), n_samp, JaxKeys(key), out_size, max_ndiv=16)
    assert (int(gn), bool(go)) == (int(rn_), bool(ro))
    assert bool(ro) == (case == "overflow")
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-12, atol=0)


def factored_inputs(seed, n, e_k, v_k, kill, heavy=0.01):
    rng = np.random.default_rng(seed)
    values = np.where(rng.random(n) < 0.8, rng.gamma(1.0, 1.0, n), 0.0)
    values = np.where(rng.random(n) < heavy, 300.0 * values, values)
    fa = rng.random((n, e_k)) * (rng.random((n, e_k)) < 0.8)
    fa /= np.maximum(fa.sum(1, keepdims=True), 1e-300)
    fb = rng.random((n, v_k)) + 1e-3
    fb /= fb.sum(1, keepdims=True)
    ndiv = np.where(rng.random(n) < 0.3, rng.integers(1, 9, n), 0)
    kill_b0 = torch.as_tensor(rng.random((n, e_k)) < 0.4) if kill else None
    return values, ndiv, fa, fb, kill_b0


@pytest.mark.parametrize("stage", ["f32", "f64"])
@pytest.mark.parametrize("kill", [False, True])
def test_emit_factored_equals_plain_over_joint(stage, kill):
    """On the CPU, emit_factored gives emit_plain's output over the
    materialized (N, E*V) joint, bit for bit."""
    from fries_tpu_torch.runtime import emit

    values, ndiv, fa, fb, kill_b0 = factored_inputs(20 + kill, 900, 6, 7, kill)
    t_dt = torch.float32 if stage == "f32" else torch.float64
    plan, _ = tc.comp_sub_factored_plan(
        torch.as_tensor(values), torch.as_tensor(ndiv), torch.as_tensor(fa).to(t_dt),
        torch.as_tensor(fb).to(t_dt), 1500, 0.417, 2048, kill_b0=kill_b0)
    assert int(plan["total"]) > 0
    got = emit.emit_factored(**plan)
    dense = {k: v for k, v in plan.items() if k not in ("fa", "fb", "kill_b0")}
    joint = emit.factored_rows(plan["fa"], plan["fb"], plan["kill_b0"])
    assert joint.shape == (900, 42) and joint.dtype == t_dt
    ref = emit.emit_plain(w_sub=joint, **dense)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_comp_sub_factored_goes_through_emit_factored(monkeypatch):
    """comp_sub_factored hands its plan to emit_factored (the kernel on the
    card) and never calls the plain emission itself."""
    from fries_tpu_torch.runtime import emit

    calls = []

    def fake_emit_factored(**plan):
        calls.append(plan)
        m = plan["out_size"]
        return (torch.zeros(m, dtype=torch.float64), torch.full((m,), -1),
                torch.full((m,), -1))

    def no_plain(*args, **kwargs):
        raise AssertionError("comp_sub_factored called the plain emission")

    monkeypatch.setattr(emit, "emit_factored", fake_emit_factored)
    monkeypatch.setattr(emit, "emit_plain", no_plain)
    monkeypatch.setattr(emit, "emit_factored_plain", no_plain)
    values, ndiv, fa, fb, kill_b0 = factored_inputs(30, 400, 4, 5, True)
    out = tc.comp_sub_factored(torch.as_tensor(values), torch.as_tensor(ndiv),
                               torch.as_tensor(fa).float(), torch.as_tensor(fb).float(),
                               600, 0.25, 800, kill_b0=kill_b0)
    assert len(calls) == 1 and out[0].shape == (800,)
    plan = calls[0]
    assert plan["kill_b0"] is kill_b0
    assert plan["fa"].shape == (400, 4) and plan["fb"].shape == (400, 5)
    assert "w_sub" not in plan
