"""The port's frisys and subspace drivers on four-word determinants (W = 4,
50 orbitals) against the reference package, each side fed the same draws:
the HB-PP spawner (unnormalized and pivotal), two frisys steps (systematic
HB-PP, the normalized weights) and one subspace step on each side of a
restart.  Keys, counts and flags exact; values at rtol 1e-12 (spawner) and
1e-10 (steps).  The H-trial vector's keys are compared as a set: the
reference keeps a wide one in order of first appearance, the port in the
arena's order."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fries_tpu import synth as jsynth  # noqa: E402
from fries_tpu import dets as jd  # noqa: E402
from fries_tpu.drivers import frisys as jfs, subspace as jsub  # noqa: E402
from fries_tpu.ops import heat_bath as jhb, molecule as jmol  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import convert  # noqa: E402
from fries_tpu_torch.drivers import frisys as tfs, subspace as tsub  # noqa: E402
from fries_tpu_torch.ops import heat_bath as thb, molecule as tmol  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402

EST = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")


def system(n_orb, n_elec, seed):
    symm = np.arange(n_orb) % 4
    j = jsynth.make_system(n_orb, n_elec, symm=symm, seed=seed, scale_two=0.1)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), symm, n_orb, n_elec)
    return j, t


@pytest.fixture(scope="module")
def w4():
    j, t = system(50, 4, 3)
    assert t.n_words == 4
    return j, t


def port_arena(a):
    return convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used))


def assert_arena(ta, ja, rtol=1e-10):
    np.testing.assert_array_equal(ta.keys.numpy(), np.asarray(ja.keys).astype(np.int64))
    np.testing.assert_allclose(ta.vals.numpy(), np.asarray(ja.vals), rtol=rtol, atol=1e-12)
    assert int(ta.n_used[0]) == int(np.asarray(ja.n_used).reshape(-1)[0])


def assert_metrics(tm, jm, exact=("n_dets", "nkept", "n_ini", "nnonz", "sgn_coh", "overflow")):
    assert set(tm) >= set(jm)
    for k, v in jm.items():
        v = np.asarray(v).reshape(-1)[0]
        if k in exact or v.dtype.kind != "f":
            assert int(tm[k]) == int(v), k
        else:
            np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-10, err_msg=k)


def as_map(keys, vals):
    return {tuple(k): float(v) for k, v in zip(np.asarray(keys).astype(np.int64).tolist(),
                                                np.asarray(vals)) if v != 0}


def assert_estimator_vectors(taux, jaux):
    for k in ("den_keys", "ref_key"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]).astype(np.int64))
    got, want = as_map(taux["num_keys"], taux["num_vals"]), as_map(jaux["num_keys"],
                                                                  jaux["num_vals"])
    assert set(got) == set(want)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("variant", ["unnorm", "pivotal"])
def test_spawner_matches_reference_w4(w4, variant):
    j, t = w4
    cfg = dict(eps=0.01, vec_nonz=300, matr_samp=2000, capacity=512, spawn_cap=2600,
               unnorm=variant == "unnorm", pivotal=variant == "pivotal")
    jsi, tsi = jmol.SymmInfo.build(np.asarray(j.symm)), tmol.SymmInfo.build(t.symm.numpy())
    p_doub = jfs.hf_p_doub(j, jsi)
    js = jfs.make_hbpp_spawner(j, jhb.setup(j), jsi, p_doub, jfs.FrisysConfig(**cfg), 0.0)
    ts = tfs.make_hbpp_spawner(t, thb.setup(t), tsi, p_doub, tfs.FrisysConfig(**cfg), 0.0)
    # an arena of HF and its excitations with random values
    hfw, hfo, _ = jmol.hf_reference(j)
    tmpl = jmol.ExcitationTemplate.build(j.n_orb, j.n_elec)
    ew, ea, _ = jmol.exact_offdiag_batch(j, tmpl, hfw[None], hfo[None], jnp.ones(1), 1.0)
    ew, ea = np.asarray(ew.reshape(-1, 4)), np.asarray(ea.reshape(-1))
    keys = np.unique(np.concatenate([np.asarray(hfw)[None], ew[ea != 0]]), axis=0)[:300]
    vals = np.random.default_rng(0).standard_normal(len(keys))
    a = jar.from_unsorted(jar.make(512, 4, 1), jnp.asarray(keys), jnp.asarray(vals)[None])
    avals = jnp.where(a.valid, a.vals[0], 0.0)
    key = jax.random.key(5)
    jw, jamp, jini = jax.jit(js)(a.keys, avals, -0.01, key, thresh=jnp.asarray(0.3))
    rand = (JaxKeys(key) if variant == "pivotal"
            else torch.tensor(np.asarray(jax.random.uniform(key, (6,), dtype=jnp.float64))))
    tw, tamp, tini = ts(torch.as_tensor(np.asarray(a.keys).astype(np.int64)),
                        torch.tensor(np.asarray(avals)), -0.01, rand,
                        thresh=torch.tensor(0.3, dtype=torch.float64))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tini.numpy(), np.asarray(jini))
    assert (np.asarray(jamp) != 0).sum() > 1000
    # spawners write full all-ones rows where nothing was spawned
    dead = np.asarray(jamp) == 0
    assert (tw.numpy()[dead] == 0xFFFFFFFF).all()
    np.testing.assert_allclose(tamp.numpy(), np.asarray(jamp), rtol=1e-12, atol=1e-15)


def test_frisys_steps_match_reference_w4(w4):
    """Two steps, each from the reference's state and fed its draws."""
    j, t = w4
    cfg = dict(eps=0.01, vec_nonz=400, matr_samp=2000, capacity=4096, spawn_cap=3000,
               target_norm=2000.0, shift_interval=2)
    jstep, _, jstate, jaux = jfs.build(j, jfs.FrisysConfig(**cfg), seed=4)
    tstep, _, _, taux = tfs.build(t, tfs.FrisysConfig(**cfg), seed=4)
    assert_estimator_vectors(taux, jaux)
    jargs, targs = [jaux[k] for k in EST], [taux[k] for k in EST]
    for _ in range(3):
        jstate, _ = jstep(jstate, *jargs)
    for _ in range(2):
        tstate = convert.power_state(port_arena(jstate.arena), jstate.en_shift,
                                     jstate.last_norm, jstate.iterat)
        key_spawn, key_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
        rns = np.asarray(jax.random.uniform(key_spawn, (6,), dtype=jnp.float64))
        rn = float(jax.random.uniform(key_vec, dtype=jnp.float64))
        jstate, jm = jstep(jstate, *jargs)
        tstate, tm = tstep(tstate, *targs, rns=rns, rn_vec=rn)
        assert_arena(tstate.arena, jstate.arena)
        assert_metrics(tm, jm)
    assert int(tstate.arena.n_used[0]) > 1000 and not bool(jm["overflow"])


def test_subspace_steps_across_restart_w4(w4):
    """HF and a single (1 -> 5, one irrep): two steps from the reference's
    state, a restart between them."""
    j, t = w4
    hf, _, _ = jmol.hf_reference(j)
    d1, _ = jd.single_parity(hf[None], jnp.asarray([1]), jnp.asarray([5]))
    tk, tv = np.stack([np.asarray(hf)[None], np.asarray(d1)]), np.ones((2, 1))
    cfg = dict(eps=0.02, n_trial=2, vec_nonz=300, matr_samp=1500, capacity=4096,
               spawn_cap=2000, restart_int=2, shift_interval=2, compress_mode="sys",
               pivotal_h=False)
    jstep, _, jstate, jaux = jsub.build(j, jsub.SubspaceConfig(**cfg), jnp.asarray(tk),
                                        jnp.asarray(tv), seed=4)
    tstep, _, _, taux = tsub.build(t, tsub.SubspaceConfig(**cfg), tk, tv, seed=4)
    for row in range(2):
        got = as_map(taux["htrial_keys"][row].reshape(-1, 4), taux["htrial_vals"][row])
        want = as_map(np.asarray(jaux["htrial_keys"][row]), jaux["htrial_vals"][row])
        assert set(got) == set(want)
    jstate, _ = jstep(jstate)
    restarts = 0
    for _ in range(2):
        tstate = convert.subspace_state(port_arena(jstate.arena), jstate.norm_factors,
                                        jstate.last_norms, jstate.iterat, JaxKeys(jstate.key))
        restarts += (tstate.iterat + 1) % cfg["restart_int"] == 0
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate)
        assert_arena(tstate.arena, jstate.arena)
        for k in ("norm_factors", "last_norms"):
            np.testing.assert_allclose(getattr(tstate, k).numpy(),
                                       np.asarray(getattr(jstate, k)), rtol=1e-12)
        for k, v in jm.items():
            if np.asarray(v).dtype.kind == "f":
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(v), rtol=1e-10,
                                           atol=1e-14, err_msg=k)
            else:
                np.testing.assert_array_equal(tm[k].numpy().reshape(-1),
                                              np.asarray(v).reshape(-1), err_msg=k)
    assert restarts == 1
