"""The port's frisys and subspace drivers on five-word determinants (W = 5,
a synthetic 65-orbital system: 130 bits, the top word alone in its 64-bit
limb) against the reference package, each side fed the same draws: the
HB-PP spawner (unnormalized and pivotal), two systematic frisys steps and
subspace steps across a restart; and a W = 7 reference arena carried into
the port by ``convert`` and back.  Keys, counts and flags exact; values at
rtol 1e-12 (spawner) and 1e-10 (steps).  The H-trial vector's keys are
compared as a set, as at W = 4 (tests/test_torch_wide_steps.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fries_tpu import dets as jd  # noqa: E402
from fries_tpu.drivers import frisys as jfs, subspace as jsub  # noqa: E402
from fries_tpu.ops import heat_bath as jhb, molecule as jmol  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import convert  # noqa: E402
from fries_tpu_torch.drivers import frisys as tfs, subspace as tsub  # noqa: E402
from fries_tpu_torch.ops import heat_bath as thb, molecule as tmol  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402
from test_torch_wide_steps import (EST, as_map, assert_arena, assert_estimator_vectors,  # noqa: E402
                                   assert_metrics, port_arena, system)
from test_torch_wider_keys import wider_rows  # noqa: E402

W = 5


@pytest.fixture(scope="module")
def w5():
    j, t = system(65, 4, 5)
    assert t.n_words == W and j.n_words == W
    return j, t


def hf_arena(j, capacity, n_keys, seed):
    """A reference arena of HF and its excitations with random values."""
    hfw, hfo, _ = jmol.hf_reference(j)
    tmpl = jmol.ExcitationTemplate.build(j.n_orb, j.n_elec)
    ew, ea, _ = jmol.exact_offdiag_batch(j, tmpl, hfw[None], hfo[None], jnp.ones(1), 1.0)
    ew, ea = np.asarray(ew.reshape(-1, W)), np.asarray(ea.reshape(-1))
    keys = np.unique(np.concatenate([np.asarray(hfw)[None], ew[ea != 0]]), axis=0)[:n_keys]
    vals = np.random.default_rng(seed).standard_normal(len(keys))
    return jar.from_unsorted(jar.make(capacity, W, 1), jnp.asarray(keys), jnp.asarray(vals)[None])


@pytest.mark.parametrize("variant", ["unnorm", "pivotal"])
def test_spawner_matches_reference_w5(w5, variant):
    j, t = w5
    cfg = dict(eps=0.01, vec_nonz=300, matr_samp=2000, capacity=512, spawn_cap=2600,
               unnorm=variant == "unnorm", pivotal=variant == "pivotal")
    jsi, tsi = jmol.SymmInfo.build(np.asarray(j.symm)), tmol.SymmInfo.build(t.symm.numpy())
    p_doub = jfs.hf_p_doub(j, jsi)
    js = jfs.make_hbpp_spawner(j, jhb.setup(j), jsi, p_doub, jfs.FrisysConfig(**cfg), 0.0)
    ts = tfs.make_hbpp_spawner(t, thb.setup(t), tsi, p_doub, tfs.FrisysConfig(**cfg), 0.0)
    a = hf_arena(j, 512, 300, 0)
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
    np.testing.assert_allclose(tamp.numpy(), np.asarray(jamp), rtol=1e-12, atol=1e-15)


def test_frisys_steps_match_reference_w5(w5):
    """Two systematic steps, each from the reference's state and fed its
    draws."""
    j, t = w5
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


def test_subspace_steps_across_restart_w5(w5):
    """HF and a single (1 -> 5, one irrep): two steps from the reference's
    state, a restart between them."""
    j, t = w5
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
        got = as_map(taux["htrial_keys"][row].reshape(-1, W), taux["htrial_vals"][row])
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


def test_seven_word_arena_round_trips():
    """A W = 7 reference arena (two value rows) into the port's arena, the
    power and subspace states, and back: keys, values and counts equal; the
    port's lookups find every row at its reference position."""
    rng = np.random.default_rng(70)
    keys = np.unique(wider_rows(rng, 200, 7), axis=0)
    vals = rng.standard_normal((2, len(keys)))
    ja = jar.from_unsorted(jar.make(256, 7, 2), jnp.asarray(keys), jnp.asarray(vals))
    ta = convert.arena(np.asarray(ja.keys), np.asarray(ja.vals), np.asarray(ja.n_used))
    assert ta.keys.shape == (256, 7) and ta.n_vecs == 2
    back = convert.arena_to_numpy(ta)
    np.testing.assert_array_equal(back[0], np.asarray(ja.keys))
    np.testing.assert_array_equal(back[1], np.asarray(ja.vals))
    assert back[2] == int(ja.n_used[0])
    st = convert.power_state(ta, 0.25, 3.5, 7)
    assert st.arena is ta and st.iterat == 7 and float(st.en_shift) == 0.25
    sub = convert.subspace_state(ta, [1.0, 2.0], [3.0, 4.0], 9, key=None)
    np.testing.assert_array_equal(sub.norm_factors.numpy(), [1.0, 2.0])
    from fries_tpu_torch.runtime import arena as tar
    pos, found = tar.lookup(ta, torch.as_tensor(keys.astype(np.int64)))
    jpos, jfound = jar.lookup(ja, jnp.asarray(keys))
    assert found.all() and np.asarray(jfound).all()
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def test_ne2_qz_configuration(monkeypatch):
    """``ne2_qz``: Ne2 at 5.84 a0 in cc-pVQZ (110 spherical functions from
    the in-repo table), both 1s frozen: 108 orbitals, 16 electrons, seven
    words; ``ne_qz``'s configuration and bench.py's subsp one unchanged.
    The build is captured, not run (it is a card-sized system)."""
    from fries_tpu_torch import basis, rung, scf
    from fries_tpu_torch.ops import molecule as mol

    z, shells = basis.get_shells("cc-pvqz", "Ne")
    n_ao = 2 * sum(2 * l + 1 for l, _ in shells)
    assert (z, n_ao) == (10, 110)
    seen = {}

    def capture(symbols, centers, basis="cc-pvdz", n_frozen=0, device="cuda", **kw):
        seen.update(symbols=symbols, centers=np.asarray(centers), basis=basis,
                    n_frozen=n_frozen, device=device)
        n_orb = n_ao - n_frozen // 2
        return mol.MolecularHamiltonian(hcore=torch.zeros(n_ao, n_ao),
                                        eris=torch.zeros((1,) * 4), symm=torch.zeros(n_ao),
                                        n_orb=n_orb, n_elec=2 * z - n_frozen,
                                        n_frozen=n_frozen), {}

    monkeypatch.setattr(scf, "build_molecule", capture)
    ham, _ = rung.ne2_qz_molecule("cpu")
    assert seen["symbols"] == ("Ne", "Ne") and seen["basis"] == "cc-pvqz"
    assert seen["n_frozen"] == 4 and seen["device"] == "cpu"
    np.testing.assert_allclose(np.linalg.norm(seen["centers"][1] - seen["centers"][0]), 5.84)
    assert abs(5.84 * 0.529177210903 - 3.09) < 0.005          # Angstrom
    assert (ham.n_orb, ham.n_elec, ham.n_words) == (108, 16, 7)
    assert rung.ne_qz_config() == tfs.FrisysConfig(
        eps=1e-3, vec_nonz=500_000, matr_samp=500_000, capacity=1 << 20,
        spawn_cap=532_768, init_thresh=1.0, target_norm=1e6)
