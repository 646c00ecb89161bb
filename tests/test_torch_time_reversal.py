"""The port's time-reversal (spin-flip) folding against the reference
package: flip_spins, det_less, canonicalize, adjust_exact, adjust_sampled,
tr_diag and fold_vector_host on the same numpy inputs (keys exact, values at
rtol 1e-12), the folded operator built from adjust_exact + tr_diag against
the dense spin-flip-symmetrized Hamiltonian block, the frisys spawner with
``spin_parity`` fed the reference's six uniforms, and frisys power steps in
the even sector from the reference's converted state (values at 1e-10)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dense_fci  # noqa: E402
from fries_tpu import dets as jd, synth as jsynth  # noqa: E402
from fries_tpu.drivers import frisys as jfs  # noqa: E402
from fries_tpu.ops import heat_bath as jhb  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu.ops import time_reversal as jtr  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import convert, dets as td  # noqa: E402
from fries_tpu_torch.drivers import frisys as tfs  # noqa: E402
from fries_tpu_torch.ops import heat_bath as thb  # noqa: E402
from fries_tpu_torch.ops import molecule as tmol  # noqa: E402
from fries_tpu_torch.ops import time_reversal as ttr  # noqa: E402

SYMM = np.array([0, 1, 0, 1, 0, 1, 2, 3])


def t64(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def system(n_orb=8, n_elec=4, symm=SYMM, seed=3):
    j = jsynth.make_system(n_orb, n_elec, symm=symm, seed=seed)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), np.asarray(j.symm),
                            n_orb, n_elec)
    return j, t


def random_dets(rng, n, n_orb, n_elec):
    """(n, W) uint32 words of random MS = 0 determinants."""
    bits = np.zeros((n, 2 * n_orb), bool)
    for row in bits:
        row[rng.choice(n_orb, n_elec // 2, replace=False)] = True
        row[n_orb + rng.choice(n_orb, n_elec // 2, replace=False)] = True
    return np.array(jd.pack_bits(jnp.asarray(bits)))


@pytest.mark.parametrize("n_orb", [8, 20])
def test_flip_spins_and_det_less(n_orb):
    """One- and two-word determinants; det_less orders as pack_key does."""
    rng = np.random.default_rng(n_orb)
    a, b = random_dets(rng, 200, n_orb, 4), random_dets(rng, 200, n_orb, 4)
    b[:20] = a[:20]
    n_bits = 2 * n_orb
    np.testing.assert_array_equal(
        td.flip_spins(t64(a), n_orb, n_bits).numpy(),
        np.asarray(jd.flip_spins(jnp.asarray(a), n_orb, n_bits)).astype(np.int64))
    bits = rng.random((50, n_bits + 3)) < 0.5
    np.testing.assert_array_equal(
        td.flip_spins_bits(torch.as_tensor(bits), n_orb).numpy(),
        np.asarray(jd.flip_spins_bits(jnp.asarray(bits), n_orb)))
    less = np.asarray(jd.det_less(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(td.det_less(t64(a), t64(b)).numpy(), less)
    np.testing.assert_array_equal((td.pack_key(t64(a)) < td.pack_key(t64(b))).numpy(), less)
    assert less.any() and not less.all() and not less[:20].any()


@pytest.mark.parametrize("parity", [1, -1])
def test_canonicalize_and_tr_diag(parity):
    j, t = system()
    keys = random_dets(np.random.default_rng(1), 300, 8, 4)
    jc, jf, js = jtr.canonicalize(j, jnp.asarray(keys), parity)
    tc, tf, ts = ttr.canonicalize(t, t64(keys), parity)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.asarray(js).any() and (np.asarray(jf) == parity).any()
    jocc = jd.occ_list(jnp.asarray(keys), 16, 4)
    jdelta, jforbid = jtr.tr_diag(j, jnp.asarray(keys), jocc, parity)
    tdelta, tforbid = ttr.tr_diag(t, t64(keys), td.occ_list(t64(keys), 16, 4), parity)
    np.testing.assert_allclose(tdelta.numpy(), np.asarray(jdelta), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tforbid.numpy(), np.asarray(jforbid))
    assert (np.asarray(jdelta) != 0).sum() > 10
    assert np.asarray(jforbid).any() == (parity == -1)


def exact_spawns(j, keys, vals, h_fac):
    """The reference's exact spawn stream of ``keys``: (parents, parent occ,
    targets, amplitudes, scale), flat."""
    jk = jnp.asarray(keys)
    occ = jd.occ_list(jk, j.n_bits, j.n_elec)
    tmpl = jmol.ExcitationTemplate.build(j.n_orb, j.n_elec)
    w, amp, _ = jmol.exact_offdiag_batch(j, tmpl, jk, occ, jnp.asarray(vals), h_fac)
    nc = amp.shape[1]
    return (jnp.repeat(jk, nc, axis=0), jnp.repeat(occ, nc, axis=0),
            w.reshape(-1, j.n_words), amp.reshape(-1), jnp.repeat(jnp.asarray(vals), nc) * h_fac)


@pytest.mark.parametrize("parity", [1, -1])
def test_adjust_exact_matches_reference(parity):
    j, t = system()
    rng = np.random.default_rng(2)
    keys = np.unique(random_dets(rng, 40, 8, 4), axis=0)
    vals = rng.standard_normal(len(keys))
    par, pocc, new, amp, scale = exact_spawns(j, keys, vals, -0.03)
    jw, ja = jtr.adjust_exact(j, par, pocc, new, amp, parity, scale=scale)
    tw, ta = ttr.adjust_exact(t, t64(par), t64(pocc), t64(new), torch.tensor(np.asarray(amp)),
                              parity, scale=torch.tensor(np.asarray(scale)))
    live = np.asarray(amp) != 0
    assert live.sum() > 500
    np.testing.assert_array_equal(tw.numpy()[live], np.asarray(jw).astype(np.int64)[live])
    np.testing.assert_allclose(ta.numpy()[live], np.asarray(ja)[live], rtol=1e-12, atol=1e-15)
    # without a scale the bare elements fold
    bare = np.where(live, 1.0, 0.0) * np.asarray(amp) / np.where(live, np.asarray(scale), 1.0)
    _, ja1 = jtr.adjust_exact(j, par, pocc, new, jnp.asarray(bare), parity)
    _, ta1 = ttr.adjust_exact(t, t64(par), t64(pocc), t64(new), torch.tensor(bare), parity)
    np.testing.assert_allclose(ta1.numpy()[live], np.asarray(ja1)[live], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("unnorm", [False, True])
@pytest.mark.parametrize("parity", [1, -1])
def test_adjust_sampled_matches_reference(parity, unnorm):
    """Every exact excitation of a few determinants taken as a sampled one,
    with random selection weights."""
    j, t = system()
    rng = np.random.default_rng(3)
    keys = np.unique(random_dets(rng, 12, 8, 4), axis=0)
    par, pocc, new, amp, _ = exact_spawns(j, keys, np.ones(len(keys)), 1.0)
    live = np.asarray(amp) != 0
    par, pocc, new, mel = (np.asarray(x)[live] for x in (par, pocc, new, amp))
    sel_w = rng.random(len(mel)) + 0.1
    jsi = jmol.SymmInfo.build(np.asarray(j.symm))
    tsi = tmol.SymmInfo.build(t.symm.numpy())
    jtens, ttens = jhb.setup(j), thb.setup(t)
    p_doub = jfs.hf_p_doub(j, jsi)
    jsymm = jnp.asarray(jsi.symm)
    jcounts = jhb.unocc_symm_counts(8, 4, jsymm, jnp.asarray(jsi.counts), jnp.asarray(pocc))
    _, jn_alw = jhb.sing_allowed(8, 4, jsymm, jcounts, jnp.asarray(pocc))
    jbits = jd.unpack_bits(jnp.asarray(par), 16)
    jout = jtr.adjust_sampled(j, jtens, jsymm, jcounts, jn_alw, jnp.asarray(par),
                              jnp.asarray(pocc), jbits, jnp.asarray(new), jnp.asarray(mel),
                              jnp.asarray(sel_w), parity, p_doub, unnorm)
    tsymm = torch.as_tensor(tsi.symm)
    tcounts = thb.unocc_symm_counts(8, 4, tsymm, torch.as_tensor(tsi.counts), t64(pocc))
    _, tn_alw = thb.sing_allowed(8, 4, tsymm, tcounts, t64(pocc))
    tout = ttr.adjust_sampled(t, ttens, tsymm, tcounts, tn_alw, t64(par), t64(pocc),
                              td.unpack_bits(t64(par), 16), t64(new), torch.tensor(mel),
                              torch.tensor(sel_w), parity, p_doub, unnorm)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]).astype(np.int64))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert len(mel) > 200 and not np.asarray(jout[3]).all()


@pytest.mark.parametrize("parity", [1, -1])
def test_fold_vector_host_matches_reference(parity):
    j, t = system()
    rng = np.random.default_rng(4)
    keys = random_dets(rng, 120, 8, 4)          # duplicates and conjugate pairs
    keys[60:90] = np.asarray(jtr.flip(j, jnp.asarray(keys[:30])))
    vals = rng.standard_normal(120)
    vals[::7] = 0.0
    jk, jv = jtr.fold_vector_host(j, keys, vals, parity)
    tk, tv = ttr.fold_vector_host(t, keys, vals, parity)
    np.testing.assert_array_equal(tk, jk.astype(np.int64))
    np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)
    ek, ev = ttr.fold_vector_host(t, keys[:3], np.zeros(3), parity)
    assert ek.shape == (0, 1) and ev.shape == (0,)


def flip_mask(mask, n_orb):
    return (mask >> n_orb) | ((mask & ((1 << n_orb) - 1)) << n_orb)


def folded_dense(dense_h, basis, n_orb, parity):
    """The spin-flip-symmetrized dense block and its canonical basis."""
    index = {m: i for i, m in enumerate(basis)}
    canon = [m for m in basis if m < flip_mask(m, n_orb)
             or (m == flip_mask(m, n_orb) and parity == 1)]
    cols = []
    for m in canon:
        fm = flip_mask(m, n_orb)
        v = np.zeros(len(basis))
        if m == fm:
            v[index[m]] = 1.0
        else:
            v[index[m]] = 1 / np.sqrt(2)
            v[index[fm]] += parity / np.sqrt(2)
        cols.append(v)
    p_mat = np.stack(cols, axis=1)
    return p_mat.T @ dense_h @ p_mat, canon


@pytest.mark.parametrize("parity", [1, -1])
def test_folded_operator_matches_dense(parity):
    """Exact spawns through adjust_exact (non-unit amplitudes and h_fac
    exercise the scale) accumulate to the folded off-diagonal block; the bare
    diagonal plus tr_diag's delta is its diagonal."""
    rng = np.random.default_rng(51)
    n_orb, n_elec = 4, 4
    h, eris = dense_fci.random_integrals(rng, n_orb)
    ham = convert.hamiltonian(h, eris, np.zeros(n_orb), n_orb, n_elec)
    dense_h, basis = dense_fci.build_hamiltonian(h, eris, n_orb, 2, 2)
    h_fold, canon = folded_dense(dense_h, basis, n_orb, parity)
    index = {m: i for i, m in enumerate(canon)}
    words = t64(np.stack([dense_fci.mask_to_words(m, ham.n_bits) for m in canon]))
    occ = td.occ_list(words, ham.n_bits, n_elec)
    tmpl = tmol.ExcitationTemplate.build(n_orb, n_elec)
    v_in = torch.tensor(1.0 + 0.1 * np.arange(len(canon)))
    h_fac = -0.05
    nw, amps = tmol.exact_offdiag_batch(ham, tmpl, words, occ, v_in, h_fac)
    nc = amps.shape[1]
    tgt, adj = ttr.adjust_exact(
        ham, words.repeat_interleave(nc, 0), occ.repeat_interleave(nc, 0),
        nw.reshape(-1, ham.n_words), amps.reshape(-1), parity,
        scale=v_in.repeat_interleave(nc) * h_fac)
    adj = (adj / v_in.repeat_interleave(nc) / h_fac).numpy()
    got = np.zeros_like(h_fold)
    for i in np.nonzero((adj != 0) & (amps.reshape(-1).numpy() != 0))[0]:
        got[index[int(tgt[i, 0])], i // nc] += adj[i]
    np.testing.assert_allclose(got, h_fold - np.diag(np.diag(h_fold)), rtol=1e-9, atol=1e-10)
    delta, forbid = ttr.tr_diag(ham, words, occ, parity)
    assert not bool(forbid.any())
    np.testing.assert_allclose((tmol.diag_matrel(ham, occ) + delta).numpy(), np.diag(h_fold),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("parity,unnorm", [(1, False), (-1, False), (1, True)])
def test_spin_parity_spawner_matches_reference(parity, unnorm):
    """The sampled excitations folded onto the symmetrized basis, from a
    vector on canonical representatives (no self-conjugate ones in the odd
    sector)."""
    j, t = system()
    cfg = dict(eps=0.02, vec_nonz=60, matr_samp=150, capacity=64, spawn_cap=200,
               unnorm=unnorm, spin_parity=parity, init_thresh=0.3)
    jsi, tsi = jmol.SymmInfo.build(np.asarray(j.symm)), tmol.SymmInfo.build(t.symm.numpy())
    p_doub = jfs.hf_p_doub(j, jsi)
    js = jfs.make_hbpp_spawner(j, jhb.setup(j), jsi, p_doub, jfs.FrisysConfig(**cfg), 0.0)
    ts = tfs.make_hbpp_spawner(t, thb.setup(t), tsi, p_doub, tfs.FrisysConfig(**cfg), 0.0)
    rng = np.random.default_rng(7)
    keys = random_dets(rng, 60, 8, 4)
    canon, _, self_conj = jtr.canonicalize(j, jnp.asarray(keys), parity)
    keys = np.unique(np.asarray(canon)[~np.asarray(self_conj) | (parity == 1)], axis=0)[:40]
    vals = rng.standard_normal(len(keys))
    a = jar.from_unsorted(jar.make(64, 1, 1), jnp.asarray(keys), jnp.asarray(vals)[None])
    avals = jnp.where(a.valid, a.vals[0], 0.0)
    key = jax.random.key(5)
    jw, jamp, jini = jax.jit(js)(a.keys, avals, -0.02, key)
    rns = torch.tensor(np.asarray(jax.random.uniform(key, (6,), dtype=jnp.float64)))
    tw, tamp, tini = ts(t64(a.keys), torch.tensor(np.asarray(avals)), -0.02, rns)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tini.numpy(), np.asarray(jini))
    np.testing.assert_allclose(tamp.numpy(), np.asarray(jamp), rtol=1e-12, atol=1e-15)
    live = tamp != 0
    assert int(live.sum()) > 50
    # every target is a canonical representative
    assert not bool(td.det_less(ttr.flip(t, tw[live]), tw[live]).any())


def test_frisys_spin_parity_steps_match_reference():
    """Five frisys steps in the even sector (folded spawner and diagonal),
    each from the reference's state converted to the port and fed the
    reference's draws."""
    j, t = system()
    cfg = dict(eps=0.02, vec_nonz=60, matr_samp=150, capacity=256, spawn_cap=200,
               target_norm=110.0, shift_interval=2, spin_parity=1)
    jstep, _, jstate, jaux = jfs.build(j, jfs.FrisysConfig(**cfg), seed=4)
    tstep, _, _, taux = tfs.build(t, tfs.FrisysConfig(**cfg), seed=4)
    est = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")
    jargs, targs = [jaux[k] for k in est], [taux[k] for k in est]
    for _ in range(25):
        jstate, _ = jstep(jstate, *jargs)
    for _ in range(5):
        a = jstate.arena
        tstate = convert.power_state(
            convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used)),
            jstate.en_shift, jstate.last_norm, jstate.iterat)
        key_spawn, key_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
        rns = np.asarray(jax.random.uniform(key_spawn, (6,), dtype=jnp.float64))
        rn = float(jax.random.uniform(key_vec, dtype=jnp.float64))
        jstate, jm = jstep(jstate, *jargs)
        tstate, tm = tstep(tstate, *targs, rns=rns, rn_vec=rn)
        ja = jstate.arena
        np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                      np.asarray(ja.keys).astype(np.int64))
        np.testing.assert_allclose(tstate.arena.vals.numpy(), np.asarray(ja.vals),
                                   rtol=1e-10, atol=1e-12)
        for k, v in jm.items():
            if np.asarray(v).dtype.kind == "f":
                np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-10, err_msg=k)
            else:
                assert int(tm[k]) == int(v), k
    live = tstate.arena.valid
    assert int(jm["n_dets"]) > 30 and float(jm["shift"]) != 0.0
    assert not bool(td.det_less(ttr.flip(t, tstate.arena.keys[live]),
                                tstate.arena.keys[live]).any())
