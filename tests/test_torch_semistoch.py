"""The port's semistochastic frisys path against the reference package: the
dense deterministic block, the spawner with a deterministic space fed the
reference's six uniforms, power steps with protected keys from the
reference's converted state, the full-space case (exact whatever the draws),
a trial vector and an initial vector other than HF, and the shift's
tracking term.  Keys, counts and flags exact; the block's and the spawner's
amplitudes at rtol 1e-12, steps at 1e-10."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dense_fci  # noqa: E402
from fries_tpu import synth as jsynth  # noqa: E402
from fries_tpu.drivers import frisys as jfs  # noqa: E402
from fries_tpu.ops import heat_bath as jhb  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import cli, convert, dets as td, io as tio, rung  # noqa: E402
from fries_tpu_torch.drivers import frisys as tfs  # noqa: E402
from fries_tpu_torch.ops import heat_bath as thb  # noqa: E402
from fries_tpu_torch.ops import molecule as tmol  # noqa: E402

SYMM = np.array([0, 1, 0, 1, 0, 1, 2, 3])
EST = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")
CFG = dict(eps=0.02, vec_nonz=60, matr_samp=700, capacity=256, spawn_cap=400,
           target_norm=110.0, shift_interval=2)


def t64(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def system():
    j = jsynth.make_system(8, 4, symm=SYMM, seed=3)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), SYMM, 8, 4)
    return j, t


def determ_space(t, n):
    """HF and the n - 1 determinants of largest |((H - E_HF) HF)|, ties by
    key: (n, W) uint32 words."""
    hf = td.hf_det(t.n_orb, t.n_elec)
    hk, hv = tfs.compute_htrial(t, hf[None].numpy(), np.ones(1))
    packed = td.pack_key(torch.as_tensor(hk)).numpy()
    rest = packed != int(td.pack_key(hf))
    order = np.lexsort((packed[rest], -np.abs(hv[rest])))[: n - 1]
    return np.concatenate([hf[None].numpy(), hk[rest][order]]).astype(np.uint32)


def test_build_determ_block_matches_reference():
    j, t = system()
    dkeys = determ_space(t, 8)
    jb = jfs.build_determ_block(j, jnp.asarray(dkeys))
    tb = tfs.build_determ_block(t, dkeys)
    assert tb["n_elements"] == jb["n_elements"] > 100
    for k in ("keys", "words", "from"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]).astype(np.int64), k)
    np.testing.assert_allclose(tb["amp"].numpy(), np.asarray(jb["amp"]), rtol=1e-12, atol=0)
    assert (tb["amp"] != 0).all()


def test_determ_spawner_matches_reference():
    """Members carry no sampled spawn, the sampling budget is matr_samp less
    the block's elements, and the dense rows follow the sampled ones as
    initiators."""
    j, t = system()
    dkeys = determ_space(t, 8)
    jsi, tsi = jmol.SymmInfo.build(np.asarray(j.symm)), tmol.SymmInfo.build(t.symm.numpy())
    p_doub = jfs.hf_p_doub(j, jsi)
    cfg = dict(CFG, init_thresh=0.3)
    jb, tb = jfs.build_determ_block(j, jnp.asarray(dkeys)), tfs.build_determ_block(t, dkeys)
    js = jfs.make_hbpp_spawner(j, jhb.setup(j), jsi, p_doub, jfs.FrisysConfig(**cfg), 0.0,
                               determ=jb)
    ts = tfs.make_hbpp_spawner(t, thb.setup(t), tsi, p_doub, tfs.FrisysConfig(**cfg), 0.0,
                               determ=tb)
    hk, _ = tfs.compute_htrial(t, td.hf_det(8, 4)[None].numpy(), np.ones(1))
    keys = np.unique(np.concatenate([dkeys[:6], hk[:40].astype(np.uint32)]), axis=0)
    vals = np.random.default_rng(0).standard_normal(len(keys))
    a = jar.from_unsorted(jar.make(64, 1, 1), jnp.asarray(keys), jnp.asarray(vals)[None])
    avals = jnp.where(a.valid, a.vals[0], 0.0)
    key = jax.random.key(5)
    jw, jamp, jini = jax.jit(js)(a.keys, avals, -0.02, key)
    rns = torch.tensor(np.asarray(jax.random.uniform(key, (6,), dtype=jnp.float64)))
    tw, tamp, tini = ts(t64(a.keys), torch.tensor(np.asarray(avals)), -0.02, rns)
    n_el = tb["n_elements"]
    assert tw.shape[0] == CFG["spawn_cap"] + n_el
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tini.numpy(), np.asarray(jini))
    np.testing.assert_allclose(tamp.numpy(), np.asarray(jamp), rtol=1e-12, atol=1e-15)
    assert tini[-n_el:].all() and 0 < int(tini[:-n_el].sum()) < CFG["spawn_cap"]
    assert (tamp[-n_el:] != 0).sum() > 50 and (tamp[:-n_el] != 0).sum() > 50
    with pytest.raises(ValueError, match="matr_samp"):
        tfs.make_hbpp_spawner(t, thb.setup(t), tsi, p_doub,
                              tfs.FrisysConfig(**dict(cfg, matr_samp=n_el)), 0.0, determ=tb)


def compare_steps(jstep, jstate, jaux, tstep, taux, n_warm, n_steps, protected=False):
    """``n_steps`` steps, each from the reference's state converted to the
    port and fed the reference's draws."""
    jargs = [jaux[k] for k in EST]
    targs = [taux[k] for k in EST]
    jprot = (jaux["protected_keys"],) if protected else ()
    tprot = dict(protected_keys=taux["protected_keys"]) if protected else {}
    for _ in range(n_warm):
        jstate, _ = jstep(jstate, *jargs, *jprot)
    for _ in range(n_steps):
        a = jstate.arena
        tstate = convert.power_state(
            convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used)),
            jstate.en_shift, jstate.last_norm, jstate.iterat)
        key_spawn, key_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
        rns = np.asarray(jax.random.uniform(key_spawn, (6,), dtype=jnp.float64))
        rn = float(jax.random.uniform(key_vec, dtype=jnp.float64))
        jstate, jm = jstep(jstate, *jargs, *jprot)
        tstate, tm = tstep(tstate, *targs, rns=rns, rn_vec=rn, **tprot)
        ja = jstate.arena
        np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                      np.asarray(ja.keys).astype(np.int64))
        np.testing.assert_allclose(tstate.arena.vals.numpy(), np.asarray(ja.vals),
                                   rtol=1e-10, atol=1e-12)
        assert int(tstate.arena.n_used[0]) == int(ja.n_used[0])
        for k, v in jm.items():
            if np.asarray(v).dtype.kind == "f":
                np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-10, err_msg=k)
            else:
                assert int(tm[k]) == int(v), k
    return jstate, jm, tstate


def assert_aux_match(jaux, taux):
    assert taux["e_ref"] == float(jaux["e_ref"]) and taux["p_doub"] == jaux["p_doub"]
    for k in ("num_keys", "den_keys", "ref_key"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]).astype(np.int64))
    for k in ("num_vals", "den_vals"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-12)


def test_semistochastic_steps_match_reference():
    """Four steps with the deterministic space protected: its members live
    on with zero amplitude, keep their exact values through the compression
    and count in the norm."""
    j, t = system()
    dkeys = determ_space(t, 8)
    jstep, _, jstate, jaux = jfs.build(j, jfs.FrisysConfig(**CFG), seed=4,
                                       determ_keys=jnp.asarray(dkeys))
    tstep, _, tstate, taux = tfs.build(t, tfs.FrisysConfig(**CFG), seed=4, determ_keys=dkeys)
    assert_aux_match(jaux, taux)
    np.testing.assert_array_equal(taux["protected_keys"].numpy(), dkeys.astype(np.int64))
    np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                  np.asarray(jstate.arena.keys).astype(np.int64))
    np.testing.assert_array_equal(tstate.arena.vals.numpy(), np.asarray(jstate.arena.vals))
    assert int(tstate.arena.n_used[0]) == 8
    jstate, jm, tstate = compare_steps(jstep, jstate, jaux, tstep, taux, 20, 4, protected=True)
    pos, found = td.lookup_dets(tstate.arena.keys, taux["protected_keys"])
    assert bool(found.all()) and int(jm["n_dets"]) > 40 and float(jm["shift"]) != 0.0


def test_trial_init_vectors_and_shift_tracking_match_reference():
    """A trial vector and an initial vector other than HF, and the shift's
    tracking term, through build and four steps."""
    j, t = system()
    rng = np.random.default_rng(6)
    tkeys = determ_space(t, 10)
    tvals = rng.standard_normal(10) * 0.2
    tvals[0] = 1.0
    cfg = dict(CFG, matr_samp=150, spawn_cap=200, shift_tracking=0.5)
    jstep, _, jstate, jaux = jfs.build(j, jfs.FrisysConfig(**cfg), seed=4,
                                       trial=(tkeys, tvals), init_vec=(tkeys, 100 * tvals))
    tstep, _, tstate, taux = tfs.build(t, tfs.FrisysConfig(**cfg), seed=4,
                                       trial=(tkeys, tvals), init_vec=(tkeys, 100 * tvals))
    assert_aux_match(jaux, taux)
    assert taux["protected_keys"] is None and taux["den_keys"].shape[0] == 10
    np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                  np.asarray(jstate.arena.keys).astype(np.int64))
    np.testing.assert_array_equal(tstate.arena.vals.numpy(), np.asarray(jstate.arena.vals))
    jstate, _, _ = compare_steps(jstep, jstate, jaux, tstep, taux, 21, 1)
    # the controller is active, so the tracking term enters the next updates
    assert float(jstate.last_norm) != 0.0
    _, jm, _ = compare_steps(jstep, jstate, jaux, tstep, taux, 0, 4)
    assert float(jm["shift"]) != 0.0


def test_semistochastic_full_space_is_exact():
    """With the deterministic space covering the whole Hilbert space the
    iteration is an exact power method, whatever the draws."""
    rng = np.random.default_rng(11)
    h, eris = dense_fci.random_integrals(rng, 5)
    dense_h, basis = dense_fci.build_hamiltonian(h, eris, 5, 2, 2)
    e0, _ = dense_fci.ground_state(dense_h)
    ham = convert.hamiltonian(h, eris, np.zeros(5), 5, 4)
    all_keys = np.stack([dense_fci.mask_to_words(m, 10) for m in basis])
    n_el = tfs.build_determ_block(ham, all_keys)["n_elements"]
    cfg = tfs.FrisysConfig(eps=0.05, vec_nonz=128, matr_samp=n_el + 64, capacity=128,
                           spawn_cap=256)
    _, run_steps, state, aux = tfs.build(ham, cfg, seed=0, determ_keys=all_keys)
    _, traj = run_steps(state, *[aux[k] for k in EST], 400, aux["protected_keys"])
    assert not bool(traj["overflow"].any())
    e_est = float(traj["proj_num"][-1] / traj["proj_den"][-1])
    np.testing.assert_allclose(aux["e_ref"] + e_est, e0, atol=2e-4)


def test_trial_vector_energy_matches_dense_fci():
    """The trial-vector estimator from a truncated exact ground state, the
    run started from it (tests/test_frisys.py's case)."""
    rng = np.random.default_rng(11)
    h, eris = dense_fci.random_integrals(rng, 5)
    dense_h, basis = dense_fci.build_hamiltonian(h, eris, 5, 2, 2)
    e0, psi0 = dense_fci.ground_state(dense_h)
    ham = convert.hamiltonian(h, eris, np.zeros(5), 5, 4)
    top = np.argsort(-np.abs(psi0))[:10]
    tkeys = np.stack([dense_fci.mask_to_words(basis[i], 10) for i in top])
    cfg = tfs.FrisysConfig(eps=0.05, vec_nonz=50, matr_samp=150, capacity=128,
                           spawn_cap=512, target_norm=300.0)
    _, run_steps, state, aux = tfs.build(ham, cfg, seed=9, trial=(tkeys, psi0[top]),
                                         init_vec=(tkeys, 100 * psi0[top]))
    _, traj = run_steps(state, *[aux[k] for k in EST], 700)
    assert not bool(traj["overflow"].any())
    num, den = traj["proj_num"][200:].numpy(), traj["proj_den"][200:].numpy()
    e_est = aux["e_ref"] + num.sum() / den.sum()
    bm = np.array([b.sum() / d.sum() for b, d in zip(np.array_split(num, 10),
                                                       np.array_split(den, 10))])
    sigma = bm.std() / np.sqrt(len(bm))
    assert abs(e_est - e0) < max(5 * sigma, 0.02), (e_est, e0, sigma)


def test_cli_frisys_mol_det_space_trial_and_ini_vec(tmp_path):
    """frisys_mol with --det_space, --trial_vec and --ini_vec from files the
    test writes: the reference's output streams, the members of the
    deterministic space alive in every step's count."""
    _, t = system()
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump, point_group="D2h")
    dkeys = determ_space(t, 6)
    with open(tmp_path / "det_space.txt", "w") as f:
        for row in dkeys:
            f.write(f"{int(row[0])}\n")
    np.testing.assert_array_equal(tio.read_dets(tmp_path / "det_space.txt", 16), dkeys)
    vals = np.array([1.0, 0.2, -0.1, 0.05, 0.3, -0.2])
    tio.save_vec_txt(tmp_path / "trial", dkeys, vals, 16)
    tio.save_vec_txt(tmp_path / "ini", dkeys, 50 * vals, 16)
    n_el = tfs.build_determ_block(t, dkeys)["n_elements"]
    out = tmp_path / "run"
    argv = ["frisys_mol", "--fcidump_path", str(fcidump), "--point_group", "D2h",
            "--epsilon", "0.02", "--vec_nonz", "40", "--mat_nonz", str(n_el + 100),
            "--max_dets", "256", "--max_iter", "20", "--save_interval", "10",
            "--target", "200", "--result_dir", str(out), "--seed", "3",
            "--det_space", str(tmp_path / "det_space.txt"),
            "--trial_vec", str(tmp_path / "trial"), "--ini_vec", str(tmp_path / "ini")]
    cli.main(argv + ["--device", "cpu"])
    for name in cli._STREAMS.values():
        assert np.loadtxt(out / name).shape == (20,), name
    assert (np.loadtxt(out / "N.txt") >= 6).all()
    np.testing.assert_allclose(np.loadtxt(out / "projden.txt")[0] / 50, (vals ** 2).sum(),
                               rtol=0.2)
    assert len((out / "arena_occ.txt").read_text().splitlines()) == 2
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(argv)


def test_rung_semistoch_is_the_rung_plus_a_deterministic_space():
    """The semistoch configuration is the 1e6 rung's (rung.config, held to
    bench.py by test_rung_is_bench_ladder_1e6) plus a space of at most 150
    determinants, the published semistochastic flagship's count; the space is
    HF and the largest |((H - E_HF) HF)|, the same in both packages, cut to
    the largest prefix whose block leaves the share of the budget asked for."""
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "BASELINE.md")) as f:
        assert "| N2 eq cc-pVDZ | 3M | 150 largest CISD |" in f.read()
    assert rung.N_DETERM == 150 and rung.DETERM_MAX_SHARE == 0.7
    j, t = system()
    space = rung.determ_space(t, 12)
    np.testing.assert_array_equal(space, determ_space(t, 12).astype(np.int64))
    np.testing.assert_array_equal(space[0], td.hf_det(8, 4).numpy())
    # the reference's H * HF gives the same space
    hk, hv = jfs.compute_htrial(j, space[:1].astype(np.uint32), np.ones(1))
    mags = dict(zip(hk[:, 0].tolist(), np.abs(hv)))
    got = [mags[int(k)] for k in space[1:, 0]]
    assert got == sorted(got, reverse=True)
    assert min(got) >= max(v for k, v in mags.items() if k not in set(space[:, 0].tolist()))
    # the cut: the largest prefix with fewer elements than the limit
    counts = [tfs.build_determ_block(t, space[:n])["n_elements"] for n in range(1, 13)]
    limit = counts[6] + 1
    cut = rung.determ_space(t, 12, max_elements=limit)
    assert len(cut) == 7 and counts[len(cut) - 1] < limit <= counts[len(cut)]
