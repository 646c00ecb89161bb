"""The port's frisys main path against the reference package: the HB-PP
spawner with injected uniforms, the exact-when-budget-large check, the power
step one step at a time from a shared state fed the reference's draws, the
state conversion, the package importing without jax, the frisys_mol
command line, and the 1e6 rung's definition against bench.py's ladder.  The port runs its plain kernel versions here (CPU tensors)."""

import os
import subprocess
import sys

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
from fries_tpu_torch.runtime import arena as tar  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMM = np.array([0, 1, 0, 1, 0, 1, 2, 3])


def system(n_orb=8, n_elec=4, symm=SYMM, seed=3):
    j = jsynth.make_system(n_orb, n_elec, symm=symm, seed=seed)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), np.asarray(j.symm),
                            n_orb, n_elec)
    return j, t


def spawners(j, t, **cfg):
    jsi, tsi = jmol.SymmInfo.build(np.asarray(j.symm)), tmol.SymmInfo.build(t.symm.numpy())
    p_doub = jfs.hf_p_doub(j, jsi)
    assert tfs.hf_p_doub(t, tsi) == p_doub
    js = jfs.make_hbpp_spawner(j, jhb.setup(j), jsi, p_doub, jfs.FrisysConfig(**cfg), 0.0)
    ts = tfs.make_hbpp_spawner(t, thb.setup(t), tsi, p_doub, tfs.FrisysConfig(**cfg), 0.0)
    return js, ts


def spawn_map(words, amps, n_bits):
    """{bitmask: summed amplitude} of a spawn stream."""
    out = {}
    for w, a in zip(np.asarray(words), np.asarray(amps)):
        if a != 0:
            mask = sum(int(x) << (32 * i) for i, x in enumerate(w))
            out[mask] = out.get(mask, 0.0) + float(a)
    return out


@pytest.mark.parametrize("unnorm", [False, True])
def test_spawner_matches_reference(unnorm):
    j, t = system()
    js, ts = spawners(j, t, eps=0.02, vec_nonz=60, matr_samp=150, capacity=64,
                      spawn_cap=200, unnorm=unnorm)
    hfw, hfo, _ = jmol.hf_reference(j)
    tmpl = jmol.ExcitationTemplate.build(j.n_orb, j.n_elec)
    ew, ea, _ = jmol.exact_offdiag_batch(j, tmpl, hfw[None], hfo[None], jnp.ones(1), 1.0)
    ew, ea = np.asarray(ew.reshape(-1, 1)), np.asarray(ea.reshape(-1))
    keys = np.unique(np.concatenate([np.asarray(hfw)[None], ew[ea != 0]]), axis=0)[:40]
    vals = np.random.default_rng(0).standard_normal(len(keys))
    a = jar.from_unsorted(jar.make(64, 1, 1), jnp.asarray(keys), jnp.asarray(vals)[None])
    avals = jnp.where(a.valid, a.vals[0], 0.0)
    key = jax.random.key(5)
    jw, jamp, jini = jax.jit(js)(a.keys, avals, -0.02, key)
    rns = jax.random.uniform(key, (6,), dtype=jnp.float64)
    tw, tamp, tini = ts(torch.as_tensor(np.asarray(a.keys).astype(np.int64)),
                        torch.tensor(np.asarray(avals)), -0.02,
                        torch.tensor(np.asarray(rns)))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tini.numpy(), np.asarray(jini))
    assert (np.asarray(jamp) != 0).sum() > 50
    np.testing.assert_allclose(tamp.numpy(), np.asarray(jamp), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("unnorm", [False, True])
@pytest.mark.parametrize("with_symm", [False, True])
def test_hbpp_exact_when_budget_large(unnorm, with_symm):
    """Budgets above the number of sampling paths keep everything, so the
    factorization must reconstruct -eps * H_offdiag * v exactly (f64 stage)
    and to f32 rounding (f32 stage)."""
    symm = np.array([0, 1, 0, 1, 0]) if with_symm else np.zeros(5, np.int64)
    j, t = system(5, 4, symm, seed=4)
    tsi = tmol.SymmInfo.build(symm)
    tens = thb.setup(t)
    p_doub = tfs.hf_p_doub(t, tsi)
    hf, _, _ = tmol.hf_reference(t)
    d2, _ = td.double_parity(hf[None], torch.tensor([0]), torch.tensor([6]),
                             torch.tensor([3]), torch.tensor([8]))
    d3, _ = td.single_parity(hf[None], torch.tensor([1]), torch.tensor([3]))
    keys = torch.cat([hf[None], d2, d3])[: 1 if with_symm else 3]
    vals = torch.tensor([1.0, -0.5, 0.25][: keys.shape[0]], dtype=torch.float64)
    a = tar.from_unsorted(tar.make(8, 1, 1), keys, vals[None])
    avals = torch.where(a.valid, a.vals[0], 0.0)
    tmpl = tmol.ExcitationTemplate.build(5, 4)
    aocc = td.occ_list(a.keys, 10, 4)
    ew, ea, _ = tmol.exact_offdiag_batch(t, tmpl, a.keys, aocc, avals, -0.01)
    want = spawn_map(ew.reshape(-1, 1), ea.reshape(-1), 10)
    rns = torch.tensor([0.3, 0.7, 0.1, 0.9, 0.45, 0.2], dtype=torch.float64)
    for stage_f32, rtol, atol in ((False, 1e-8, 1e-12), (True, 3e-6, 1e-10)):
        cfg = tfs.FrisysConfig(eps=0.01, vec_nonz=64, matr_samp=100000, capacity=8,
                               spawn_cap=1024, unnorm=unnorm, stage_f32=stage_f32)
        spawn = tfs.make_hbpp_spawner(t, tens, tsi, p_doub, cfg, 0.0)
        w, amp, _ = spawn(a.keys, avals, -cfg.eps, rns)
        got = spawn_map(w, amp, 10)
        for k in set(got) | set(want):
            np.testing.assert_allclose(got.get(k, 0.0), want.get(k, 0.0), rtol=rtol,
                                       atol=atol, err_msg=f"{stage_f32} det={k:x}")


@pytest.fixture(scope="module")
def power_pair():
    j, t = system()
    cfg = dict(eps=0.02, vec_nonz=60, matr_samp=150, capacity=256, spawn_cap=200,
               target_norm=200.0, shift_interval=2)
    jstep, _, jstate, jaux = jfs.build(j, jfs.FrisysConfig(**cfg), seed=4)
    tstep, _, _, taux = tfs.build(t, tfs.FrisysConfig(**cfg), seed=4)
    return jstep, jstate, jaux, tstep, taux


def test_build_matches_reference(power_pair):
    _, _, jaux, _, taux = power_pair
    assert taux["e_ref"] == float(jaux["e_ref"])
    assert taux["p_doub"] == jaux["p_doub"]
    for k in ("num_keys", "den_keys", "ref_key"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]).astype(np.int64))
    for k in ("num_vals", "den_vals"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-13)


def test_power_steps_match_reference(power_pair):
    """Five steps, each from the reference's state converted to the port and
    fed the reference's draws: exact keys and integer metrics, f64 values and
    metrics at rtol 1e-10."""
    jstep, jstate, jaux, tstep, taux = power_pair
    est = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")
    jargs = [jaux[k] for k in est]
    targs = [taux[k] for k in est]
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
        assert int(tstate.arena.n_used[0]) == int(ja.n_used[0])
        assert tstate.iterat == int(jstate.iterat)
        for k, v in jm.items():
            if np.asarray(v).dtype.kind == "f":
                np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-10, err_msg=k)
            else:
                assert int(tm[k]) == int(v), k


def test_convert_round_trip():
    j, t = system()
    np.testing.assert_array_equal(t.hcore.numpy(), np.asarray(j.hcore))
    np.testing.assert_array_equal(t.eris.numpy(), np.asarray(j.eris))
    np.testing.assert_array_equal(t.symm.numpy(), np.asarray(j.symm))
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 2**16, size=(20, 1), dtype=np.uint32)
    ja = jar.from_unsorted(jar.make(32, 1, 2), jnp.asarray(keys),
                           jnp.asarray(rng.standard_normal((2, 20))))
    ta = convert.arena(np.asarray(ja.keys), np.asarray(ja.vals), np.asarray(ja.n_used))
    keys_back, vals_back, n_used = convert.arena_to_numpy(ta)
    np.testing.assert_array_equal(keys_back, np.asarray(ja.keys))
    np.testing.assert_array_equal(vals_back, np.asarray(ja.vals))
    assert n_used == int(ja.n_used[0])
    state = convert.power_state(ta, np.float64(-0.25), np.float64(180.0), np.int32(7))
    assert (float(state.en_shift), float(state.last_norm), state.iterat) == (-0.25, 180.0, 7)


def test_frisys_energy_matches_dense_fci():
    rng = np.random.default_rng(11)
    h, eris = dense_fci.random_integrals(rng, 5)
    dense_h, _ = dense_fci.build_hamiltonian(h, eris, 5, 2, 2)
    e0, _ = dense_fci.ground_state(dense_h)
    ham = convert.hamiltonian(h, eris, np.zeros(5), 5, 4)
    cfg = tfs.FrisysConfig(eps=0.05, vec_nonz=50, matr_samp=150, capacity=128,
                           spawn_cap=512, target_norm=300.0)
    _, run_steps, state, aux = tfs.build(ham, cfg, seed=2)
    _, traj = run_steps(state, aux["num_keys"], aux["num_vals"], aux["den_keys"],
                        aux["den_vals"], aux["ref_key"], 800)
    assert not bool(traj["overflow"].any())
    num, den = traj["proj_num"][300:].numpy(), traj["proj_den"][300:].numpy()
    e_est = aux["e_ref"] + num.sum() / den.sum()
    bm = np.array([b.sum() / d.sum() for b, d in zip(np.array_split(num, 8),
                                                       np.array_split(den, 8))])
    sigma = bm.std() / np.sqrt(len(bm))
    assert abs(e_est - e0) < max(5 * sigma, 0.03), (e_est, e0, sigma)


def test_unported_options_raise():
    j, t = system()
    base = dict(eps=0.02, vec_nonz=60, matr_samp=150, capacity=64, spawn_cap=200)
    for opt in (dict(pivotal=True), dict(spin_parity=1), dict(fuse_ab=False),
                dict(fuse_cd=False), dict(axis_name="x", n_shards=2)):
        with pytest.raises(NotImplementedError):
            tfs.build(t, tfs.FrisysConfig(**base, **opt), seed=0)
    with pytest.raises(NotImplementedError):
        tfs.build(t, tfs.FrisysConfig(**base), seed=0, determ_keys=np.zeros((1, 1)))


def test_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['fries_tpu'] = None\n"
        "import fries_tpu_torch, fries_tpu_torch.cli, fries_tpu_torch.convert\n"
        "from fries_tpu_torch import synth\n"
        "from fries_tpu_torch.drivers import frisys\n"
        "ham = synth.make_system(5, 4, seed=1)\n"
        "cfg = frisys.FrisysConfig(eps=0.05, vec_nonz=20, matr_samp=40, capacity=64,"
        " spawn_cap=64)\n"
        "step, run, state, aux = frisys.build(ham, cfg, seed=0)\n"
        "state, m = run(state, aux['num_keys'], aux['num_vals'], aux['den_keys'],"
        " aux['den_vals'], aux['ref_key'], 3)\n"
        "assert not bool(m['overflow'].any())\n"
        "assert not any(n == 'jax' or n.startswith(('jax.', 'fries_tpu.'))"
        " for n in sys.modules if sys.modules[n] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_frisys_mol(tmp_path):
    _, t = system(6, 4, np.array([0, 1, 0, 1, 2, 3]), seed=2)
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump, point_group="D2h")
    out = tmp_path / "run"
    cli.main(["frisys_mol", "--fcidump_path", str(fcidump), "--point_group", "D2h",
              "--epsilon", "0.02", "--vec_nonz", "40", "--mat_nonz", "100",
              "--max_dets", "256", "--max_iter", "30", "--save_interval", "10",
              "--target", "200", "--result_dir", str(out), "--seed", "3"])
    for name in cli._STREAMS.values():
        assert np.loadtxt(out / name).shape == (30,), name
    assert (out / "params.txt").exists()
    assert len((out / "arena_occ.txt").read_text().splitlines()) == 3
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["fciqmc_mol", "--max_dets", "10"])
    with pytest.raises(NotImplementedError):
        cli.main(["frisys_mol", "--fcidump_path", str(fcidump), "--epsilon", "0.02",
                  "--vec_nonz", "40", "--mat_nonz", "100", "--max_dets", "256",
                  "--det_space", "dets.txt"])


def test_rung_is_bench_ladder_1e6():
    """fries_tpu_torch.rung is the 1e6 entry of bench.py's FULL_LADDER with
    bench.py's eps and target norm."""
    import ast

    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "FULL_LADDER")
    ladder = eval(compile(ast.Expression(node.value), "bench.py", "eval"))
    name, vec_nonz, matr_samp, cap, spawn_cap, *_ = ladder[0]
    cfg = rung.config()
    assert name == "1e6"
    assert (cfg.vec_nonz, cfg.matr_samp, cfg.capacity, cfg.spawn_cap) == (
        vec_nonz, matr_samp, cap, spawn_cap)
    assert (cfg.eps, cfg.target_norm) == (0.001, 2.0 * vec_nonz)
    assert (rung.N_SAMP, rung.CAPACITY, rung.SPAWN_CAP, rung.EPS) == (
        matr_samp, cap, spawn_cap, cfg.eps)
