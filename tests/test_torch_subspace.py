"""The port's subspace iteration against the reference package: build (H *
trial, the initial arena, e_ref), steps from the reference's state converted
to the port and fed the reference's key tree (``jax_keys.JaxKeys``) in both
the pivotal (piv / pivotal_h) and the systematic (sys / no pivotal_h) modes
and in the even time-reversal sector (``spin_parity = +1``: folded trial
vectors, H * trial, diagonal and spawner) across restarts and norm-factor
updates, the energies against dense FCI, the
subsp_mol command line and the options that raise.  Exact keys, counts and
flags; values, h_mat and d_mat at rtol 1e-10 (sums in another order).  The
port runs its plain merge here (CPU tensors)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dense_fci  # noqa: E402
from fries_tpu import dets as jd, synth as jsynth  # noqa: E402
from fries_tpu.drivers import subspace as jsub  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu_torch import cli, convert, dets as td, io as tio, linalg as tla  # noqa: E402
from fries_tpu_torch import synth as tsynth  # noqa: E402
from fries_tpu_torch.drivers import subspace as tsub  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402

SYMM = np.array([0, 1, 0, 1, 0, 1, 2, 3])
MODES = {"piv": dict(compress_mode="piv", pivotal_h=True),
         "sys": dict(compress_mode="sys", pivotal_h=False),
         "tr": dict(compress_mode="piv", pivotal_h=True, spin_parity=1)}
BASE = dict(eps=0.02, n_trial=2, vec_nonz=60, matr_samp=150, capacity=256,
            spawn_cap=200, restart_int=2, shift_interval=2)


def hf_and_single(j):
    """(T=2, 1, W) trial keys and values: HF and the single 1 -> 5."""
    hf, _, _ = jmol.hf_reference(j)
    d1, _ = jd.single_parity(hf[None], jnp.asarray([1]), jnp.asarray([5]))
    tk = np.stack([np.asarray(hf)[None], np.asarray(d1)])
    return tk, np.ones((2, 1))


@pytest.fixture(scope="module", params=sorted(MODES))
def pair(request):
    j = jsynth.make_system(8, 4, symm=SYMM, seed=3)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), SYMM, 8, 4)
    tk, tv = hf_and_single(j)
    cfg = dict(BASE, **MODES[request.param])
    jstep, _, jstate, jaux = jsub.build(j, jsub.SubspaceConfig(**cfg), jnp.asarray(tk),
                                        jnp.asarray(tv), seed=4)
    tstep, _, tstate, taux = tsub.build(t, tsub.SubspaceConfig(**cfg), tk, tv, seed=4)
    return request.param, jstep, jstate, jaux, tstep, tstate, taux


def as_map(keys, vals):
    out = {}
    for k, v in zip(np.asarray(keys).reshape(len(np.asarray(vals)), -1).tolist(),
                    np.asarray(vals)):
        if v != 0:
            out[tuple(k)] = float(v)
    return out


def test_build_matches_reference(pair):
    _, _, jstate, jaux, _, tstate, taux = pair
    assert taux["e_ref"] == float(jaux["e_ref"])
    for row in range(2):
        want = as_map(np.asarray(jaux["htrial_keys"][row]).astype(np.int64),
                      jaux["htrial_vals"][row])
        got = as_map(taux["htrial_keys"][row].numpy(), taux["htrial_vals"][row].numpy())
        assert set(got) == set(want)
        np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-13)
    ja = jstate.arena
    np.testing.assert_array_equal(tstate.arena.keys.numpy(), np.asarray(ja.keys).astype(np.int64))
    np.testing.assert_array_equal(tstate.arena.vals.numpy(), np.asarray(ja.vals))
    np.testing.assert_array_equal(tstate.last_norms.numpy(), np.asarray(jstate.last_norms))


def test_steps_match_reference(pair):
    """Four steps from the reference's state after three, each converted to
    the port and drawing from the reference's key: two restarts and two
    norm-factor updates among them."""
    mode, jstep, jstate, _, tstep, _, _ = pair
    for _ in range(3):
        jstate, _ = jstep(jstate)
    n_restart = 0
    for _ in range(4):
        a = jstate.arena
        tstate = convert.subspace_state(
            convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used)),
            jstate.norm_factors, jstate.last_norms, jstate.iterat, JaxKeys(jstate.key))
        n_restart += (tstate.iterat + 1) % BASE["restart_int"] == 0
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate)
        ja = jstate.arena
        np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                      np.asarray(ja.keys).astype(np.int64), err_msg=mode)
        np.testing.assert_allclose(tstate.arena.vals.numpy(), np.asarray(ja.vals),
                                   rtol=1e-10, atol=1e-12)
        assert tstate.iterat == int(jstate.iterat)
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
    assert n_restart == 2
    assert int(jm["n_dets"][0]) > 20


def test_energy_matches_dense_fci():
    """With budgets above the Hilbert-space and path counts the iteration is
    deterministic: the last step's (h, d) give the two lowest FCI energies
    (tests/test_subspace.py's system and tolerances)."""
    rng = np.random.default_rng(21)
    h, eris = dense_fci.random_integrals(rng, 5)
    dense_h, basis = dense_fci.build_hamiltonian(h, eris, 5, 2, 2)
    evals, evecs = np.linalg.eigh(dense_h)
    ham = convert.hamiltonian(h, eris, np.zeros(5), 5, 4)
    tk, tv = [], []
    for j in range(2):
        top = np.argsort(-np.abs(evecs[:, j]))[:8]
        tk.append([dense_fci.mask_to_words(basis[i], 10) for i in top])
        tv.append(evecs[top, j])
    cfg = tsub.SubspaceConfig(eps=0.05, n_trial=2, vec_nonz=512, matr_samp=60000,
                              capacity=128, spawn_cap=8192, restart_int=10)
    _, run_steps, state, aux = tsub.build(ham, cfg, np.asarray(tk), np.asarray(tv), seed=0)
    _, traj = run_steps(state, 40)
    assert not bool(traj["overflow"].any())
    evals_sub, _ = tla.gen_eig(traj["h_mat"][-1].numpy(), traj["d_mat"][-1].numpy())
    got = np.sort(evals_sub.real) + aux["e_ref"]
    np.testing.assert_allclose(got[0], evals[0], atol=2e-3)
    np.testing.assert_allclose(got[1], evals[1], atol=2e-2)


def test_subspace_energies_and_linalg():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((4, 4))
    r = np.linalg.qr(m)[1]
    np.testing.assert_allclose(tla.inv_triangular_upper(r) @ r, np.eye(4), atol=1e-12)
    rinv = tla.inv_r_factor(m)
    q = m @ rinv
    np.testing.assert_allclose(q.T @ q, np.eye(4), atol=1e-12)
    h = np.diag([1.0, 3.0, 2.0])
    np.testing.assert_allclose(tla.subspace_energies([h, h], [np.eye(3)] * 2), [1, 2, 3])


def test_cli_subsp_mol(tmp_path):
    t = tsynth.make_system(6, 4, symm=np.array([0, 1, 0, 1, 2, 3]), seed=2)
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump, point_group="D2h")
    hf = td.hf_det(6, 4)
    d1, _ = td.single_parity(hf[None], torch.tensor([1]), torch.tensor([3]))
    for j, (k, v) in enumerate(((hf[None], [1.0]), (d1, [0.8]))):
        tio.save_vec_txt(tmp_path / f"trial{j:02d}", k.numpy(), v, 12)
    base = ["subsp_mol", "--fcidump_path", str(fcidump), "--point_group", "D2h",
            "--epsilon", "0.02", "--vec_nonz", "40", "--mat_nonz", "100",
            "--max_dets", "256", "--max_iter", "12", "--save_interval", "5",
            "--trial_vecs", str(tmp_path / "trial"), "--num_trial", "2",
            "--restart_int", "4", "--seed", "3", "--device", "cpu"]
    for fmt in ("txt", "npy", "bin"):
        out = tmp_path / fmt
        cli.main(base + ["--result_dir", str(out), "--out_format", fmt])
        if fmt == "txt":
            h = np.loadtxt(out / "h_mat.txt", delimiter=",")
            assert h.shape == (12, 4)
            assert np.loadtxt(out / "d_mat.txt", delimiter=",").shape == (12, 4)
        elif fmt == "npy":
            np.testing.assert_array_equal(np.load(out / "h_mat.npy").reshape(12, 4), h)
            assert np.isfinite(np.load(out / "d_mat.npy")).all()
        else:
            np.testing.assert_array_equal(np.fromfile(out / "h_mat.dat").reshape(12, 4), h)
        assert np.loadtxt(out / "norms.txt", delimiter=",").shape == (12, 2)
        assert np.loadtxt(out / "n_ini.txt", delimiter=",").shape == (12, 2)
        assert np.loadtxt(out / "shifts.txt", delimiter=",", ndmin=2).shape == (1, 2)
        assert (out / "params.txt").exists()
    with pytest.raises(SystemExit, match="overflow"):
        cli.main([x if x != "256" else "4" for x in base]
                 + ["--result_dir", str(tmp_path / "ovf")])


def test_cli_subsp_mol_time_reversal(tmp_path):
    """--time_reversal 1 runs (it raised before the sector was ported) and
    gives other projections than the unfolded run."""
    t = tsynth.make_system(6, 4, symm=np.array([0, 1, 0, 1, 2, 3]), seed=2)
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump, point_group="D2h")
    hf = td.hf_det(6, 4)
    d1, _ = td.single_parity(hf[None], torch.tensor([1]), torch.tensor([3]))
    for j, (k, v) in enumerate(((hf[None], [1.0]), (d1, [0.8]))):
        tio.save_vec_txt(tmp_path / f"trial{j:02d}", k.numpy(), v, 12)
    base = ["subsp_mol", "--fcidump_path", str(fcidump), "--point_group", "D2h",
            "--epsilon", "0.02", "--vec_nonz", "40", "--mat_nonz", "100",
            "--max_dets", "256", "--max_iter", "8", "--save_interval", "4",
            "--trial_vecs", str(tmp_path / "trial"), "--num_trial", "2",
            "--restart_int", "4", "--seed", "3", "--device", "cpu"]
    h = {}
    for tr in ("0", "1"):
        out = tmp_path / f"tr{tr}"
        cli.main(base + ["--result_dir", str(out), "--time_reversal", tr])
        h[tr] = np.loadtxt(out / "h_mat.txt", delimiter=",")
        assert h[tr].shape == (8, 4) and np.isfinite(h[tr]).all()
        assert np.loadtxt(out / "d_mat.txt", delimiter=",").shape == (8, 4)
        assert "time_reversal: " + tr in (out / "params.txt").read_text()
    assert not np.allclose(h["0"], h["1"])
    # the folded single has 1 / sqrt(2) of its amplitude on the representative
    d0 = np.loadtxt(tmp_path / "tr1" / "d_mat.txt", delimiter=",")[0].reshape(2, 2)
    np.testing.assert_allclose(d0[1, 1], 0.8 ** 2 / 2, rtol=1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(base[:-2] + ["--time_reversal", "1"])


def test_vector_files_match_reference(tmp_path):
    """read_dets / load_vec_txt / load_vec_dice / npy_append against the
    reference's readers and writer on the same files."""
    from fries_tpu import io as jio

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, size=(30, 2), dtype=np.uint64).astype(np.uint32)
    keys[:, 1] &= 0x3FFF
    vals = rng.standard_normal(30)
    jio.save_vec_txt(tmp_path / "v", keys, vals, 46)
    for got, want in zip(tio.load_vec_txt(tmp_path / "v", 46),
                         jio.load_vec_txt(tmp_path / "v", 46)):
        np.testing.assert_array_equal(got, want)
    tio.save_vec_txt(tmp_path / "w", keys, vals, 46)
    for ext in ("dets", "vals"):
        assert (tmp_path / f"w{ext}").read_text() == (tmp_path / f"v{ext}").read_text()
    (tmp_path / "x.dice").write_text(
        "State : 0\n  0  0.9  2 2 0 0 0\n  1  -0.3  2 a b 0 0\n  2  1e-8  2 0 2 0 0\n"
        "State : 1\n  0  0.7  2 0 2 0 0\n  1  0.5  a 2 b 0 0\n")
    for state in (0, 1):
        for got, want in zip(tio.load_vec_dice(tmp_path / "x.dice", 5, 10, state),
                             jio.load_vec_dice(tmp_path / "x.dice", 5, 10, state)):
            np.testing.assert_array_equal(got, want)
    for mod, name in ((tio, "t.npy"), (jio, "j.npy")):
        for i in range(3):
            mod.npy_append(tmp_path / name, np.full((2, 2), float(i)))
    assert (tmp_path / "t.npy").read_bytes() == (tmp_path / "j.npy").read_bytes()
    assert np.load(tmp_path / "t.npy").shape == (3, 2, 2)


def test_unported_options_raise(tmp_path):
    t = tsynth.make_system(6, 4, seed=2)
    hf = td.hf_det(6, 4)
    tk, tv = hf[None, None].numpy(), np.ones((1, 1))
    base = dict(eps=0.02, n_trial=1, vec_nonz=40, matr_samp=100, capacity=64,
                spawn_cap=128)
    with pytest.raises(ValueError, match="Shards handle"):   # sharded runs take build_sharded
        tsub.build(t, tsub.SubspaceConfig(**base, axis_name="x", n_shards=2), tk, tv, seed=0)
    for opt in (dict(compress_mode="pivot"), dict(exact_h=True, batch=0)):
        with pytest.raises(ValueError):
            tsub.build(t, tsub.SubspaceConfig(**base, **opt), tk, tv, seed=0)
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump)
    tio.save_vec_txt(tmp_path / "trial00", hf[None].numpy(), [1.0], 12)
    args = ["--fcidump_path", str(fcidump), "--epsilon", "0.02", "--vec_nonz", "40",
            "--mat_nonz", "100", "--max_dets", "64", "--num_trial", "1",
            "--trial_vecs", str(tmp_path / "trial"), "--device", "cpu"]
    with pytest.raises(NotImplementedError):
        cli.main(["subsp_mol"] + args + ["--n_chips", "2"])


def test_convert_subspace_state():
    rng = np.random.default_rng(4)
    keys = np.sort(rng.integers(0, 2**20, size=(20, 1), dtype=np.uint32), axis=0)
    a = convert.arena(keys, rng.standard_normal((2, 20)), 20)
    st = convert.subspace_state(a, np.array([1.0, 2.0]), np.array([3.0, 4.0]),
                                np.int32(5), JaxKeys(jax.random.key(0)))
    assert st.iterat == 5 and st.arena is a
    np.testing.assert_array_equal(st.norm_factors.numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(st.last_norms.numpy(), [3.0, 4.0])


def test_cli_device_cuda_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t = tsynth.make_system(6, 4, seed=2)
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump)
    tio.save_vec_txt(tmp_path / "trial00", td.hf_det(6, 4)[None].numpy(), [1.0], 12)
    common = ["--fcidump_path", str(fcidump), "--epsilon", "0.02", "--vec_nonz", "40",
              "--mat_nonz", "100", "--max_dets", "64", "--result_dir", str(tmp_path)]
    for argv in (["frisys_mol"] + common,
                 ["frifull_mol"] + [x for x in common if x not in ("--mat_nonz", "100")],
                 ["subsp_mol"] + common + ["--num_trial", "1", "--trial_vecs",
                                           str(tmp_path / "trial")]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(argv)
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(argv + ["--device", "cuda"])
    assert not os.path.exists(tmp_path / "projnum.txt")


def test_rung_subspace_is_bench_subsp():
    """fries_tpu_torch.rung.subspace_config is bench.py's subsp
    configuration (bench_subsp_sharded) without its sharding fields, with an
    arena that holds a merged step's T * (vec_nonz + matr_samp) rows."""
    import ast

    from fries_tpu_torch import rung

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "bench_subsp_sharded")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "SubspaceConfig")
    cfg = rung.subspace_config()
    for kw in call.keywords:
        if kw.arg == "n_trial":
            assert cfg.n_trial == 2
        elif kw.arg == "capacity":
            assert cfg.capacity >= cfg.n_trial * (cfg.vec_nonz + cfg.matr_samp)
        elif kw.arg not in ("axis_name", "n_shards", "exchange_cap"):
            assert getattr(cfg, kw.arg) == eval(compile(ast.Expression(kw.value), "bench.py",
                                                        "eval")), kw.arg
    assert (cfg.compress_mode, cfg.pivotal_h, cfg.unnorm) == ("piv", True, True)
