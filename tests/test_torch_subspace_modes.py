"""The port's subspace modes against the reference package: ``lowmem``
(against the reference's lowmem and against the port's stored H * trial
path, also in the even spin-flip sector), ``exact_h`` merged in chunks of 16
rows (at least 3 per step), ``multi_comp`` fed the reference's key and
whole ``compress_mode="multi"`` steps, and the ``subsp_mol_lowmem`` /
``subspfull_mol`` command lines.  Keys and counts exact; values, h_mat and
d_mat at rtol 1e-10 (sums in another order), multi_comp's values at rtol
1e-12.  The port runs its plain merge here (CPU tensors)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fries_tpu import compress as jcomp, synth as jsynth  # noqa: E402
from fries_tpu.drivers import subspace as jsub  # noqa: E402
from fries_tpu_torch import cli, compress as tcomp, convert, dets as td, io as tio  # noqa: E402
from fries_tpu_torch import synth as tsynth  # noqa: E402
from fries_tpu_torch.drivers import subspace as tsub  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402
from test_torch_subspace import SYMM, hf_and_single  # noqa: E402

BASE = dict(eps=0.02, n_trial=2, vec_nonz=60, matr_samp=150, capacity=512, spawn_cap=200,
            restart_int=2, shift_interval=2)


def systems():
    j = jsynth.make_system(8, 4, symm=SYMM, seed=3)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), SYMM, 8, 4)
    return j, t


def port_state(jstate):
    a = jstate.arena
    return convert.subspace_state(
        convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used)),
        jstate.norm_factors, jstate.last_norms, jstate.iterat, JaxKeys(jstate.key))


def assert_metrics(tm, jm):
    for k, v in jm.items():
        if np.asarray(v).dtype.kind == "f":
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(v), rtol=1e-10, atol=1e-14,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(tm[k].numpy().reshape(-1), np.asarray(v).reshape(-1),
                                          err_msg=k)


def steps_match(modes, port_modes=None, n_before=3, n_steps=4, stored=False):
    """``n_steps`` steps from the reference's state after ``n_before``, each
    converted to the port and drawing from the reference's key; with
    ``stored`` the port's stored H * trial path takes the same states and
    its h_mat / d_mat must agree.  Returns the last reference metrics."""
    j, t = systems()
    tk, tv = hf_and_single(j)
    cfg = dict(BASE, **modes)
    jstep, _, jstate, _ = jsub.build(j, jsub.SubspaceConfig(**cfg), jnp.asarray(tk),
                                     jnp.asarray(tv), seed=4)
    tstep, _, _, taux = tsub.build(t, tsub.SubspaceConfig(**cfg, **(port_modes or {})),
                                   tk, tv, seed=4)
    if stored:
        sstep, _, _, _ = tsub.build(t, tsub.SubspaceConfig(**dict(cfg, lowmem=False)), tk, tv,
                                    seed=4)
        assert taux["htrial_keys"] is None
    for _ in range(n_before):
        jstate, _ = jstep(jstate)
    for _ in range(n_steps):
        tstate = port_state(jstate)
        if stored:
            _, sm = sstep(port_state(jstate))
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate)
        ja = jstate.arena
        np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                      np.asarray(ja.keys).astype(np.int64))
        np.testing.assert_allclose(tstate.arena.vals.numpy(), np.asarray(ja.vals),
                                   rtol=1e-10, atol=1e-12)
        assert tstate.iterat == int(jstate.iterat)
        assert_metrics(tm, jm)
        if stored:
            for k in ("h_mat", "d_mat"):
                np.testing.assert_allclose(sm[k].numpy(), tm[k].numpy(), rtol=1e-10,
                                           atol=1e-14, err_msg=k)
    return jm, tm


@pytest.mark.parametrize("spin_parity", [0, 1])
def test_lowmem_matches_reference_and_stored(spin_parity):
    """lowmem steps (restarts and norm-factor updates among them) against
    the reference's lowmem, and their h_mat / d_mat against the port's
    stored path from the same states."""
    jm, _ = steps_match(dict(lowmem=True, spin_parity=spin_parity), stored=True)
    assert int(jm["n_dets"][0]) > 20


def test_exact_h_matches_reference():
    """exact_h steps merged in chunks of 16 rows: the same keys as the
    reference's one merge of every capacity row, values within rtol
    1e-10."""
    jm, tm = steps_match(dict(exact_h=True), dict(batch=16))
    assert int(tm["n_merges"]) >= 3
    assert int(tm["n_merges"]) == -(-int(tm["spawn_rows"]) // 16)


def test_exact_h_chunking_changes_only_the_order():
    """One chunk and chunks of 7 rows give the same keys and values to
    rtol 1e-12, the sector folding included."""
    _, t = systems()
    hf = td.hf_det(8, 4)
    d1, _ = td.single_parity(hf[None], torch.tensor([1]), torch.tensor([5]))
    tk, tv = torch.stack([hf[None], d1]).numpy(), np.ones((2, 1))
    for spin_parity in (0, 1):
        states = []
        for batch in (1024, 7):
            cfg = tsub.SubspaceConfig(**BASE, exact_h=True, batch=batch, spin_parity=spin_parity)
            _, run_steps, state, _ = tsub.build(t, cfg, tk, tv, seed=4)
            state, traj = run_steps(state, 3)
            assert not bool(traj["overflow"].any())
            states.append((state, traj))
        (s1, t1), (s2, t2) = states
        np.testing.assert_array_equal(s1.arena.keys.numpy(), s2.arena.keys.numpy())
        np.testing.assert_allclose(s1.arena.vals.numpy(), s2.arena.vals.numpy(), rtol=1e-12,
                                   atol=1e-14)
        assert int(t1["n_merges"][-1]) == 1 and int(t2["n_merges"][-1]) > 10


@pytest.mark.parametrize("seed", [0, 1])
def test_multi_comp_matches_reference(seed):
    """multi_comp fed the reference's key, on values whose running sums are
    exact in any order (multiples of 2^-10): counts exact, values at rtol
    1e-12; the preserved elements pass through."""
    rng = np.random.default_rng(seed)
    n = 3000
    vals = rng.integers(-4096, 4096, n) * 2.0 ** -10
    vals[rng.random(n) < 0.3] = 0.0
    vals[:5] = [40.0, -35.0, 30.0, 0.0, 25.0]
    for budget in (400, 0):
        keep, n_left, loc_norm = jcomp.find_preserve(jnp.abs(jnp.asarray(vals)), budget)
        key = jax.random.key(11 + seed)
        want = np.asarray(jcomp.multi_comp(key, jnp.asarray(vals), keep, n_left, loc_norm))
        tkeep, tn_left, tloc = tcomp.find_preserve(torch.as_tensor(vals).abs(), budget)
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
        got = tcomp.multi_comp(JaxKeys(key), torch.as_tensor(vals), tkeep, tn_left, tloc).numpy()
        np.testing.assert_array_equal(got != 0, want != 0)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        if budget:
            assert tkeep.any() and int((got != 0).sum() - tkeep.sum()) > 100
            unit = float(tloc) / int(tn_left)
            counts = np.abs(got[~tkeep.numpy()]) / unit
            np.testing.assert_allclose(counts, np.round(counts), atol=1e-9)
            assert int(np.round(counts).sum()) == int(tn_left)


def test_multi_steps_match_reference():
    jm, _ = steps_match(dict(compress_mode="multi"))
    assert int(jm["n_dets"][0]) > 20


def test_cli_subsp_mol_lowmem_and_subspfull(tmp_path):
    """Both commands run on the CPU and write subsp_mol's files; lowmem's
    h_mat equals subsp_mol's (the same draws), subspfull's differs."""
    t = tsynth.make_system(6, 4, symm=np.array([0, 1, 0, 1, 2, 3]), seed=2)
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump, point_group="D2h")
    hf = td.hf_det(6, 4)
    d1, _ = td.single_parity(hf[None], torch.tensor([1]), torch.tensor([3]))
    for j, (k, v) in enumerate(((hf[None], [1.0]), (d1, [0.8]))):
        tio.save_vec_txt(tmp_path / f"trial{j:02d}", k.numpy(), v, 12)
    base = ["--fcidump_path", str(fcidump), "--point_group", "D2h", "--epsilon", "0.02",
            "--vec_nonz", "40", "--mat_nonz", "100", "--max_dets", "256", "--max_iter", "10",
            "--save_interval", "5", "--trial_vecs", str(tmp_path / "trial"), "--num_trial",
            "2", "--restart_int", "4", "--seed", "3"]
    h = {}
    for cmd in ("subsp_mol", "subsp_mol_lowmem", "subspfull_mol"):
        out = tmp_path / cmd
        cli.main([cmd] + base + ["--result_dir", str(out), "--device", "cpu"])
        h[cmd] = np.loadtxt(out / "h_mat.txt", delimiter=",")
        assert h[cmd].shape == (10, 4) and np.isfinite(h[cmd]).all()
        for name, shape in (("d_mat.txt", (10, 4)), ("norms.txt", (10, 2)), ("n_ini.txt", (10, 2)),
                            ("shifts.txt", (1, 2))):
            assert np.loadtxt(out / name, delimiter=",", ndmin=2).shape == shape, name
        if not torch.cuda.is_available():
            with pytest.raises(SystemExit, match="no CUDA device"):
                cli.main([cmd] + base + ["--result_dir", str(tmp_path / "cuda")])
    np.testing.assert_allclose(h["subsp_mol_lowmem"], h["subsp_mol"], rtol=1e-10, atol=1e-14)
    assert not np.allclose(h["subspfull_mol"][1:], h["subsp_mol"][1:])
