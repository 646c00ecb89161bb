"""The port's observable estimators against the reference package.

On the 5-orbital / 4-electron system of ``tests/test_observables.py``
(schedule cut to burn_in 2, n_obs 2, btw_obs 2), both packages build from one
numpy-seeded Hamiltonian and step 10 times side by side, the port fed the
reference's key (``jax_keys.JaxKeys``): after each step the arenas' keys are
equal exactly and their values within rtol 1e-10 (atol 1e-13: the
reference sums a merge's spawns by differences of a running sum, the port
by segments); obs_num, obs_den and norm within rtol 1e-10; n_dets, in_obs
and the overflow flag equal.  Rayleigh and replica, each with a
deterministic budget (target_nonz 256 above the 100 determinants) and a
sampled one (30).  Also: ``batch`` 1 against 1024, the command line (against the reference's at a deterministic
budget, where the two key trees do not matter), and the ``observables``
configuration (``test_torch_observables_dense.py`` holds the estimators
against dense FCI).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import dense_fci  # noqa: E402
from fries_tpu import cli as jcli, io as jio  # noqa: E402
from fries_tpu.drivers import observables as jobs  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu_torch import cli, convert, rung  # noqa: E402
from fries_tpu_torch.drivers import observables as tobs  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402

SCHEDULE = dict(eps=0.05, capacity=128, obs_des=1, obs_cre=2, burn_in=2, n_obs=2, btw_obs=2)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(31)
    h, eris = dense_fci.random_integrals(rng, 5)
    j = jmol.MolecularHamiltonian(hcore=jnp.asarray(h), eris=jnp.asarray(eris),
                                  symm=jnp.zeros(5, jnp.int32), n_orb=5, n_elec=4)
    return j, convert.hamiltonian(h, eris, np.zeros(5), 5, 4), h, eris


def assert_arena_equal(ta, ja, msg=""):
    np.testing.assert_array_equal(ta.keys.numpy(), np.asarray(ja.keys).astype(np.int64),
                                  err_msg=msg)
    np.testing.assert_allclose(ta.vals.numpy(), np.asarray(ja.vals), rtol=1e-10, atol=1e-13,
                               err_msg=msg)
    assert int(ta.n_used[0]) == int(np.asarray(ja.n_used).reshape(-1)[0]), msg


@pytest.mark.parametrize("target_nonz", [256, 30])
@pytest.mark.parametrize("replica", [False, True])
def test_steps_match_reference(system, replica, target_nonz):
    j, t, _, _ = system
    cfg = dict(SCHEDULE, target_nonz=target_nonz, replica=replica)
    jstep, _, jstate, _ = jobs.build(j, jobs.ObservablesConfig(**cfg), seed=2)
    tcfg = tobs.ObservablesConfig(**cfg)
    tstep, _, tstate, taux = tobs.build(t, tcfg, seed=2)
    assert taux["e_ref"] == float(jmol.hf_reference(j)[2])
    tstate = dataclasses.replace(tstate, key=JaxKeys(jstate.key))
    assert_arena_equal(tstate.arena, jstate.arena)
    seen_obs = 0
    for it in range(10):
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate)
        msg = f"replica={replica} target={target_nonz} step {it}"
        assert_arena_equal(tstate.arena, jstate.arena, msg)
        for k in ("obs_num", "obs_den", "norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-10, err_msg=msg + k)
        for k in ("n_dets", "in_obs", "overflow"):
            assert int(tm[k]) == int(np.asarray(jm[k]).reshape(-1)[0]), msg + k
        seen_obs += bool(tm["in_obs"])
        # the schedule's merges: O v on a period start (every step in replica
        # mode) and the exact spawn of each evolving row in one chunk each
        starts = replica or tobs.schedule(tcfg, it)[1]
        assert int(tm["n_merges"]) == int(starts) + (2 if replica else 1)
    assert seen_obs == 4 and tstate.iterat == int(jstate.iterat) == 10


@pytest.mark.parametrize("replica", [False, True])
def test_batch_one_matches_batch_1024(system, replica):
    """One source row per chunk (dozens of merges a step) against one chunk:
    the same arenas and estimators, sums differing in order only."""
    _, t, _, _ = system
    runs = []
    for batch in (1, 1024):
        cfg = tobs.ObservablesConfig(**SCHEDULE, target_nonz=30, replica=replica, batch=batch)
        _, run_steps, state, _ = tobs.build(t, cfg, seed=5)
        runs.append(run_steps(state, 10))
    (s1, m1), (s2, m2) = runs
    np.testing.assert_array_equal(s1.arena.keys.numpy(), s2.arena.keys.numpy())
    np.testing.assert_allclose(s1.arena.vals.numpy(), s2.arena.vals.numpy(), rtol=1e-10,
                               atol=1e-13)
    for k in ("obs_num", "obs_den", "norm"):
        np.testing.assert_allclose(m1[k].numpy(), m2[k].numpy(), rtol=1e-10, err_msg=k)
    assert (m1["n_merges"] >= m2["n_merges"]).all() and (m1["n_merges"] > 10).any()
    assert (m2["n_merges"] <= 3).all()


def test_cli_matches_reference(system, tmp_path):
    """``observables_mol`` against the reference's at a deterministic budget:
    obs_num / obs_den hold the in-period steps only and are equal within
    rtol 1e-10."""
    j, _, _, _ = system
    fcidump = tmp_path / "FCIDUMP"
    jio.write_fcidump(j, str(fcidump))
    args = ["observables_mol", "--fcidump_path", str(fcidump), "--epsilon", "0.05",
            "--vec_nonz", "256", "--max_dets", "128", "--obs_des", "1", "--obs_cre", "2",
            "--max_iter", "12", "--save_interval", "5", "--seed", "1", "--burn_in", "2",
            "--n_obs", "3", "--btw_obs", "2"]
    jcli.main(args + ["--result_dir", str(tmp_path / "ref")])
    cli.main(args + ["--result_dir", str(tmp_path / "port"), "--device", "cpu"])
    for name in ("obs_num.txt", "obs_den.txt"):
        ref, got = np.loadtxt(tmp_path / "ref" / name), np.loadtxt(tmp_path / "port" / name)
        assert got.shape == ref.shape == (6,), name
        np.testing.assert_allclose(got, ref, rtol=1e-10, err_msg=name)
    assert "obs_cre: 2" in (tmp_path / "port" / "params.txt").read_text()
    assert (tmp_path / "port" / "checkpoint.npz").exists()


def test_cli_obs_repl_mol(system, tmp_path):
    """``obs_repl_mol`` writes every step's estimator, the build's own, and
    stops without a card unless told ``--device cpu``."""
    _, t, _, _ = system
    from fries_tpu_torch import io as tio

    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump)
    args = ["obs_repl_mol", "--fcidump_path", str(fcidump), "--epsilon", "0.05",
            "--vec_nonz", "30", "--max_dets", "128", "--obs_des", "1", "--obs_cre", "2",
            "--max_iter", "8", "--save_interval", "3", "--seed", "4"]
    cli.main(args + ["--result_dir", str(tmp_path / "port"), "--device", "cpu"])
    cfg = tobs.ObservablesConfig(eps=0.05, target_nonz=30, capacity=128, obs_des=1, obs_cre=2,
                                 burn_in=1000, n_obs=100, btw_obs=100, replica=True)
    _, run_steps, state, _ = tobs.build(tio.parse_fcidump(fcidump)[0], cfg, seed=4)
    _, traj = run_steps(state, 8)
    for name, key in (("obs_num.txt", "obs_num"), ("obs_den.txt", "obs_den")):
        np.testing.assert_array_equal(np.loadtxt(tmp_path / "port" / name), traj[key].numpy())
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args + ["--result_dir", str(tmp_path / "cuda")])


def test_rung_observables_config():
    """The configuration chip_smoke.py drives: frifull's system and widths,
    HOMO -> LUMO, and a schedule whose steps 6-11 start a period, weight
    three steps and run three free."""
    for replica in (False, True):
        cfg = rung.observables_config(replica)
        assert (cfg.eps, cfg.target_nonz, cfg.capacity, cfg.batch) == (0.005, 30_000, 1 << 18,
                                                                       1024)
        assert (cfg.obs_des, cfg.obs_cre, cfg.exponent, cfg.replica) == (2, 3, 0.5, replica)
        assert [tobs.schedule(cfg, it) for it in range(5, 12)] == (
            [(False, False), (True, True), (True, False), (True, False)]
            + [(False, False)] * 3)
    ham = rung.frifull_system()
    assert (ham.n_orb, ham.n_elec) == (14, 6)
    assert rung.frifull_config().capacity == rung.observables_config().capacity
