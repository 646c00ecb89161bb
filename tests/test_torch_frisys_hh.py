"""The port's frisys_hh driver against the reference package: the two-level
spawner fed the reference's two uniforms (Hubbard-Holstein and pure Hubbard
with g = 0), the exact reconstruction when the budget exceeds the branch
counts, ten whole steps from the reference's state, an end-to-end estimate
of the dense ground-state energy, and the command line.  Keys exact,
amplitudes at rtol 1e-12 (spawner) and values at rtol 1e-10 (steps)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dense_hubbard  # noqa: E402
from fries_tpu import dets as jd  # noqa: E402
from fries_tpu.drivers import frisys_hh as jfh  # noqa: E402
from fries_tpu.ops import hubbard as jhub  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import cli, dets as td  # noqa: E402
from fries_tpu_torch.drivers import frisys_hh as tfh  # noqa: E402
from fries_tpu_torch.ops import hubbard as thub  # noqa: E402
from fries_tpu_torch.runtime import arena as tar  # noqa: E402
from test_torch_frifull_hh import EST, assert_steps_match, write_params  # noqa: E402

MODELS = {"holstein": dict(n_sites=3, n_elec=2, ph_bits=2, u=1.5, omega=0.7, g=0.4, t=1.0),
          "hubbard": dict(n_sites=3, n_elec=2, ph_bits=0, u=1.5, omega=0.7, g=0.0, t=1.0)}


def spawn_map(words, amps):
    out = {}
    for w, a in zip(np.asarray(words).tolist(), np.asarray(amps)):
        if a != 0:
            out[tuple(w)] = out.get(tuple(w), 0.0) + float(a)
    return out


def arena_of(jham, n=8, seed=0):
    """A reference arena of ``n`` random determinants reachable from the
    Neel state (hops and phonons applied at random) with random values."""
    rng = np.random.default_rng(seed)
    neel = jd.pack_bits(jd.neel_bits_1d(jham.n_sites, jham.n_elec, jham.n_bits), jham.n_words)
    keys = {tuple(np.asarray(neel).tolist())}
    frontier = np.asarray(neel)[None]
    while len(keys) < n:
        w, amp = jhub.offdiag_batch(jham, jnp.asarray(frontier), jnp.ones(len(frontier)), 1.0)
        w = np.asarray(w).reshape(-1, jham.n_words)[np.asarray(amp).reshape(-1) != 0]
        frontier = w[rng.permutation(len(w))[:8]]
        keys.update(map(tuple, frontier.tolist()))
    keys = np.asarray(sorted(keys)[:n], np.uint32)
    vals = rng.standard_normal(n)
    a = jar.from_unsorted(jar.make(32, jham.n_words, 1), jnp.asarray(keys), jnp.asarray(vals)[None])
    return a, jnp.where(a.valid, a.vals[0], 0.0)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_spawner_matches_reference(model, seed):
    """The spawner on an arena of 8 determinants, fed the reference's two
    uniforms, with an initiator cutoff that splits the parents."""
    jham, tham = jhub.HubbardHolstein(**MODELS[model]), thub.HubbardHolstein(**MODELS[model])
    cfg = dict(eps=0.02, vec_nonz=20, matr_samp=40, capacity=32, spawn_cap=64, init_thresh=0.8)
    js = jfh.make_spawner(jham, jfh.FrisysHHConfig(**cfg), 0.0)
    ts = tfh.make_spawner(tham, tfh.FrisysHHConfig(**cfg), 0.0)
    a, avals = arena_of(jham, seed=seed)
    key = jax.random.key(7 + seed)
    jw, jamp, jini = jax.jit(js)(a.keys, avals, -0.02, key)
    rns = torch.tensor(np.asarray(jax.random.uniform(key, (2,), dtype=jnp.float64)))
    tw, tamp, tini = ts(torch.as_tensor(np.asarray(a.keys).astype(np.int64)),
                        torch.as_tensor(np.asarray(avals)), -0.02, rns)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tini.numpy(), np.asarray(jini))
    np.testing.assert_allclose(tamp.numpy(), np.asarray(jamp), rtol=1e-12, atol=0)
    assert (np.asarray(jamp) != 0).sum() > 10 and 0 < np.asarray(jini).sum() < len(jini)


def test_spawner_exact_when_budget_large():
    """Budgets above the branch counts keep every branch, so the spawner
    reconstructs -eps * H_offdiag * v (tests/test_hubbard.py's check)."""
    ham = thub.HubbardHolstein(**MODELS["holstein"])
    cfg = tfh.FrisysHHConfig(eps=0.01, vec_nonz=64, matr_samp=4096, capacity=8, spawn_cap=512)
    spawn = tfh.make_spawner(ham, cfg, 0.0)
    neel = td.pack_bits(td.neel_bits_1d(3, 2, ham.n_bits), ham.n_words)
    v1 = thub.with_phonon(ham, neel[None], torch.tensor([1]), torch.tensor([2]))[0]
    a = tar.from_unsorted(tar.make(8, ham.n_words, 1), torch.stack([neel, v1]),
                          torch.tensor([[1.0, -0.4]], dtype=torch.float64))
    avals = torch.where(a.valid, a.vals[0], 0.0)
    w, amp, _ = spawn(a.keys, avals, -cfg.eps, torch.tensor([0.3, 0.6], dtype=torch.float64))
    ew, ea = thub.offdiag_batch(ham, a.keys, avals, -cfg.eps)
    got, want = spawn_map(w, amp), spawn_map(ew.reshape(-1, 1), ea.reshape(-1))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_frisys_hh_steps_match_reference(model):
    """Build, then ten steps (shift updates among them) from the reference's
    state after eight, each fed the reference's draws."""
    cfg = dict(eps=0.02, vec_nonz=20, matr_samp=40, capacity=128, spawn_cap=64,
               target_norm=150.0, shift_interval=2, init_thresh=3.0)
    jstep, _, jstate, jaux = jfh.build(jhub.HubbardHolstein(**MODELS[model]), 0.1,
                                       jfh.FrisysHHConfig(**cfg), seed=3)
    tstep, _, _, taux = tfh.build(thub.HubbardHolstein(**MODELS[model]), 0.1,
                                  tfh.FrisysHHConfig(**cfg), seed=3)
    for k in EST:
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    for _ in range(8):
        jstate, _ = jstep(jstate, *[jaux[k] for k in EST])
    _, jm = assert_steps_match(jstep, jstate, jaux, tstep, taux, 10)
    assert int(jm["n_dets"]) > 5


def test_frisys_hh_end_to_end():
    """Stochastic two-level FRI on the 3-site system estimates the dense
    ground-state energy (tests/test_hubbard.py's check, 1,500 steps)."""
    ham = thub.HubbardHolstein(**MODELS["holstein"])
    dense_h, _ = dense_hubbard.build_hamiltonian(3, 1, 1, ham.max_ph, ham.t, ham.u,
                                                 ham.omega, ham.g)
    e0 = float(np.linalg.eigvalsh(dense_h)[0])
    cfg = tfh.FrisysHHConfig(eps=0.02, vec_nonz=60, matr_samp=120, capacity=1024,
                             spawn_cap=512, target_norm=400.0)
    _, run_steps, state, aux = tfh.build(ham, e0, cfg, seed=3)
    _, traj = run_steps(state, *[aux[k] for k in EST], 1500)
    assert not bool(traj["overflow"].any())
    num, den = traj["proj_num"][500:].numpy(), traj["proj_den"][500:].numpy()
    e_est = e0 + num.sum() / den.sum()
    bm = np.array([b.sum() / d.sum() for b, d in zip(np.array_split(num, 10),
                                                       np.array_split(den, 10))])
    sigma = bm.std() / np.sqrt(len(bm))
    assert abs(e_est - e0) < max(5 * sigma, 0.03), (e_est, e0, sigma)


def test_cli_frisys_hh(tmp_path):
    params = write_params(tmp_path / "hubbard_params.txt")
    out = tmp_path / "run"
    base = ["frisys_hh", "--params_path", str(params), "--vec_nonz", "20", "--mat_nonz", "40",
            "--max_dets", "256", "--max_iter", "30", "--save_interval", "10", "--target",
            "150", "--seed", "5"]
    cli.main(base + ["--result_dir", str(out), "--device", "cpu"])
    for name in cli._STREAMS.values():
        assert np.loadtxt(out / name).shape == (30,), name
    assert np.isfinite(np.loadtxt(out / "projnum.txt")).all()
    assert "mat_nonz: 40" in (out / "params.txt").read_text()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(base + ["--result_dir", str(tmp_path / "cuda")])
    with pytest.raises(SystemExit):
        cli.main([x for x in base if x not in ("--mat_nonz", "40")] + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="overflow"):
        cli.main(base + ["--result_dir", str(tmp_path / "ovf"), "--device", "cpu",
                         "--max_dets", "4"])
