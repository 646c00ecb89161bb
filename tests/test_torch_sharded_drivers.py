"""The port's hash-sharded drivers in a 2-rank gloo world on the CPU, held
against the reference package: the systematic frisys step on each rank fed
the reference's sharded state and draws (each rank's arena equal to the
reference's shard), with no deterministic space and with one (the
semistochastic path of the reference's ``build_sharded``), and the reference's equivalences of
``tests/test_sharded.py`` (frifull, subspace ``exact_h``, the observables'
replica estimator: sharded equal to single to rtol 1e-9 / atol 1e-11).
The ranks run ``tests/torch_world.py``; the stochastic runs are in
``test_torch_sharded_runs.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dense_fci  # noqa: E402
import torch_world  # noqa: E402
from fries_tpu import parallel as jpar  # noqa: E402
from fries_tpu import synth as jsynth  # noqa: E402
from fries_tpu.drivers import frisys as jfs  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu_torch import dets as td  # noqa: E402
from fries_tpu_torch import parallel  # noqa: E402
from fries_tpu_torch.drivers import frifull, observables, power, subspace  # noqa: E402
from fries_tpu_torch.drivers import frisys as tfs  # noqa: E402
from fries_tpu_torch.runtime import shard as tsh  # noqa: E402

N_RANKS = 2
SYMM = np.array([0, 1, 0, 1, 0, 1, 2, 3])


def ham41():
    """``tests/test_sharded.py``'s system: random integrals, 5 orbitals, 4
    electrons."""
    h, eris = dense_fci.random_integrals(np.random.default_rng(41), 5)
    return {"hcore": h, "eris": eris, "symm": np.zeros(5, np.int64), "n_orb": 5, "n_elec": 4}


def ham_dict(j):
    return {"hcore": np.asarray(j.hcore), "eris": np.asarray(j.eris),
            "symm": np.asarray(j.symm), "n_orb": j.n_orb, "n_elec": j.n_elec}


def determ_space(t, n):
    """HF and the n - 1 determinants of largest |((H - E_HF) HF)|, ties by
    key: (n, W) uint32 words."""
    hf = td.hf_det(t.n_orb, t.n_elec)
    hk, hv = tfs.compute_htrial(t, hf[None].numpy(), np.ones(1))
    packed = td.pack_key(torch.as_tensor(hk)).numpy()
    rest = packed != int(td.pack_key(hf))
    order = np.lexsort((packed[rest], -np.abs(hv[rest])))[: n - 1]
    return np.concatenate([hf[None].numpy(), hk[rest][order]]).astype(np.uint32)


def frisys_steps_against_reference(cfg, determ_keys=None):
    """Three steps, each from the reference's 2-shard state (after 20 steps)
    converted to the port's per-rank states and fed the reference's draws:
    each rank's keys and counts exact, values and metrics at rtol 1e-10.
    Returns the ranks' arenas and the reference's metrics of each step."""
    j = jsynth.make_system(8, 4, symm=SYMM, seed=3)
    mesh = jpar.make_mesh(N_RANKS)
    _, jrun, jstate, jaux = jfs.build_sharded(
        j, jfs.FrisysConfig(**cfg, axis_name=jpar.AXIS), seed=4, mesh=mesh,
        determ_keys=None if determ_keys is None else jnp.asarray(determ_keys))
    est = [jaux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]

    def jstep(state):
        state, m = jrun(state, *est, 1, protected=jaux["protected_keys"])
        return state, {k: np.asarray(v).reshape(-1)[0] for k, v in m.items()}

    for _ in range(20):
        jstate, _ = jstep(jstate)
    states, draws, after, metrics = [], [], [], []
    for _ in range(3):
        a = jstate.arena
        states.append({"keys": np.asarray(a.keys), "vals": np.asarray(a.vals),
                       "n_used": np.asarray(a.n_used), "en_shift": np.asarray(jstate.en_shift),
                       "last_norm": np.asarray(jstate.last_norm),
                       "iterat": np.asarray(jstate.iterat)})
        k_spawn, k_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
        draws.append((np.asarray(jax.random.uniform(k_spawn, (6,), dtype=jnp.float64)),
                      float(jax.random.uniform(k_vec, dtype=jnp.float64))))
        jstate, jm = jstep(jstate)
        after.append(jstate.arena)
        metrics.append(jm)
    out = parallel.launch(torch_world.frisys_steps, N_RANKS, "gloo", "cpu",
                          args=(ham_dict(j), cfg, states, draws, determ_keys), timeout=100,
                          join_timeout=120)
    for s in range(3):
        ja = after[s]
        cap = np.asarray(ja.keys).shape[0] // N_RANKS
        for r in range(N_RANKS):
            ta, tm = out[r][s]
            rows = slice(r * cap, (r + 1) * cap)
            np.testing.assert_array_equal(ta["keys"], np.asarray(ja.keys)[rows].astype(np.int64))
            np.testing.assert_allclose(ta["vals"], np.asarray(ja.vals)[:, rows],
                                       rtol=1e-10, atol=1e-12)
            assert ta["n_used"] == int(np.asarray(ja.n_used)[r])
            for k, v in metrics[s].items():
                if np.asarray(v).dtype.kind == "f":
                    np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-10, err_msg=k)
                else:
                    assert int(tm[k]) == int(v), k
        assert min(int(x) for x in np.asarray(ja.n_used)) > 10   # both ranks hold rows
    return [[o[s][0] for o in out] for s in range(3)], metrics


def test_sharded_frisys_steps_match_reference():
    """The systematic step with no deterministic space."""
    frisys_steps_against_reference(
        dict(eps=0.02, vec_nonz=60, matr_samp=150, capacity=128, spawn_cap=200,
             target_norm=200.0, shift_interval=2, n_shards=N_RANKS, exchange_cap=256))


def test_sharded_semistochastic_steps_match_reference():
    """The reference's ``build_sharded`` with a deterministic space: the
    space replicated on every rank, each rank protecting the members it
    holds, the dense block's budget cut from the global ``matr_samp``; each
    rank keeps every member its hash names."""
    j = jsynth.make_system(8, 4, symm=SYMM, seed=3)
    dkeys = determ_space(torch_world.ham_of(ham_dict(j)), 8)
    owner = tsh.shard_of_words(torch.as_tensor(dkeys.astype(np.int64)), N_RANKS).numpy()
    assert set(owner) == {0, 1}   # both ranks protect members of the space
    arenas, metrics = frisys_steps_against_reference(
        dict(eps=0.02, vec_nonz=60, matr_samp=700, capacity=256, spawn_cap=400,
             target_norm=110.0, shift_interval=2, n_shards=N_RANKS, exchange_cap=800),
        dkeys)
    for step in arenas:
        for r, ta in enumerate(step):
            _, found = td.lookup_dets(torch.as_tensor(ta["keys"][:ta["n_used"]]),
                                      torch.as_tensor(dkeys[owner == r].astype(np.int64)))
            assert bool(found.all()), r
    assert int(metrics[-1]["n_dets"]) > 40


@pytest.fixture(scope="module")
def world_runs():
    """One 2-rank world for the equivalence runs, and the single runs of the
    same configurations."""
    hd = ham41()
    h, eris, n_orb = hd["hcore"], hd["eris"], hd["n_orb"]
    dense_h, basis = dense_fci.build_hamiltonian(h, eris, n_orb, 2, 2)
    evals, evecs = np.linalg.eigh(dense_h)
    t_keys, t_vals = [], []
    for jj in range(2):
        top = np.argsort(-np.abs(evecs[:, jj]))[:10]
        t_keys.append(np.stack([dense_fci.mask_to_words(basis[i], 2 * n_orb) for i in top]))
        t_vals.append(evecs[top, jj])
    t_keys, t_vals = np.stack(t_keys).astype(np.int64), np.stack(t_vals)
    ff = dict(eps=0.05, target_nonz=256, capacity=96, n_shards=N_RANKS, exchange_cap=4096)
    ss = dict(eps=0.05, n_trial=2, vec_nonz=4096, matr_samp=4096, capacity=96,
              spawn_cap=4096, restart_int=10, exact_h=True, compress_mode="sys",
              n_shards=N_RANKS, exchange_cap=4096)
    ob = dict(eps=0.05, target_nonz=4096, obs_des=0, obs_cre=3, burn_in=3, n_obs=4,
              btw_obs=4, replica=True, capacity=96, n_shards=N_RANKS, exchange_cap=4096)
    runs = [("frifull", dict(cfg=ff, n_iter=30)),
            ("subspace", dict(cfg=ss, t_keys=t_keys, t_vals=t_vals, n_iter=15)),
            ("observables", dict(cfg=ob, n_iter=12))]
    sharded = parallel.launch(torch_world.equivalences, N_RANKS, "gloo", "cpu", args=(hd, runs),
                              timeout=110, join_timeout=120)
    ham = torch_world.ham_of(hd)
    single = {}
    cfg = power.PowerConfig(**{**ff, "capacity": 128, "n_shards": 1, "exchange_cap": 0})
    _, run, st, aux = frifull.build(ham, cfg, seed=0)
    single["frifull"] = run(st, *[aux[k] for k in ("num_keys", "num_vals", "den_keys",
                                                    "den_vals", "ref_key")], 30)[1]
    cfg = subspace.SubspaceConfig(**{**ss, "capacity": 256, "n_shards": 1, "exchange_cap": 0})
    _, run, st, _ = subspace.build(ham, cfg, t_keys, t_vals, seed=0)
    single["subspace"] = run(st, 15)[1]
    cfg = observables.ObservablesConfig(**{**ob, "capacity": 256, "n_shards": 1,
                                           "exchange_cap": 0})
    _, run, st, _ = observables.build(ham, cfg, seed=0)
    single["observables"] = run(st, 12)[1]
    return sharded, single


def _same_on_every_rank(sharded, name):
    """The replicated metrics of rank 0 after checking the other ranks agree
    (``spawn_rows`` and ``n_merges`` count each rank's own work)."""
    for r in range(1, N_RANKS):
        for k, v in sharded[0][name].items():
            if k not in ("spawn_rows", "n_merges"):
                np.testing.assert_array_equal(sharded[r][name][k].numpy(), v.numpy(),
                                              err_msg=k)
    return sharded[0][name]


def test_sharded_frifull_matches_single(world_runs):
    sharded, single = world_runs
    tr8, tr1 = _same_on_every_rank(sharded, "frifull"), single["frifull"]
    assert not tr1["overflow"].any() and not tr8["overflow"].any()
    e1 = (tr1["proj_num"] / tr1["proj_den"]).numpy()
    e8 = (tr8["proj_num"] / tr8["proj_den"]).numpy()
    np.testing.assert_allclose(e8, e1, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(tr8["norm"].numpy(), tr1["norm"].numpy(), rtol=1e-9)
    np.testing.assert_array_equal(tr8["n_dets"].numpy(), tr1["n_dets"].numpy())


def test_sharded_subspace_exact_h_matches_single(world_runs):
    sharded, single = world_runs
    tr8, tr1 = _same_on_every_rank(sharded, "subspace"), single["subspace"]
    assert not tr1["overflow"].any() and not tr8["overflow"].any()
    for k in ("h_mat", "d_mat"):
        np.testing.assert_allclose(tr8[k].numpy(), tr1[k].numpy(), rtol=1e-9, atol=1e-11,
                                   err_msg=k)


def test_sharded_observables_replica_matches_single(world_runs):
    sharded, single = world_runs
    tr8, tr1 = _same_on_every_rank(sharded, "observables"), single["observables"]
    assert not tr1["overflow"].any() and not tr8["overflow"].any()
    for k in ("obs_num", "obs_den"):
        np.testing.assert_allclose(tr8[k].numpy(), tr1[k].numpy(), rtol=1e-9, atol=1e-11,
                                   err_msg=k)


def test_single_run_matches_reference_frifull(world_runs):
    """The single run the equivalences compare with is the reference's:
    frifull's 30 steps against ``fries_tpu.drivers.frifull`` on one device."""
    from fries_tpu.drivers import frifull as jff
    from fries_tpu.drivers import power as jpow

    hd = ham41()
    h, eris = hd["hcore"], hd["eris"]
    j = jmol.MolecularHamiltonian(hcore=jnp.asarray(h), eris=jnp.asarray(eris),
                                  symm=jnp.zeros(5, jnp.int32), n_orb=5, n_elec=4)
    _, run1, st1, aux1 = jff.build(j, jpow.PowerConfig(eps=0.05, target_nonz=256, capacity=128),
                                   seed=0)
    _, jtr = run1(st1, aux1["num_keys"], aux1["num_vals"], aux1["den_keys"],
                  aux1["den_vals"], aux1["ref_key"], 30)
    ttr = world_runs[1]["frifull"]
    np.testing.assert_allclose(ttr["proj_num"].numpy() / ttr["proj_den"].numpy(),
                               np.asarray(jtr["proj_num"]) / np.asarray(jtr["proj_den"]),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_array_equal(ttr["n_dets"].numpy(), np.asarray(jtr["n_dets"]).reshape(-1))
