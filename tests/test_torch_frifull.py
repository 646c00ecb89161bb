"""The port's exact-H workload (frifull_mol) against the reference package:
``dedup_spawns`` against the reference's and against a direct accumulate;
the flat, chunked and chunked-with-dedup steps against each other; the
prefix spawn (``spawn_rows``); six frifull steps from the reference's state
(flat, chunked, chunked with dedup and ``spawn_rows``, ``spin_parity`` 0
and +1) with the before/after estimator; the exact power method against
dense FCI; and the plain merge in the chunked regime (a non-zero destination
row, no keep mask, a stream of mostly sentinel keys with every target
repeated) against the reference's XLA merge and its Pallas merge in
interpret mode.  Keys, counts and flags exact; values at 1e-12 (functions)
and 1e-10 (steps)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dense_fci  # noqa: E402
from fries_tpu import synth as jsynth  # noqa: E402
from fries_tpu.drivers import frifull as jff, power as jpower  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import cli, convert, dets as td, io as tio, rung  # noqa: E402
from fries_tpu_torch.drivers import frifull as tff, frisys as tfs, power as tpower  # noqa: E402
from fries_tpu_torch.runtime import arena as tar  # noqa: E402
from test_torch_arena import assert_same, both_references, port_merge, rand_case  # noqa: E402

EST = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")


def t64(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def dedup_case(rng, s=4096, w=2, n_keys=120):
    """tests/test_arena.py's stream: heavy duplication, a tenth of the rows
    sentinel keys and some zero values."""
    sk = np.zeros((s, w), np.uint32)
    sk[:, 0] = rng.choice(n_keys, size=s) + 1
    sv = rng.standard_normal(s)
    si = rng.random(s) < 0.5
    kill = rng.random(s) < 0.1
    sk[kill] = np.iinfo(np.uint32).max
    sv[kill] = 0.0
    sv[rng.random(s) < 0.05] = 0.0
    return sk, sv, si


@pytest.mark.parametrize("w", [1, 2])
def test_dedup_spawns_matches_reference(w):
    """Rows exact; sums within 1e-12 of the stream's total mass (the
    reference sums a segment as a difference of two running sums)."""
    rng = np.random.default_rng(5 + w)
    sk, sv, si = dedup_case(rng, w=w)
    cap = 256
    jk, jv, ji, jovf = jar.dedup_spawns(jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(si), cap)
    tk, tv, ti, tovf = tar.dedup_spawns(t64(sk), torch.tensor(sv), torch.tensor(si), cap)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-12 * np.abs(sv).sum())
    assert not bool(tovf) and not bool(jovf)
    assert 200 < int((~td.is_invalid(tk)).sum()) <= 240


def test_dedup_spawns_matches_direct_accumulate():
    """accumulate(dedup(stream)) equals accumulate(stream), initiator gating
    included."""
    rng = np.random.default_rng(5)
    base = tar.from_unsorted(
        tar.make(64, 2, 2),
        torch.stack([torch.as_tensor(rng.choice(100, size=8, replace=False) + 1),
                     torch.zeros(8, dtype=torch.int64)], dim=1),
        torch.tensor(np.stack([rng.standard_normal(8), np.zeros(8)])))
    sk, sv, si = dedup_case(rng)
    args = (t64(sk), torch.tensor(sv), torch.tensor(si))
    a1, st1 = tar.accumulate(base, *args, origin_row=0, dest_row=1)
    dk, dv, di, ovf = tar.dedup_spawns(*args, 256)
    assert not bool(ovf)
    a2, st2 = tar.accumulate(base, dk, dv, di, origin_row=0, dest_row=1)
    assert bool(st1["overflow"]) == bool(st2["overflow"])
    assert int(st1["nonini_occ_add"]) > 0
    np.testing.assert_array_equal(a1.keys.numpy(), a2.keys.numpy())
    np.testing.assert_allclose(a1.vals.numpy(), a2.vals.numpy(), rtol=1e-12, atol=1e-12)


def test_dedup_spawns_overflow_flag():
    sk = np.zeros((64, 2), np.int64)
    sk[:, 0] = np.arange(64) + 1
    args = (torch.as_tensor(sk), torch.ones(64, dtype=torch.float64),
            torch.zeros(64, dtype=torch.bool))
    keys, vals, _, ovf = tar.dedup_spawns(*args, 32)
    assert bool(ovf)
    np.testing.assert_array_equal(keys.numpy(), sk[:32])   # the first cap segments
    np.testing.assert_array_equal(vals.numpy(), np.ones(32))
    assert not bool(tar.dedup_spawns(*args, 64)[3])


def test_arena_dot_and_n_nonzero():
    rng = np.random.default_rng(9)
    keys = rng.choice(2**16, size=(30, 1), replace=False).astype(np.uint32)
    vals = rng.standard_normal((2, 30))
    vals[0, ::5] = 0.0
    ja = jar.from_unsorted(jar.make(64, 1, 2), jnp.asarray(keys), jnp.asarray(vals))
    ta = tar.from_unsorted(tar.make(64, 1, 2), t64(keys), torch.tensor(vals))
    q = np.concatenate([keys[:12], rng.integers(2**16, 2**17, size=(5, 1)).astype(np.uint32)])
    qv = rng.standard_normal(17)
    for row in (0, 1):
        np.testing.assert_allclose(
            float(tar.dot(ta, t64(q), torch.tensor(qv), row)),
            float(jar.dot(ja, jnp.asarray(q), jnp.asarray(qv), row)), rtol=1e-12)
        assert int(tar.n_nonzero(ta, row)) == int(jar.n_nonzero(ja, row))


# ---------------------------------------------------------------------------
# the plain merge in the chunked spawn-and-merge regime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sentinel_frac", [0.0, 0.8, 0.95])
def test_merge_chunked_regime(sentinel_frac):
    """Two chunks merged one after the other into value row 1 with no keep
    mask: S = 6 C, most of the stream the sentinel key, every target repeated
    many times.  The second merge meets a non-zero destination row and rows
    that the first chunk inserted (origin value 0, so a non-initiator spawn
    onto them does not count)."""
    rng = np.random.default_rng(int(100 * sentinel_frac))
    c = 256
    a, _, _, _ = rand_case(rng, 2, c, 60, 8, 150, n_vecs=2)
    uni = rand_case(rng, 2, c, 60, 8, 150)[0]
    targets = np.concatenate([np.asarray(a.keys)[:60], np.asarray(uni.keys)[:60]])
    ta = None
    for chunk in range(2):
        s = 6 * c
        sk = targets[rng.integers(0, len(targets), s)].copy()
        sk[rng.random(s) < sentinel_frac] = np.iinfo(np.uint32).max
        sv, si = rng.standard_normal(s) * 0.3, rng.random(s) < 0.5
        got, gstats = port_merge(a, sk, sv, si, 0, 1)
        if ta is not None:   # the port's own running arena gives the same
            own, _ = tar.accumulate(ta, t64(sk), torch.tensor(sv), torch.tensor(si), 0, 1)
            np.testing.assert_array_equal(own.keys.numpy(), got.keys.numpy())
            np.testing.assert_allclose(own.vals.numpy(), got.vals.numpy(), rtol=1e-12,
                                       atol=1e-12)
        refs = list(both_references(a, sk, sv, si, 0, 1))
        assert_same(got, gstats, *refs[0])
        pref, pstats = refs[1]
        n = int(pref.n_used[0])
        assert int(got.n_used[0]) == n
        assert int(gstats["nonini_occ_add"]) == int(pstats["nonini_occ_add"])
        np.testing.assert_array_equal(got.keys.numpy()[:n],
                                      np.asarray(pref.keys).astype(np.int64)[:n])
        np.testing.assert_allclose(got.vals.numpy()[:, :n], np.asarray(pref.vals)[:, :n],
                                   rtol=1e-12, atol=1e-12)
        if chunk == 1:
            assert (np.asarray(a.vals)[1, :n] != 0).sum() > 30      # dest row carried
            assert ((np.asarray(a.vals)[0, :n] == 0) & (np.asarray(a.vals)[1, :n] != 0)).any()
        a, ta = refs[0][0], got
    assert int(got.n_used[0]) > 60 and not bool(gstats["overflow"])


# ---------------------------------------------------------------------------
# frifull steps
# ---------------------------------------------------------------------------

SYMM6 = np.array([0, 1, 0, 1, 2, 3])
VARIANTS = {
    "flat": dict(),
    "chunked": dict(batch=16),
    "chunked_dedup": dict(batch=16, dedup_cap=512),
    "spawn_rows": dict(batch=16, spawn_rows=80),
    "flat_spawn_rows": dict(spawn_rows=80),
}


def pair(spin_parity, **kw):
    j = jsynth.make_system(6, 4, symm=SYMM6, seed=2)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), SYMM6, 6, 4)
    cfg = dict(eps=0.02, target_nonz=40, capacity=256, target_norm=101.0,
               shift_interval=2, init_thresh=1.0, **kw)
    jstep, _, jstate, jaux = jff.build(j, jpower.PowerConfig(**cfg), seed=4,
                                      spin_parity=spin_parity)
    tstep, _, tstate, taux = tff.build(t, tpower.PowerConfig(**cfg), seed=4,
                                      spin_parity=spin_parity)
    return jstep, jstate, jaux, tstep, tstate, taux


@pytest.mark.parametrize("variant,spin_parity", [
    ("flat", 0), ("chunked", 0), ("chunked_dedup", 0), ("spawn_rows", 0),
    ("flat_spawn_rows", 0), ("flat", 1), ("chunked_dedup", 1)])
def test_frifull_steps_match_reference(variant, spin_parity):
    """Six steps, each from the reference's state converted to the port and
    fed the reference's compression draw: keys, counts and flags exact,
    values and the before/after estimator at rtol 1e-10."""
    jstep, jstate, jaux, tstep, tstate, taux = pair(spin_parity, **VARIANTS[variant])
    assert taux["e_ref"] == float(jaux["e_ref"])
    np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                  np.asarray(jstate.arena.keys).astype(np.int64))
    jargs = [jaux[k] for k in EST]
    targs = [taux[k] for k in EST]
    for _ in range(12):
        jstate, _ = jstep(jstate, *jargs)
    for _ in range(6):
        a = jstate.arena
        tstate = convert.power_state(
            convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used)),
            jstate.en_shift, jstate.last_norm, jstate.iterat)
        _, key_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
        rn = float(jax.random.uniform(key_vec, dtype=jnp.float64))
        jstate, jm = jstep(jstate, *jargs)
        tstate, tm = tstep(tstate, *targs, rn_vec=rn)
        ja = jstate.arena
        np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                      np.asarray(ja.keys).astype(np.int64))
        np.testing.assert_allclose(tstate.arena.vals.numpy(), np.asarray(ja.vals),
                                   rtol=1e-10, atol=1e-12)
        assert int(tstate.arena.n_used[0]) == int(ja.n_used[0])
        for k, v in jm.items():
            v = np.asarray(v).reshape(-1)[0]
            if v.dtype.kind == "f":
                np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-10, err_msg=k)
            else:
                assert int(tm[k]) == int(v), k
    assert int(jm["n_dets"].reshape(-1)[0]) >= 30 and int(jm["nnonz"]) >= 30
    assert 0 < int(jm["n_ini"]) < 30 and float(jm["shift"]) != 0.0
    assert not bool(jm["overflow"])


def run_port(ham, n_iter, **kw):
    cfg = tpower.PowerConfig(**kw)
    _, run_steps, state, aux = tff.build(ham, cfg, seed=0)
    state, traj = run_steps(state, *[aux[k] for k in EST], n_iter)
    return state, traj, aux


@pytest.fixture(scope="module")
def fci_system():
    rng = np.random.default_rng(11)
    h, eris = dense_fci.random_integrals(rng, 5)
    dense_h, _ = dense_fci.build_hamiltonian(h, eris, 5, 2, 2)
    return convert.hamiltonian(h, eris, np.zeros(5), 5, 4), dense_fci.ground_state(dense_h)[0]


def test_flat_chunked_dedup_agree(fci_system):
    """batch > 0 spawns and merges chunk by chunk, dedup_cap collapses each
    chunk's stream first: the trajectories equal the flat path's."""
    ham, _ = fci_system
    base = dict(eps=0.05, target_nonz=256, capacity=128)
    out = {}
    for name, kw in (("flat", {}), ("chunked", dict(batch=16)),
                     ("dedup", dict(batch=16, dedup_cap=512))):
        state, traj, _ = run_port(ham, 6, **base, **kw)
        assert not bool(traj["overflow"].any())
        out[name] = (traj, state)
    for name in ("chunked", "dedup"):
        for k in ("proj_num", "proj_den", "norm"):
            np.testing.assert_allclose(out[name][0][k].numpy(), out["flat"][0][k].numpy(),
                                       rtol=1e-9, err_msg=f"{name} {k}")
        n = int(out[name][1].arena.n_used[0])
        flat = out["flat"][1].arena
        live = (flat.vals[0] != 0) | td.det_eq(flat.keys, td.hf_det(5, 4)[None])
        np.testing.assert_array_equal(out[name][1].arena.keys.numpy()[:n],
                                      flat.keys.numpy()[live.numpy()])
    assert int(out["chunked"][0]["n_dets"][-1]) == int(out["chunked"][1].arena.n_used[0])


def test_before_after_estimator_converges_to_fci(fci_system):
    """A budget above the Hilbert space makes the iteration an exact power
    method: the before/after estimator converges to the FCI energy."""
    ham, e0 = fci_system
    _, traj, aux = run_port(ham, 400, eps=0.05, target_nonz=256, capacity=128)
    assert not bool(traj["overflow"].any())
    e_est = (traj["proj_num"] / traj["proj_den"]).numpy()
    np.testing.assert_allclose(aux["e_ref"] + e_est[-1], e0, atol=2e-4)
    assert abs(e_est[-1] - e_est[-2]) < 1e-5


def test_spawn_rows_prefix_exact():
    """The prefix spawn (PowerConfig.spawn_rows) is bit-exact while the
    arena's occupied prefix fits the bound, and raises the overflow flag
    when it does not (tests/test_frisys.py's case, the frisys spawner)."""
    rng = np.random.default_rng(9)
    h, eris = dense_fci.random_integrals(rng, 5)
    ham = convert.hamiltonian(h, eris, np.zeros(5), 5, 4)

    def run(spawn_rows):
        cfg = tfs.FrisysConfig(eps=0.05, vec_nonz=24, matr_samp=200, capacity=256,
                               spawn_cap=512, target_norm=50.0, spawn_rows=spawn_rows)
        _, run_steps, state, aux = tfs.build(ham, cfg, seed=3)
        _, m = run_steps(state, *[aux[k] for k in EST], 6)
        return m["proj_num"].numpy(), m["norm"].numpy(), bool(m["overflow"].any())

    full_num, full_norm, full_ovf = run(0)
    pre_num, pre_norm, pre_ovf = run(128)   # the FCI dimension is 100
    assert not full_ovf and not pre_ovf
    np.testing.assert_array_equal(full_num, pre_num)
    np.testing.assert_array_equal(full_norm, pre_norm)
    assert run(32)[2]       # a bound below the merged support trips the flag


def test_odd_sector_from_closed_shell_hf_raises(fci_system):
    ham, _ = fci_system
    with pytest.raises(ValueError, match="self-conjugate"):
        tff.build(ham, tpower.PowerConfig(eps=0.05, target_nonz=64, capacity=128), seed=0,
                  spin_parity=-1)


def test_chunked_wrapper_matches_whole_batch(fci_system):
    """power.chunked pads, spawns chunk by chunk and trims to the rows of a
    whole-batch spawn."""
    ham, _ = fci_system
    cfg = tpower.PowerConfig(eps=0.05, target_nonz=64, capacity=32, batch=5)
    state, _, aux = run_port(ham, 3, eps=0.05, target_nonz=64, capacity=32)
    seen = {}

    def spawn_one(keys, vals, h_fac, rns):
        seen.setdefault("batches", []).append(keys.shape[0])
        return keys.repeat_interleave(3, 0), vals.repeat_interleave(3) * h_fac, \
            tpower.per_parent_ini(vals, 0.5, 3)

    a = state.arena
    w, amp, ini = tpower.chunked(spawn_one, cfg.capacity, cfg.batch, 1)(
        a.keys, a.vals[0], -0.05, None)
    assert seen["batches"] == [5] * 7
    rw, ramp, rini = spawn_one(a.keys, a.vals[0], -0.05, None)
    np.testing.assert_array_equal(w.numpy(), rw.numpy())
    np.testing.assert_array_equal(amp.numpy(), ramp.numpy())
    np.testing.assert_array_equal(ini.numpy(), rini.numpy())
    assert tpower.chunked(spawn_one, 32, 0, 1) is spawn_one


def test_cli_frifull_mol(tmp_path):
    """frifull_mol from an FCIDUMP the test writes: the reference's output
    streams (it takes no --mat_nonz), the exact energy of a budget above the
    Hilbert space, and no run without a card unless the CPU is asked for."""
    rng = np.random.default_rng(11)
    h, eris = dense_fci.random_integrals(rng, 5)
    dense_h, _ = dense_fci.build_hamiltonian(h, eris, 5, 2, 2)
    ham = convert.hamiltonian(h, eris, np.zeros(5), 5, 4)
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(ham, fcidump)
    out = tmp_path / "run"
    argv = ["frifull_mol", "--fcidump_path", str(fcidump), "--epsilon", "0.05",
            "--vec_nonz", "256", "--max_dets", "128", "--max_iter", "300",
            "--save_interval", "100", "--result_dir", str(out)]
    cli.main(argv + ["--device", "cpu"])
    for name in cli._STREAMS.values():
        assert np.loadtxt(out / name).shape == (300,), name
    e_est = np.loadtxt(out / "projnum.txt")[-1] / np.loadtxt(out / "projden.txt")[-1]
    e_hf = float(tff.build(ham, tpower.PowerConfig(eps=0.05, target_nonz=8, capacity=8),
                           seed=0)[3]["e_ref"])
    np.testing.assert_allclose(e_hf + e_est, dense_fci.ground_state(dense_h)[0], atol=1e-3)
    assert len((out / "arena_occ.txt").read_text().splitlines()) == 3
    with pytest.raises(SystemExit):   # argparse: frifull_mol has no --mat_nonz
        cli.main(argv + ["--device", "cpu", "--mat_nonz", "100"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(argv)


def test_rung_frifull_is_bench_frifull_mol():
    """fries_tpu_torch.rung's frifull configuration is bench.py's
    bench_frifull_mol, its synthetic branch: the system's arguments, every
    PowerConfig field (the real branch's values where the two differ are the
    dedup variant's), seed 0, and 48 chunks per step."""
    import ast

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "bench_frifull_mol")
    calls = {getattr(n.func, "attr", None): n for n in ast.walk(fn) if isinstance(n, ast.Call)}
    value = lambda node: eval(compile(ast.Expression(node), "bench.py", "eval"))
    system = calls["make_system"]
    assert [value(a) for a in system.args] == [14, 6]
    assert {k.arg: value(k.value) for k in system.keywords} == dict(seed=1, scale_two=0.1)
    ham = rung.frifull_system()
    want = jsynth.make_system(14, 6, seed=1, scale_two=0.1)
    np.testing.assert_array_equal(ham.hcore.numpy(), np.asarray(want.hcore))
    np.testing.assert_array_equal(ham.eris.numpy(), np.asarray(want.eris))
    cfg, dedup = rung.frifull_config(), rung.frifull_config(1 << 19)
    for kw in calls["PowerConfig"].keywords:
        if isinstance(kw.value, ast.IfExp):   # real-molecule branch if, synthetic else
            assert getattr(cfg, kw.arg) == value(kw.value.orelse), kw.arg
            if kw.arg == "dedup_cap":
                assert dedup.dedup_cap == value(kw.value.body)
        else:
            assert getattr(cfg, kw.arg) == getattr(dedup, kw.arg) == value(kw.value), kw.arg
    assert {k.arg: value(k.value) for k in calls["build"].keywords} == dict(seed=0)
    assert cfg.spawn_rows // cfg.batch == 48 and cfg.spawn_rows % cfg.batch == 0
    tmpl = tff.mol.ExcitationTemplate.build(14, 6)
    assert tmpl.n_doub + tmpl.n_sing == 2394
