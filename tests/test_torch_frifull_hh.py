"""The port's frifull_hh driver against the reference package: the build
(Neel state, connected set), ten steps from the reference's state fed the
reference's compression draws (one merge of the whole stream, and chunked
through ``power.chunked``), convergence to the dense ground state, the
command line, and the rung's configuration against bench.py's.  Keys,
counts and flags exact; values at rtol 1e-10."""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dense_hubbard  # noqa: E402
from fries_tpu.drivers import frifull_hh as jff, power as jpower  # noqa: E402
from fries_tpu.ops import hubbard as jhub  # noqa: E402
from fries_tpu_torch import cli, convert, rung  # noqa: E402
from fries_tpu_torch.drivers import frifull_hh as tff, power as tpower  # noqa: E402
from fries_tpu_torch.ops import hubbard as thub  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EST = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")
SMALL = dict(n_sites=3, n_elec=2, ph_bits=2, u=1.5, omega=0.7, g=0.4, t=1.0)


def reference_draws(jstate):
    """The reference step's spawn and vector-compression uniforms."""
    key_spawn, key_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
    return (np.asarray(jax.random.uniform(key_spawn, (2,), dtype=jnp.float64)),
            float(jax.random.uniform(key_vec, dtype=jnp.float64)))


def port_state(jstate):
    a = jstate.arena
    return convert.power_state(
        convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used)),
        jstate.en_shift, jstate.last_norm, jstate.iterat)


def assert_steps_match(jstep, jstate, jaux, tstep, taux, n_steps):
    """``n_steps`` steps, each from the reference's state converted to the
    port and fed the reference's draws."""
    jargs, targs = [jaux[k] for k in EST], [taux[k] for k in EST]
    for _ in range(n_steps):
        tstate = port_state(jstate)
        rns, rn = reference_draws(jstate)
        jstate, jm = jstep(jstate, *jargs)
        tstate, tm = tstep(tstate, *targs, rns=rns, rn_vec=rn)
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
    return jstate, jm


@pytest.mark.parametrize("batch", [0, 8])
def test_frifull_hh_steps_match_reference(batch):
    """Build, then ten steps (a shift update among them) from the
    reference's state after five."""
    cfg = dict(eps=0.02, target_nonz=20, capacity=256, target_norm=150.0, shift_interval=2,
               init_thresh=5.0, batch=batch)
    jstep, _, jstate, jaux = jff.build(jhub.HubbardHolstein(**SMALL), 0.1,
                                       jpower.PowerConfig(**cfg), seed=3)
    tstep, _, tstate, taux = tff.build(thub.HubbardHolstein(**SMALL), 0.1,
                                       tpower.PowerConfig(**cfg), seed=3)
    for k in EST:
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                  np.asarray(jstate.arena.keys).astype(np.int64))
    np.testing.assert_array_equal(tstate.arena.vals.numpy(), np.asarray(jstate.arena.vals))
    jargs = [jaux[k] for k in EST]
    for _ in range(5):
        jstate, _ = jstep(jstate, *jargs)
    _, jm = assert_steps_match(jstep, jstate, jaux, tstep, taux, 10)
    assert int(jm["n_dets"]) > 15 and float(jm["shift"]) != 0.0


def test_frifull_hh_converges_to_dense():
    """The exact power method on the 3-site system reaches the dense ground
    state (tests/test_hubbard.py's check)."""
    ham = thub.HubbardHolstein(**SMALL)
    dense_h, _ = dense_hubbard.build_hamiltonian(3, 1, 1, ham.max_ph, ham.t, ham.u,
                                                 ham.omega, ham.g)
    e0 = float(np.linalg.eigvalsh(dense_h)[0])
    cfg = tpower.PowerConfig(eps=0.05, target_nonz=2048, capacity=1024)
    _, run_steps, state, aux = tff.build(ham, e0, cfg, seed=0)
    _, traj = run_steps(state, *[aux[k] for k in EST], 600)
    assert not bool(traj["overflow"].any())
    est = float(traj["proj_num"][-1]) / float(traj["proj_den"][-1])
    np.testing.assert_allclose(e0 + est, e0, atol=5e-4)


def write_params(path, g=0.4):
    path.write_text(f"n_elec\n2\nlat_len\n3\nn_dim\n1\neps\n0.02\nU\n1.5\nomega\n0.7\n"
                    f"g\n{g}\ngs_energy\n-1.0\n")
    return path


def test_cli_frifull_hh(tmp_path):
    params = write_params(tmp_path / "hubbard_params.txt")
    out = tmp_path / "run"
    base = ["frifull_hh", "--params_path", str(params), "--vec_nonz", "20", "--max_dets",
            "256", "--max_iter", "30", "--save_interval", "10", "--target", "150",
            "--ph_bits", "2"]
    cli.main(base + ["--result_dir", str(out), "--device", "cpu"])
    for name in cli._STREAMS.values():
        assert np.loadtxt(out / name).shape == (30,), name
    assert np.isfinite(np.loadtxt(out / "projnum.txt")).all()
    assert "ph_bits: 2" in (out / "params.txt").read_text()
    assert len((out / "arena_occ.txt").read_text().splitlines()) == 3
    if not torch.cuda.is_available():
        for extra in ([], ["--device", "cuda"]):
            with pytest.raises(SystemExit, match="no CUDA device"):
                cli.main(base + ["--result_dir", str(tmp_path / "cuda")] + extra)
    with pytest.raises(NotImplementedError):
        cli.main(base + ["--device", "cpu", "--n_chips", "2"])


def test_cli_frifull_hh_pure_hubbard(tmp_path):
    """g = 0 drops the phonon bits whatever --ph_bits says: 2 * 3 bits, 12
    candidates."""
    params = write_params(tmp_path / "hubbard_params.txt", g=0.0)
    out = tmp_path / "run"
    cli.main(["frifull_hh", "--params_path", str(params), "--vec_nonz", "20", "--max_dets",
              "64", "--max_iter", "20", "--result_dir", str(out), "--device", "cpu"])
    assert np.loadtxt(out / "N.txt").max() <= 9     # (3 choose 1)^2 determinants


def bench_call(fn_name, callee):
    """The keyword arguments of ``callee(...)`` inside bench.py's
    ``fn_name``."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == callee)
    return {kw.arg: eval(compile(ast.Expression(kw.value), "bench.py", "eval"))
            for kw in call.keywords}


def test_rung_frifull_hh_is_bench_frifull_hh():
    """fries_tpu_torch.rung's frifull_hh is bench.py's bench_frifull_hh:
    the same model and the same power configuration (its 2^17 arena holds
    the run: about 43,000 merged rows on the card)."""
    model = bench_call("bench_frifull_hh", "HubbardHolstein")
    ham = rung.frifull_hh_system()
    assert {k: getattr(ham, k) for k in model} == model
    assert ham.t == 1.0
    cfg = rung.frifull_hh_config()
    for k, v in bench_call("bench_frifull_hh", "PowerConfig").items():
        assert getattr(cfg, k) == v, k
    assert (cfg.batch, cfg.init_thresh, cfg.capacity) == (0, 0.0, 1 << 17)
