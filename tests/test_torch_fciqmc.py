"""The port's FCIQMC against the reference package.

Each case builds both packages from one numpy-seeded Hamiltonian, runs the
reference 20 steps, carries its state into the port
(``convert.fciqmc_state``, the reference's key behind ``jax_keys.JaxKeys``)
and steps both 10 times: arena keys, ``n_used`` and the integer metrics
exact, values exact for integer walkers and within rtol 1e-12 for fp
walkers, the float metrics within rtol 1e-12.  The heat-bath step is held
exactly too: its f32 row prefixes may differ from the reference's in the
last bit (``compress.sample_categorical_rows``), which moves an index with a
chance near 1e-7 per row, none in these steps.  Also: the build's estimator
vectors, the overflow flag when the attempt or the spawn buffer is too
small, the integer-walker energy of the port's own key tree against dense
FCI, the package without JAX, the command line, and the ``fciqmc``
configuration against bench.py's.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dense_fci  # noqa: E402
from fries_tpu.drivers import fciqmc as jfq  # noqa: E402
from fries_tpu_torch import cli, convert, io as tio, rung  # noqa: E402
from fries_tpu_torch.drivers import fciqmc as tfq  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402
from test_torch_near_uniform import build_ham  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMM5 = [0, 1, 0, 1, 0]
SYMM8 = [0, 1, 0, 1, 0, 1, 2, 3]
BASE = dict(eps=0.02, target_walkers=600.0, capacity=256, attempt_cap=4096, init_thresh=2.0,
            shift_damping=0.25, shift_interval=4)
CASES = {
    "NU-integer": ((5, 4, None, 13), dict(distribution="NU")),
    "NU-fp": ((5, 4, SYMM5, 13), dict(distribution="NU", integer_walkers=False)),
    "HB-integer-spawn_cap": ((8, 4, SYMM8, 3), dict(distribution="HB", spawn_cap=1024)),
}


def reference_args(aux):
    return tuple(aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key"))


def to_port(jstate):
    a = jstate.arena
    return convert.fciqmc_state(convert.arena(np.asarray(a.keys), np.asarray(a.vals),
                                              np.asarray(a.n_used)),
                                jstate.en_shift, jstate.last_norm, jstate.iterat,
                                JaxKeys(jstate.key))


def pair(system, **cfg):
    n_orb, n_elec, symm, seed = system
    j, t, _, _ = build_ham(n_orb, n_elec, symm, seed)
    jstep, _, jstate, jaux = jfq.build(j, jfq.FciqmcConfig(**cfg), seed=4, init_walkers=300)
    tstep, _, tstate, taux = tfq.build(t, tfq.FciqmcConfig(**cfg), seed=4, init_walkers=300)
    return jstep, jstate, jaux, tstep, tstate, taux


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    system, extra = CASES[request.param]
    return (request.param, dict(BASE, **extra)) + pair(system, **BASE, **extra)


def test_build_matches_reference(case):
    _, _, _, jstate, jaux, _, tstate, taux = case
    assert taux["e_ref"] == float(jaux["e_ref"])
    assert taux["p_doub"] == jaux["p_doub"]
    for k in ("num_keys", "den_keys", "ref_key"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]).astype(np.int64))
    for k in ("num_vals", "den_vals"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-13, atol=0)
    np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                  np.asarray(jstate.arena.keys).astype(np.int64))
    np.testing.assert_array_equal(tstate.arena.vals.numpy(), np.asarray(jstate.arena.vals))
    assert int(tstate.arena.n_used[0]) == int(np.asarray(jstate.arena.n_used).reshape(-1)[0])


def test_steps_match_reference(case):
    name, cfg, jstep, jstate, jaux, tstep, _, taux = case
    jargs, targs = reference_args(jaux), rung.estimator_args(taux)
    for _ in range(20):
        jstate, _ = jstep(jstate, *jargs)
    tstate = to_port(jstate)
    for it in range(10):
        jstate, jm = jstep(jstate, *jargs)
        tstate, tm = tstep(tstate, *targs)
        ja = jstate.arena
        np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                      np.asarray(ja.keys).astype(np.int64), err_msg=name)
        assert int(tstate.arena.n_used[0]) == int(np.asarray(ja.n_used).reshape(-1)[0])
        if cfg.get("integer_walkers", True):
            np.testing.assert_array_equal(tstate.arena.vals.numpy(), np.asarray(ja.vals))
        else:
            np.testing.assert_allclose(tstate.arena.vals.numpy(), np.asarray(ja.vals),
                                       rtol=1e-12, atol=0, err_msg=name)
        assert set(tm) == set(jm)
        for k in jm:
            x, y = float(tm[k]), float(np.asarray(jm[k]).reshape(-1)[0])
            if k in ("n_dets", "nnonz", "sgn_coh", "overflow"):
                assert x == y, (name, it, k, x, y)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-12, atol=0, err_msg=f"{name} {k}")
        assert not bool(tm["overflow"])
    assert tstate.iterat == int(jstate.iterat)


@pytest.mark.parametrize("small", ["attempt_cap", "spawn_cap"])
def test_overflow_flag_matches_reference(small):
    """300 walkers on HF into 256 attempts, or every live spawn of 4096
    attempts into 8 rows: both packages raise the flag."""
    cfg = dict(BASE, distribution="NU")
    cfg.update(attempt_cap=256) if small == "attempt_cap" else cfg.update(spawn_cap=8)
    jstep, jstate, jaux, tstep, tstate, taux = pair((5, 4, None, 13), **cfg)
    jstate, jm = jstep(jstate, *reference_args(jaux))
    tstate, tm = tstep(tstate, *rung.estimator_args(taux))
    assert bool(np.asarray(jm["overflow"])) and bool(tm["overflow"])


def test_attempt_parents():
    n_walk = torch.tensor([0, 3, 0, 1, 2])
    parent, valid, total = tfq._attempt_parents(n_walk, 8)
    assert parent.tolist()[:6] == [1, 1, 1, 3, 4, 4] and int(total) == 6
    assert valid.tolist() == [True] * 6 + [False] * 2


def test_integer_walker_energy_matches_dense_fci():
    """The port's own key tree (``rng.KeyTree``): the projected energy of
    1000 integer-walker NU steps on 5 orbitals / 4 electrons within
    max(5 sigma, 0.05) of dense FCI."""
    _, t, h, eris = build_ham(5, 4, None, 13)
    e0, _ = dense_fci.ground_state(dense_fci.build_hamiltonian(h, eris, 5, 2, 2)[0])
    cfg = tfq.FciqmcConfig(eps=0.02, target_walkers=500.0, capacity=256, attempt_cap=2048,
                           distribution="NU", shift_damping=0.25)
    _, run_steps, state, aux = tfq.build(t, cfg, seed=5, init_walkers=300)
    state, traj = run_steps(state, *rung.estimator_args(aux), 1000)
    assert not bool(traj["overflow"].any())
    num, den = traj["proj_num"].numpy()[300:], traj["proj_den"].numpy()[300:]
    e_est = aux["e_ref"] + num.sum() / den.sum()
    blocks = [a.sum() / b.sum() for a, b in zip(np.array_split(num, 10),
                                                np.array_split(den, 10))]
    sigma = np.std(blocks) / np.sqrt(len(blocks))
    assert abs(e_est - e0) < max(5 * sigma, 0.05), (e_est, e0, sigma)


def test_imports_without_jax_fciqmc_frimulti():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['fries_tpu'] = None\n"
        "import fries_tpu_torch.ops.near_uniform\n"
        "from fries_tpu_torch import rung, synth\n"
        "from fries_tpu_torch.drivers import fciqmc, frimulti\n"
        "ham = synth.make_system(5, 4, seed=1)\n"
        "for integer in (True, False):\n"
        "    cfg = fciqmc.FciqmcConfig(eps=0.02, target_walkers=100.0, capacity=64,"
        " attempt_cap=512, distribution='HB', integer_walkers=integer)\n"
        "    _, run, state, aux = fciqmc.build(ham, cfg, seed=0, init_walkers=50)\n"
        "    state, m = run(state, *rung.estimator_args(aux), 3)\n"
        "    assert not bool(m['overflow'].any())\n"
        "mcfg = frimulti.FrimultiConfig(eps=0.02, vec_nonz=20, matr_samp=40, capacity=64,"
        " spawn_cap=64)\n"
        "_, run, state, aux = frimulti.build(ham, mcfg, seed=0)\n"
        "state, m = run(state, *rung.estimator_args(aux), 3)\n"
        "assert not bool(m['overflow'].any())\n"
        "assert not any(n == 'jax' or n.startswith(('jax.', 'fries_tpu.'))"
        " for n in sys.modules if sys.modules[n] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("cmd", ["fciqmc_mol", "fciqmc_fp_mol"])
def test_cli_fciqmc(tmp_path, cmd):
    """The subcommand writes its streams on the CPU (FCIQMC reports no
    nini.txt / nkept.txt, which stay empty) and stops without a card."""
    _, t, _, _ = build_ham(5, 4, SYMM5, 13)
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump, point_group="D2h")
    out = tmp_path / "run"
    args = [cmd, "--fcidump_path", str(fcidump), "--point_group", "D2h", "--max_dets", "128",
            "--max_iter", "20", "--save_interval", "10", "--target", "200",
            "--attempt_cap", "1024", "--initiator", "1", "--epsilon", "0.02",
            "--result_dir", str(out), "--seed", "3"]
    cli.main(args + ["--device", "cpu"])
    for key, name in cli._STREAMS.items():
        if key in ("n_ini", "nkept"):
            assert (out / name).read_text() == "", name
        else:
            assert np.loadtxt(out / name).shape == (20,), name
    assert "attempt_cap: 1024" in (out / "params.txt").read_text()
    assert len((out / "arena_occ.txt").read_text().splitlines()) == 2
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args + ["--device", "cuda"])


def test_cli_fciqmc_defaults():
    p = cli._parser()
    a = p.parse_args(["fciqmc_mol", "--max_dets", "10"])
    assert (a.epsilon, a.distribution, a.attempt_cap) == (1e-3, "NU", 0)
    assert not hasattr(a, "vec_nonz")
    assert p.parse_args(["fciqmc_fp_mol", "--max_dets", "10"]).distribution == "HB"


def _bench_fciqmc_call():
    """bench.py's ``bench_fciqmc``: the FciqmcConfig keywords and the build's
    keywords, as literals where they are."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "bench_fciqmc")
    calls = {}
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            kw = {}
            for k in n.keywords:
                try:
                    kw[k.arg] = eval(compile(ast.Expression(k.value), "bench.py", "eval"), {})
                except NameError:   # a variable of the function
                    kw[k.arg] = None
            calls[n.func.attr] = kw
    return calls


def test_rung_fciqmc_is_bench_fciqmc():
    """rung.fciqmc_config is bench.py's synthetic fciqmc configuration but
    for the two changes its docstring gives (shift_interval 1, capacity
    2^22) and the TPU's attempt chunking."""
    calls = _bench_fciqmc_call()
    bench = calls["FciqmcConfig"]
    got = rung.fciqmc_config()
    assert bench.pop("capacity") == 1 << 21 and got.capacity == 1 << 22
    assert got.shift_interval == 1 and "shift_interval" not in bench
    assert bench.pop("attempt_chunk") is None
    for k, v in bench.items():
        assert getattr(got, k) == v, k
    assert calls["build"]["init_walkers"] == rung.FCIQMC_INIT_WALKERS
    assert calls["build"]["seed"] == 0
    ham = rung.fciqmc_system()
    assert (ham.n_orb, ham.n_elec) == (28, 14)
