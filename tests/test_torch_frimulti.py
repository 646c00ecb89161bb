"""The port's frimulti against the reference package: both built from one
numpy-seeded Hamiltonian (5 orbitals / 4 electrons with near-uniform
sampling, 5 and 8 orbitals with heat-bath sampling), the reference run 10
steps, its state carried into the port (``convert.power_state`` with the
reference's key behind ``jax_keys.JaxKeys``), then 5 steps of each: keys,
counts and flags exact, values and float metrics within rtol 1e-12.  Also
the keyed power core's draws, the command line and the ``frimulti``
configuration."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu.drivers import frimulti as jfm  # noqa: E402
from fries_tpu_torch import cli, convert, io as tio, rng as trng, rung  # noqa: E402
from fries_tpu_torch.drivers import frimulti as tfm  # noqa: E402
from fries_tpu_torch.drivers import power  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402
from test_torch_near_uniform import build_ham  # noqa: E402

BASE = dict(eps=0.02, vec_nonz=40, matr_samp=120, capacity=256, spawn_cap=200,
            init_thresh=0.5, target_norm=50.0, shift_interval=3)
CASES = {"NU-5": ((5, 4, None, 13), "NU"), "HB-5-symm": ((5, 4, [0, 1, 0, 1, 0], 13), "HB"),
         "HB-8-symm": ((8, 4, [0, 1, 0, 1, 0, 1, 2, 3], 3), "HB")}
EST = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")


@pytest.mark.parametrize("name", sorted(CASES))
def test_steps_match_reference(name):
    (n_orb, n_elec, symm, seed), dist = CASES[name]
    j, t, _, _ = build_ham(n_orb, n_elec, symm, seed)
    cfg = dict(BASE, distribution=dist)
    jstep, _, jstate, jaux = jfm.build(j, jfm.FrimultiConfig(**cfg), seed=4, init_val=30.0)
    tstep, _, _, taux = tfm.build(t, tfm.FrimultiConfig(**cfg), seed=4, init_val=30.0)
    assert taux["p_doub"] == jaux["p_doub"]
    for k in ("num_keys", "den_keys"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]).astype(np.int64))
    jargs, targs = [jaux[k] for k in EST], [taux[k] for k in EST]
    for _ in range(10):
        jstate, _ = jstep(jstate, *jargs)
    a = jstate.arena
    tstate = convert.power_state(
        convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used)),
        jstate.en_shift, jstate.last_norm, jstate.iterat, key=JaxKeys(jstate.key))
    for it in range(5):
        jstate, jm = jstep(jstate, *jargs)
        tstate, tm = tstep(tstate, *targs)
        np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                      np.asarray(jstate.arena.keys).astype(np.int64))
        np.testing.assert_allclose(tstate.arena.vals.numpy(), np.asarray(jstate.arena.vals),
                                   rtol=1e-12, atol=1e-300, err_msg=f"{name} step {it}")
        assert set(tm) == set(jm)
        for k in jm:
            x, y = float(tm[k]), float(np.asarray(jm[k]).reshape(-1)[0])
            if k in ("n_dets", "nkept", "n_ini", "nnonz", "sgn_coh", "overflow"):
                assert x == y, (name, it, k, x, y)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-300,
                                           err_msg=f"{name} step {it} {k}")
        assert not bool(tm["overflow"])


def test_keyed_core_draws():
    """A keyed stepper hands the spawner split(2)[0] of key.fold(iterat)
    and compresses the vector with split(2)[1]'s uniform; it takes no
    injected uniforms."""
    seen = []

    def spawn(keys, vals, h_fac, key):
        seen.append(key.uniform((3,)))
        return keys, torch.zeros_like(vals), torch.zeros_like(vals, dtype=torch.bool)

    _, t, _, _ = build_ham(5, 4, None, 13)
    step, _ = power.make_stepper(spawn, lambda keys: torch.zeros(keys.shape[0],
                                                                 dtype=torch.float64),
                                 power.PowerConfig(eps=0.02, target_nonz=10, capacity=16),
                                 estimator="direct", keyed=True)
    _, _, state, aux = tfm.build(t, tfm.FrimultiConfig(**BASE), seed=4)
    state = power.PowerState(state.arena, state.en_shift, state.last_norm, 7, state.generator,
                             trng.KeyTree(2))
    state2, _ = step(state, *[aux[k] for k in EST])
    assert torch.equal(seen[0], trng.KeyTree(2).fold(7).split(2)[0].uniform((3,)))
    assert state2.iterat == 8 and state2.key is state.key
    with pytest.raises(ValueError):
        step(state, *[aux[k] for k in EST], rns=torch.zeros(6))


def test_cli_frimulti(tmp_path):
    _, t, _, _ = build_ham(5, 4, [0, 1, 0, 1, 0], 13)
    fcidump = tmp_path / "FCIDUMP"
    tio.write_fcidump(t, fcidump, point_group="D2h")
    out = tmp_path / "run"
    args = ["frimulti_mol", "--fcidump_path", str(fcidump), "--point_group", "D2h",
            "--epsilon", "0.02", "--vec_nonz", "40", "--mat_nonz", "100", "--max_dets", "256",
            "--max_iter", "20", "--save_interval", "10", "--target", "100",
            "--distribution", "HB", "--result_dir", str(out), "--seed", "3"]
    cli.main(args + ["--device", "cpu"])
    for name in cli._STREAMS.values():
        assert np.loadtxt(out / name).shape == (20,), name
    assert "distribution: HB" in (out / "params.txt").read_text()
    assert cli._parser().parse_args(args[:1] + ["--max_dets", "1", "--epsilon", "1",
                                                "--vec_nonz", "1", "--mat_nonz", "1"]
                                    ).distribution == "NU"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(args + ["--device", "cuda"])


def test_rung_frimulti_is_the_frisys_rung_system():
    cfg, frisys = rung.frimulti_config(), rung.config()
    assert (cfg.eps, cfg.vec_nonz, cfg.matr_samp, cfg.capacity, cfg.target_norm) == (
        frisys.eps, frisys.vec_nonz, frisys.matr_samp, frisys.capacity, frisys.target_norm)
    assert cfg.spawn_cap == int(1.4 * cfg.matr_samp) and cfg.distribution == "HB"
