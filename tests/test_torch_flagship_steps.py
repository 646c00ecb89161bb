"""The flagship run's trajectory against the JAX package: on the small
molecule of ``test_torch_frisys.py``, the CISD trials of both packages, the
port's preparation (a 6-determinant deterministic space, initial one-norm
at half the target, deadbeat damping 1.0 and tracking 0.05) fed to both
packages' ``frisys.build``, and 40 steps of each from its own build, the
port fed the reference's draws: n_dets exact, the estimators, the shift
and the norm within rtol 1e-10."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fries_tpu import cisd as jcisd  # noqa: E402
from fries_tpu.drivers import frisys as jfs  # noqa: E402
from fries_tpu_torch import cisd as tcisd  # noqa: E402
from fries_tpu_torch import flagship  # noqa: E402
from fries_tpu_torch.drivers import frisys as tfs  # noqa: E402
from test_torch_frisys import system  # noqa: E402

N_STEPS = 40
FLAGS = ["--budget", "1000", "--capacity", "4096", "--determ", "6", "--initiator", "1.0",
         "--init_frac", "0.5", "--damp", "1.0", "--track", "0.05", "--eps", "0.05",
         "--seed", "20"]


def test_flagship_trajectory_matches_reference():
    j, t = system()
    je, jw, jv = jcisd.cisd_ground_state(j)
    te, tw, tv = tcisd.cisd_ground_state(t)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    assert abs(te - je) < 1e-10
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-10)

    args = flagship.parser().parse_args(FLAGS)
    cfg, trial, init_vec, determ = flagship.prepare(tw, tv, args, flagship.SYSTEMS["ne"])
    assert len(determ) == 6 and cfg.shift_damping == 1.0 and cfg.shift_tracking == 0.05
    u32 = lambda w: np.asarray(w).astype(np.uint32)
    jcfg = jfs.FrisysConfig(**{f: getattr(cfg, f) for f in (
        "eps", "vec_nonz", "matr_samp", "capacity", "spawn_cap", "target_norm",
        "init_thresh", "shift_damping", "shift_tracking")})
    jstep, _, jstate, jaux = jfs.build(j, jcfg, seed=args.seed, trial=(u32(trial[0]), trial[1]),
                                       init_vec=(u32(init_vec[0]), init_vec[1]),
                                       determ_keys=u32(determ))
    tstep, _, tstate, taux = tfs.build(t, cfg, seed=args.seed, trial=trial, init_vec=init_vec,
                                       determ_keys=determ)
    est = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")
    jargs = [jaux[k] for k in est] + [jaux["protected_keys"]]
    targs = [taux[k] for k in est]
    jstep = jax.jit(jstep)
    for i in range(N_STEPS):
        key_spawn, key_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
        rns = np.asarray(jax.random.uniform(key_spawn, (6,), dtype=jnp.float64))
        rn = float(jax.random.uniform(key_vec, dtype=jnp.float64))
        jstate, jm = jstep(jstate, *jargs)
        tstate, tm = tstep(tstate, *targs, rns=rns, rn_vec=rn,
                           protected_keys=taux["protected_keys"])
        assert int(tm["n_dets"]) == int(jm["n_dets"]), i
        assert not bool(tm["overflow"]) and not bool(jm["overflow"])
        for k in ("proj_num", "proj_den", "shift", "norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-10, atol=0,
                                       err_msg=f"step {i} {k}")
    assert float(tm["norm"]) > 1.2 * np.abs(init_vec[1]).sum()   # it grew
