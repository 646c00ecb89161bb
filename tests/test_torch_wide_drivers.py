"""The port's fciqmc, frimulti, frifull and observables drivers on
three-word determinants (W = 3, 34 orbitals) against the reference package:
one step each from the reference's state (the observables from the start,
with two electrons), fed its draws (the FCIQMC,
frimulti and observables steps draw from the reference's key through
``jax_keys.JaxKeys``).  Keys, counts and flags exact; values at rtol 1e-10
(1e-12 for frimulti, exact for integer walkers)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fries_tpu.drivers import fciqmc as jfq, frifull as jff, frimulti as jfm  # noqa: E402
from fries_tpu.drivers import observables as jobs, power as jpower  # noqa: E402
from fries_tpu_torch import convert  # noqa: E402
from fries_tpu_torch.drivers import fciqmc as tfq, frifull as tff, frimulti as tfm  # noqa: E402
from fries_tpu_torch.drivers import observables as tobs, power as tpower  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402
from test_torch_wide_steps import (EST, assert_arena, assert_estimator_vectors,  # noqa: E402
                                   assert_metrics, port_arena, system)


@pytest.fixture(scope="module")
def w3():
    j, t = system(34, 4, 5)
    assert t.n_words == 3
    return j, t


def test_fciqmc_step_matches_reference_w3(w3):
    j, t = w3
    cfg = dict(eps=0.02, target_walkers=600.0, capacity=1024, attempt_cap=4096,
               init_thresh=2.0, shift_damping=0.25, shift_interval=4, distribution="HB",
               spawn_cap=2048)
    jstep, _, jstate, jaux = jfq.build(j, jfq.FciqmcConfig(**cfg), seed=4, init_walkers=300)
    tstep, _, _, taux = tfq.build(t, tfq.FciqmcConfig(**cfg), seed=4, init_walkers=300)
    assert_estimator_vectors(taux, jaux)
    jargs, targs = [jaux[k] for k in EST], [taux[k] for k in EST]
    for _ in range(4):
        jstate, _ = jstep(jstate, *jargs)
    a = jstate.arena
    tstate = convert.fciqmc_state(port_arena(a), jstate.en_shift, jstate.last_norm,
                                  jstate.iterat, JaxKeys(jstate.key))
    jstate, jm = jstep(jstate, *jargs)
    tstate, tm = tstep(tstate, *targs)
    assert_arena(tstate.arena, jstate.arena, rtol=0)
    assert_metrics(tm, jm)
    assert int(tstate.arena.n_used[0]) > 50


def test_frimulti_step_matches_reference_w3(w3):
    j, t = w3
    cfg = dict(eps=0.02, vec_nonz=200, matr_samp=600, capacity=2048, spawn_cap=1000,
               init_thresh=0.5, target_norm=50.0, shift_interval=3, distribution="HB")
    jstep, _, jstate, jaux = jfm.build(j, jfm.FrimultiConfig(**cfg), seed=4, init_val=30.0)
    tstep, _, _, taux = tfm.build(t, tfm.FrimultiConfig(**cfg), seed=4, init_val=30.0)
    assert_estimator_vectors(taux, jaux)
    jargs, targs = [jaux[k] for k in EST], [taux[k] for k in EST]
    for _ in range(3):
        jstate, _ = jstep(jstate, *jargs)
    tstate = convert.power_state(port_arena(jstate.arena), jstate.en_shift, jstate.last_norm,
                                 jstate.iterat, key=JaxKeys(jstate.key))
    jstate, jm = jstep(jstate, *jargs)
    tstate, tm = tstep(tstate, *targs)
    assert_arena(tstate.arena, jstate.arena, rtol=1e-12)
    assert_metrics(tm, jm)
    assert int(tstate.arena.n_used[0]) > 50


def test_frifull_step_matches_reference_w3(w3):
    """The chunked exact-H step with dedup_cap (room for every chunk's
    targets: the reference's dedup sums a wrong last row on overflow) and
    spawn_rows."""
    j, t = w3
    cfg = dict(eps=0.02, target_nonz=12, capacity=1 << 16, target_norm=101.0,
               shift_interval=2, init_thresh=1.0, batch=8, dedup_cap=1 << 15,
               spawn_rows=16)
    jstep, _, jstate, jaux = jff.build(j, jpower.PowerConfig(**cfg), seed=4)
    tstep, _, _, taux = tff.build(t, tpower.PowerConfig(**cfg), seed=4)
    jargs, targs = [jaux[k] for k in EST], [taux[k] for k in EST]
    for _ in range(2):
        jstate, _ = jstep(jstate, *jargs)
    tstate = convert.power_state(port_arena(jstate.arena), jstate.en_shift,
                                 jstate.last_norm, jstate.iterat)
    _, key_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
    rn = float(jax.random.uniform(key_vec, dtype=jnp.float64))
    jstate, jm = jstep(jstate, *jargs)
    tstate, tm = tstep(tstate, *targs, rn_vec=rn)
    assert_arena(tstate.arena, jstate.arena)
    assert_metrics(tm, jm)
    assert int(tstate.arena.n_used[0]) > 10 and not bool(jm["overflow"])


def test_observables_step_matches_reference_w3():
    """Two electrons: the exact spawn runs over every arena row, so the
    arena is kept small."""
    j, t = system(34, 2, 5)
    cfg = dict(eps=0.05, capacity=1024, obs_des=1, obs_cre=2, burn_in=0, n_obs=2,
               btw_obs=1, target_nonz=8)
    jstep, _, jstate, _ = jobs.build(j, jobs.ObservablesConfig(**cfg), seed=2)
    tstep, _, tstate, _ = tobs.build(t, tobs.ObservablesConfig(**cfg, batch=64), seed=2)
    tstate = dataclasses.replace(tstate, key=JaxKeys(jstate.key))
    assert_arena(tstate.arena, jstate.arena)
    jstate, jm = jstep(jstate)
    tstate, tm = tstep(tstate)
    assert_arena(tstate.arena, jstate.arena)
    for k in ("obs_num", "obs_den", "norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-10, err_msg=k)
    for k in ("n_dets", "in_obs", "overflow"):
        assert int(tm[k]) == int(np.asarray(jm[k]).reshape(-1)[0]), k
    assert int(tm["n_dets"]) > 8 and not bool(tm["overflow"])
