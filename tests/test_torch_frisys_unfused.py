"""The port's frisys with its unfused stages against the reference package:
``fuse_ab=False`` (level A, double or single, then level B, o1 or the
allowed-electron rank) and ``fuse_cd=False`` (level C, o2 or the virtual,
then level D, u1), each off and both off.  The spawner fed the reference's
six uniforms (systematic; the pivotal one, fed the reference's key, is in
``test_torch_frisys_unfused_pivotal.py``), normed and unnormed weights
taking turns: keys exact, amplitudes within rtol 1e-12.  The power
step with each stage unfused, five steps from the reference's state fed its
draws: keys and integer metrics exact, values and float metrics within rtol
1e-10, as ``tests/test_torch_frisys.py`` holds the fused step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fries_tpu.drivers import frisys as jfs  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import convert  # noqa: E402
from fries_tpu_torch.drivers import frisys as tfs  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402
from test_torch_frisys import spawners, system  # noqa: E402

STAGES = {"ab": dict(fuse_ab=False), "cd": dict(fuse_cd=False),
          "both": dict(fuse_ab=False, fuse_cd=False)}


@pytest.fixture(scope="module")
def arena_input():
    j, t = system()
    hfw, hfo, _ = jmol.hf_reference(j)
    tmpl = jmol.ExcitationTemplate.build(j.n_orb, j.n_elec)
    ew, ea, _ = jmol.exact_offdiag_batch(j, tmpl, hfw[None], hfo[None], jnp.ones(1), 1.0)
    ew, ea = np.asarray(ew.reshape(-1, 1)), np.asarray(ea.reshape(-1))
    keys = np.unique(np.concatenate([np.asarray(hfw)[None], ew[ea != 0]]), axis=0)[:40]
    vals = np.random.default_rng(0).standard_normal(len(keys))
    a = jar.from_unsorted(jar.make(64, 1, 1), jnp.asarray(keys), jnp.asarray(vals)[None])
    return j, t, a, jnp.where(a.valid, a.vals[0], 0.0)


def spawner_matches_reference(arena_input, stages, pivotal, unnorm):
    j, t, a, avals = arena_input
    js, ts = spawners(j, t, eps=0.02, vec_nonz=60, matr_samp=150, capacity=64,
                      spawn_cap=200, unnorm=unnorm, pivotal=pivotal, **STAGES[stages])
    key = jax.random.key(5)
    jw, jamp, jini = jax.jit(js)(a.keys, avals, -0.02, key, thresh=jnp.asarray(0.3))
    rand = (JaxKeys(key) if pivotal
            else torch.tensor(np.asarray(jax.random.uniform(key, (6,), dtype=jnp.float64))))
    tw, tamp, tini = ts(torch.as_tensor(np.asarray(a.keys).astype(np.int64)),
                        torch.tensor(np.asarray(avals)), -0.02, rand,
                        thresh=torch.tensor(0.3, dtype=torch.float64))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tini.numpy(), np.asarray(jini))
    assert (np.asarray(jamp) != 0).sum() > 100
    np.testing.assert_allclose(tamp.numpy(), np.asarray(jamp), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("stages,unnorm", [("ab", False), ("cd", True), ("both", False)])
def test_unfused_spawner_matches_reference(arena_input, stages, unnorm):
    """Systematic; the pivotal spawner is in test_torch_frisys_unfused_pivotal.py."""
    spawner_matches_reference(arena_input, stages, False, unnorm)


@pytest.mark.parametrize("stages", ["ab", "cd"])
def test_unfused_power_steps_match_reference(stages):
    j, t = system()
    cfg = dict(eps=0.02, vec_nonz=60, matr_samp=150, capacity=256, spawn_cap=200,
               target_norm=200.0, shift_interval=2, **STAGES[stages])
    jstep, _, jstate, jaux = jfs.build(j, jfs.FrisysConfig(**cfg), seed=4)
    tstep, _, _, taux = tfs.build(t, tfs.FrisysConfig(**cfg), seed=4)
    est = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")
    jargs, targs = [jaux[k] for k in est], [taux[k] for k in est]
    for _ in range(15):
        jstate, _ = jstep(jstate, *jargs)
    for _ in range(5):
        a = jstate.arena
        tstate = convert.power_state(
            convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used)),
            jstate.en_shift, jstate.last_norm, jstate.iterat)
        key_spawn, key_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
        rns = np.asarray(jax.random.uniform(key_spawn, (6,), dtype=jnp.float64))
        rn = float(jax.random.uniform(key_vec, dtype=jnp.float64))
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
        assert not bool(tm["overflow"])
