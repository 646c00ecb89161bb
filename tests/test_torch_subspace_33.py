"""The port's subspace iteration with 33 trial vectors, one value row more
than kernel C takes, against the reference package on the CPU: the build's
arena and two iterations from the reference's state, fed its key tree
(``jax_keys.JaxKeys``), systematic compression to keep the reference's
compile short.  On the card the dispatcher takes the plain multi-row merge
there (``arena.accumulate_multi_best``); here both run plain.  Keys,
counts and flags exact; values, h_mat and d_mat at rtol 1e-10."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fries_tpu import synth as jsynth  # noqa: E402
from fries_tpu.drivers import subspace as jsub  # noqa: E402
from fries_tpu_torch import convert  # noqa: E402
from fries_tpu_torch.drivers import subspace as tsub  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402

SYMM = np.array([0, 1, 0, 1, 0, 1, 2, 3])


def trial_33(j):
    """(33, 1, W) trial keys and values: HF and the 32 determinants of HF's
    irrep nearest to it (fewest excitations, then lowest mask)."""
    n_orb = 8
    irrep = lambda orbs: np.bitwise_xor.reduce(SYMM[list(orbs)]) if orbs else 0
    hf = 0b11 | (0b11 << n_orb)
    masks = []
    for m in range(1 << (2 * n_orb)):
        a = [i for i in range(n_orb) if m >> i & 1]
        b = [i for i in range(n_orb) if m >> (n_orb + i) & 1]
        if len(a) == len(b) == 2 and irrep(a) ^ irrep(b) == 0 and m != hf:
            masks.append((bin(m ^ hf).count("1"), m))
    masks = [hf] + [m for _, m in sorted(masks)[:32]]
    tk = np.array([[[m]] for m in masks], dtype=np.int64)
    return tk, np.ones((33, 1))


def test_subspace_33_trial_vectors_match_reference():
    """Two subspace iterations with 33 trial vectors (a restart and a
    norm-factor update at the second) from the reference's state after
    one, fed its key tree: the port's plain multi-row merge at R = 33, the
    dispatcher's card route past kernel C."""
    j = jsynth.make_system(8, 4, symm=SYMM, seed=3)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), SYMM, 8, 4)
    tk, tv = trial_33(j)
    cfg = dict(eps=0.02, n_trial=33, vec_nonz=40, matr_samp=80, capacity=512,
               spawn_cap=120, restart_int=2, shift_interval=2, compress_mode="sys",
               pivotal_h=False)
    jstep, _, jstate, _ = jsub.build(j, jsub.SubspaceConfig(**cfg), jnp.asarray(tk),
                                     jnp.asarray(tv), seed=4)
    tstep, _, tstate, _ = tsub.build(t, tsub.SubspaceConfig(**cfg), tk, tv, seed=4)
    assert tstate.arena.n_vecs == 33
    jstate, _ = jstep(jstate)
    for _ in range(2):
        a = jstate.arena
        tstate = convert.subspace_state(
            convert.arena(np.asarray(a.keys), np.asarray(a.vals), np.asarray(a.n_used)),
            jstate.norm_factors, jstate.last_norms, jstate.iterat, JaxKeys(jstate.key))
        jstate, jm = jstep(jstate)
        tstate, tm = tstep(tstate)
        ja = jstate.arena
        np.testing.assert_array_equal(tstate.arena.keys.numpy(),
                                      np.asarray(ja.keys).astype(np.int64))
        np.testing.assert_allclose(tstate.arena.vals.numpy(), np.asarray(ja.vals),
                                   rtol=1e-10, atol=1e-12)
        for k, v in jm.items():
            if np.asarray(v).dtype.kind == "f":
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(v), rtol=1e-10,
                                           atol=1e-14, err_msg=k)
            else:
                np.testing.assert_array_equal(tm[k].numpy().reshape(-1),
                                              np.asarray(v).reshape(-1), err_msg=k)
    assert int(jm["n_dets"][0]) > 20
    assert (np.asarray(ja.vals) != 0).any(axis=1).all()
