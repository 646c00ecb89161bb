"""The port's CISD and Lanczos against the reference's, on the CPU: the
CISD determinant space (keys and order, one to four words), its dense H
block, the CISD ground state (energy and vector), the orbital-phase gauge
(``apply_phases`` / ``orbital_phases``), and the dense helpers
``lanczos_ground_state``, ``get_svals``, ``inv`` and ``qr``.  Systems are
the synthetic ones both packages draw bit-identically from one seed, and
H2O/STO-3G."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fries_tpu import cisd as jcisd, gto as jgto, linalg as jlinalg, synth as jsynth  # noqa: E402
from fries_tpu_torch import cisd as tcisd, convert, gto as tgto, linalg as tlinalg  # noqa: E402
from fries_tpu_torch import synth as tsynth  # noqa: E402

# (n_orb, n_elec, irreps): one, two, three and four words
SYSTEMS = {"w1": (10, 6, 4), "w2": (20, 8, 4), "w3": (33, 4, 8), "w4": (50, 4, 8)}


def pair(name):
    n_orb, n_elec, n_irreps = SYSTEMS[name]
    symm = np.arange(n_orb) % n_irreps
    return (jsynth.make_system(n_orb, n_elec, symm=symm, seed=5, scale_two=0.1),
            tsynth.make_system(n_orb, n_elec, symm=symm, seed=5, scale_two=0.1, device="cpu"))


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_enumerate_cisd_matches_reference(name):
    jham, tham = pair(name)
    want = jcisd.enumerate_cisd(jham).astype(np.int64)
    got = tcisd.enumerate_cisd(tham)
    assert got.shape == want.shape and got.shape[1] == tham.n_words
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["w1", "w3"])
def test_build_dense_h_matches_reference(name):
    jham, tham = pair(name)
    words = jcisd.enumerate_cisd(jham)
    want = jcisd.build_dense_h(jham, words)
    got = tcisd.build_dense_h(tham, torch.as_tensor(words.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def water_pair():
    jham, _ = jgto.water()
    tham = convert.hamiltonian(np.asarray(jham.hcore), np.asarray(jham.eris),
                               np.asarray(jham.symm), jham.n_orb, jham.n_elec, device="cpu")
    return jham, tham


@pytest.mark.parametrize("name", ["w1", "w2", "water"])
def test_cisd_ground_state_matches_reference(name):
    jham, tham = water_pair() if name == "water" else pair(name)
    e_ref, w_ref, v_ref = jcisd.cisd_ground_state(jham)
    e, words, vec = tcisd.cisd_ground_state(tham)
    assert abs(e - e_ref) < 1e-10
    np.testing.assert_array_equal(words.numpy(), w_ref.astype(np.int64))
    np.testing.assert_allclose(vec.numpy(), v_ref, rtol=0, atol=1e-9)


def test_orbital_phases_roundtrip():
    """A CISD vector carried across random orbital signs and back: both
    packages give the same coefficients and recover the same signs."""
    jham, tham = pair("w2")
    _, words, vec = tcisd.cisd_ground_state(tham)
    w32 = words.numpy().astype(np.uint32)
    rng = np.random.default_rng(3)
    s = rng.choice([-1, 1], size=tham.n_orb)
    b = tcisd.apply_phases(words, vec, s, gsign=-1)
    np.testing.assert_array_equal(b, jcisd.apply_phases(w32, vec.numpy(), s, gsign=-1))
    got = tcisd.orbital_phases(words, vec, b, tham.n_orb)
    want = jcisd.orbital_phases(w32, vec.numpy(), b, tham.n_orb)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == tuple(want[1:])
    back = tcisd.apply_phases(words, b, got[0], got[1])
    np.testing.assert_allclose(back, vec.numpy(), atol=1e-14)
    # HF alone flipped: no orbital gauge does that (HF has no singly
    # occupied orbital, and the global sign would flip every determinant)
    bad = vec.numpy().copy()
    bad[int(np.argmax(np.abs(bad)))] *= -1
    for fn, w in ((tcisd.orbital_phases, words), (jcisd.orbital_phases, w32)):
        with pytest.raises(RuntimeError, match="inconsistent"):
            fn(w, vec.numpy(), bad, tham.n_orb)


@pytest.mark.parametrize("start", ["seed", "v0"])
def test_lanczos_matches_reference(start):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((300, 300))
    h = a + a.T + np.diag(np.linspace(-30, 10, 300))
    v0 = rng.standard_normal(300) if start == "v0" else None
    e_ref, v_ref = jlinalg.lanczos_ground_state(lambda v: jnp.asarray(h) @ v, 300, m=80, v0=v0,
                                                seed=4)
    ht = torch.as_tensor(h)
    e, vec = tlinalg.lanczos_ground_state(lambda v: ht @ v, 300, m=80,
                                          v0=None if v0 is None else torch.as_tensor(v0), seed=4)
    assert abs(e - e_ref) < 1e-10
    assert abs(e - np.linalg.eigvalsh(h)[0]) < 1e-8
    np.testing.assert_allclose(np.abs(vec.numpy() @ v_ref), 1.0, atol=1e-10)


def test_dense_helpers_match_reference():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((6, 6)) + 4 * np.eye(6)
    np.testing.assert_allclose(tlinalg.get_svals(m), np.asarray(jlinalg.get_svals(m)),
                               rtol=1e-12)
    np.testing.assert_allclose(tlinalg.inv(m), np.asarray(jlinalg.inv(m)), rtol=1e-10,
                               atol=1e-12)
    q, r = tlinalg.qr(m[:, :4])
    jq, jr = (np.asarray(x) for x in jlinalg.qr(m[:, :4]))
    assert q.shape == jq.shape and r.shape == jr.shape
    np.testing.assert_allclose(np.abs(r), np.abs(jr), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(q @ r, m[:, :4], atol=1e-12)
    np.testing.assert_allclose(q * np.sign(np.diag(r)), jq * np.sign(np.diag(jr)), atol=1e-12)
