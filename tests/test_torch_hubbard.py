"""The port's Hubbard-Holstein model against the reference package: the
phonon counters, the diagonal, the off-diagonal candidate grid, the
occupied lists, the reference connections, the Neel state and the parameter
file, on random determinants at (n_sites, ph_bits) in {(3, 2), (4, 3), (6,
0), (12, 3)} (the last two words, with counters across the word boundary);
and the port alone against tests/dense_hubbard.py's dense matrix.  Words and
masks exact, amplitudes at rtol 1e-12."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import dense_hubbard  # noqa: E402
from fries_tpu import dets as jd, io as jio  # noqa: E402
from fries_tpu.ops import hubbard as jhub  # noqa: E402
from fries_tpu_torch import dets as td, io as tio  # noqa: E402
from fries_tpu_torch.ops import hubbard as thub  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(3, 2), (4, 3), (6, 0), (12, 3)]
COUPLINGS = dict(u=1.5, omega=0.7, g=0.4, t=1.0)


def models(n_sites, ph_bits):
    return (jhub.HubbardHolstein(n_sites, n_sites, ph_bits, **COUPLINGS),
            thub.HubbardHolstein(n_sites, n_sites, ph_bits, **COUPLINGS))


def random_words(n_sites, ph_bits, n=64):
    """(numpy uint32 words, port int64 words) of ``n`` random bit rows with
    the electron count of the model."""
    jham, _ = models(n_sites, ph_bits)
    rng = np.random.default_rng(10 * n_sites + ph_bits)
    bits = np.zeros((n, jham.n_bits), bool)
    for row in bits:
        row[rng.choice(2 * n_sites, n_sites, replace=False)] = True
        row[2 * n_sites:] = rng.random(jham.n_bits - 2 * n_sites) < 0.5
    words = np.asarray(jd.pack_bits(jnp.asarray(bits), jham.n_words))
    return words, torch.as_tensor(words.astype(np.int64))


def t64(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("n_sites,ph_bits", SHAPES)
def test_model_sizes(n_sites, ph_bits):
    jham, tham = models(n_sites, ph_bits)
    assert (tham.n_bits, tham.n_words, tham.max_ph) == (jham.n_bits, jham.n_words, jham.max_ph)
    assert thub.n_candidates(tham) == jhub.n_candidates(jham)


def test_model_too_wide_raises():
    """The model has no width gate, as in the reference: 64 bits (two words)
    and 65 bits (three) both build, with the reference's sizes."""
    for n_sites, ph_bits in ((16, 2), (13, 3)):
        jham, tham = models(n_sites, ph_bits)
        assert (tham.n_bits, tham.n_words, tham.max_ph) == \
            (jham.n_bits, jham.n_words, jham.max_ph)
        assert thub.n_candidates(tham) == jhub.n_candidates(jham)
    assert tham.n_bits == 65 and tham.n_words == 3


@pytest.mark.parametrize("n_sites,ph_bits", SHAPES)
def test_phonon_nums_and_diag(n_sites, ph_bits):
    jham, tham = models(n_sites, ph_bits)
    words, tw = random_words(n_sites, ph_bits)
    np.testing.assert_array_equal(thub.phonon_nums(tham, tw).numpy(),
                                  np.asarray(jhub.phonon_nums(jham, jnp.asarray(words))))
    np.testing.assert_allclose(thub.diag_matrel(tham, tw).numpy(),
                               np.asarray(jhub.diag_matrel(jham, jnp.asarray(words))),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_sites,ph_bits", SHAPES)
def test_with_phonon(n_sites, ph_bits):
    jham, tham = models(n_sites, ph_bits)
    words, tw = random_words(n_sites, ph_bits)
    rng = np.random.default_rng(n_sites)
    site = rng.integers(0, n_sites, len(words))
    num = rng.integers(0, jham.max_ph + 1, len(words))
    got = thub.with_phonon(tham, tw, torch.as_tensor(site), torch.as_tensor(num))
    want = jhub.with_phonon(jham, jnp.asarray(words), jnp.asarray(site), jnp.asarray(num))
    np.testing.assert_array_equal(got.numpy(), t64(want))


def test_counter_across_word_boundary():
    """At 12 sites and ph_bits 3 the counters start at bit 24: site 2's
    counter is bits 30-32, one bit in the second word."""
    jham, tham = models(12, 3)
    words, tw = random_words(12, 3, n=8)
    got = thub.with_phonon(tham, tw, torch.full((8,), 2), torch.full((8,), 5))
    want = jhub.with_phonon(jham, jnp.asarray(words), jnp.full((8,), 2), jnp.full((8,), 5))
    np.testing.assert_array_equal(got.numpy(), t64(want))
    assert ((got[:, 0] >> 30) & 3).eq(1).all() and (got[:, 1] & 1).eq(1).all()
    assert thub.phonon_nums(tham, got)[:, 2].eq(5).all()


@pytest.mark.parametrize("n_sites,ph_bits", SHAPES)
def test_offdiag_batch(n_sites, ph_bits):
    jham, tham = models(n_sites, ph_bits)
    words, tw = random_words(n_sites, ph_bits)
    vals = np.random.default_rng(3).standard_normal(len(words))
    vals[::7] = 0.0
    jw, ja = jhub.offdiag_batch(jham, jnp.asarray(words), jnp.asarray(vals), -0.02)
    tw2, ta = thub.offdiag_batch(tham, tw, torch.as_tensor(vals), -0.02)
    assert ta.shape == (len(words), thub.n_candidates(tham))
    np.testing.assert_array_equal(tw2.numpy(), t64(jw))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-12, atol=0)
    assert (ta != 0).sum() > len(words)


@pytest.mark.parametrize("n_sites,ph_bits", SHAPES)
def test_occ_list(n_sites, ph_bits):
    jham, tham = models(n_sites, ph_bits)
    words, tw = random_words(n_sites, ph_bits)
    np.testing.assert_array_equal(thub.occ_list(tham, tw).numpy(),
                                  np.asarray(jhub.occ_list(jham, jnp.asarray(words))))


@pytest.mark.parametrize("n_sites,ph_bits", SHAPES)
def test_neel_and_reference_connections(n_sites, ph_bits):
    jham, tham = models(n_sites, ph_bits)
    for n_elec in (n_sites, n_sites - 1):
        np.testing.assert_array_equal(
            td.neel_bits_1d(n_sites, n_elec, jham.n_bits).numpy(),
            np.asarray(jd.neel_bits_1d(n_sites, n_elec, jham.n_bits)))
    neel = jd.pack_bits(jd.neel_bits_1d(n_sites, n_sites, jham.n_bits), jham.n_words)
    jk, jm = jhub.reference_connections(jham, neel, 0.3)
    tk, tm = thub.reference_connections(tham, torch.as_tensor(t64(neel)), 0.3)
    np.testing.assert_array_equal(tk.numpy(), t64(jk))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-12, atol=0)


def test_parse_hh_input(tmp_path):
    body = "n_elec\n4\nlat_len\n4\nn_dim\n1\neps\n0.01\nU\n2.0\nomega\n1.0\ng\n0.5\n"
    for extra in ("gs_energy\n-3.25\n", "hf_energy\n-2.5\n", ""):
        path = tmp_path / f"p{len(extra)}.txt"
        path.write_text(body + extra)
        assert tio.parse_hh_input(path) == jio.parse_hh_input(path)
    (tmp_path / "bad.txt").write_text("n_elec\n4\n")
    with pytest.raises(ValueError, match="missing"):
        tio.parse_hh_input(tmp_path / "bad.txt")


def test_matches_dense_hamiltonian():
    """The port's diagonal and off-diagonal columns of the 3-site system
    equal tests/dense_hubbard.py's independent dense matrix."""
    ham = thub.HubbardHolstein(3, 2, 2, u=1.5, omega=0.7, g=0.4, t=1.0)
    dense_h, basis = dense_hubbard.build_hamiltonian(3, 1, 1, ham.max_ph, ham.t, ham.u,
                                                     ham.omega, ham.g)
    index = {dense_hubbard.state_to_mask(st, 3, ham.ph_bits): i for i, st in enumerate(basis)}
    masks = list(index)
    words = torch.tensor([[m & 0xFFFFFFFF] for m in masks])
    np.testing.assert_allclose(thub.diag_matrel(ham, words).numpy(),
                               [dense_h[index[m], index[m]] for m in masks], atol=1e-12)
    new_words, amps = thub.offdiag_batch(ham, words, torch.ones(len(masks), dtype=torch.float64),
                                         1.0)
    got = np.zeros_like(dense_h)
    for ci, m in enumerate(masks):
        for w, a in zip(new_words[ci, :, 0].tolist(), amps[ci].tolist()):
            if a != 0:
                got[index[w], index[m]] += a
    np.testing.assert_allclose(got, dense_h - np.diag(np.diag(dense_h)), atol=1e-12)


def test_hh_imports_without_jax():
    """The model, both drivers and the command line import and step with
    JAX and the reference package blocked."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['fries_tpu'] = None\n"
        "import fries_tpu_torch.cli, fries_tpu_torch.rung\n"
        "from fries_tpu_torch.drivers import frifull_hh, frisys_hh, power\n"
        "from fries_tpu_torch.ops import hubbard\n"
        "ham = hubbard.HubbardHolstein(3, 2, 2, u=1.5, omega=0.7, g=0.4)\n"
        "for mod, cfg in ((frifull_hh, power.PowerConfig(eps=0.02, target_nonz=20,"
        " capacity=256)), (frisys_hh, frisys_hh.FrisysHHConfig(eps=0.02, vec_nonz=20,"
        " matr_samp=40, capacity=128, spawn_cap=64))):\n"
        "    _, run, state, aux = mod.build(ham, 0.0, cfg, seed=0)\n"
        "    state, m = run(state, aux['num_keys'], aux['num_vals'], aux['den_keys'],"
        " aux['den_vals'], aux['ref_key'], 3)\n"
        "    assert not bool(m['overflow'].any())\n"
        "assert not any(n == 'jax' or n.startswith(('jax.', 'fries_tpu.'))"
        " for n in sys.modules if sys.modules[n] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
