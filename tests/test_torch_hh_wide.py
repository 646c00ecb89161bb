"""The port's Hubbard-Holstein model on rows wider than 64 bits against the
reference package: 13 sites with ph_bits 3 (65 bits: the last counter's top
bit alone in the third word) and 16 sites with ph_bits 3 (80 bits, the
``frisys_hh_wide`` configuration's lattice), each with counters across
word boundaries.  The phonon counters, ``with_phonon``, the diagonal, the
off-diagonal candidate grid, the Neel state, the reference connections and
the parameter file: words, masks and counts exact, amplitudes at rtol 1e-12
(products of the couplings in another order), as at 64 bits and below
(tests/test_torch_hubbard.py); then frisys_hh and frifull_hh steps from the
reference's state fed its draws (keys, counts and flags exact, values at
rtol 1e-10)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fries_tpu import dets as jd, io as jio  # noqa: E402
from fries_tpu.drivers import frifull_hh as jff, frisys_hh as jfh, power as jpower  # noqa: E402
from fries_tpu.ops import hubbard as jhub  # noqa: E402
from fries_tpu_torch import dets as td, io as tio  # noqa: E402
from fries_tpu_torch.drivers import frifull_hh as tff, frisys_hh as tfh  # noqa: E402
from fries_tpu_torch.drivers import power as tpower  # noqa: E402
from fries_tpu_torch.ops import hubbard as thub  # noqa: E402
from test_torch_frifull_hh import EST, assert_steps_match  # noqa: E402
from test_torch_hubbard import COUPLINGS, models, random_words, t64  # noqa: E402

WIDE = [(13, 3), (16, 3)]


@pytest.mark.parametrize("n_sites,ph_bits", WIDE)
def test_wide_rows_model(n_sites, ph_bits):
    """Sizes, phonon numbers, the diagonal and the occupied lists."""
    jham, tham = models(n_sites, ph_bits)
    assert tham.n_bits == n_sites * (2 + ph_bits) and tham.n_words == 3
    assert (tham.n_bits, tham.n_words, tham.max_ph) == (jham.n_bits, jham.n_words, jham.max_ph)
    words, tw = random_words(n_sites, ph_bits, n=200)
    jw = jnp.asarray(words)
    np.testing.assert_array_equal(thub.phonon_nums(tham, tw).numpy(),
                                  np.asarray(jhub.phonon_nums(jham, jw)))
    np.testing.assert_array_equal(thub.diag_matrel(tham, tw).numpy(),
                                  np.asarray(jhub.diag_matrel(jham, jw)))
    np.testing.assert_array_equal(thub.occ_list(tham, tw).numpy(),
                                  np.asarray(jhub.occ_list(jham, jw)))


@pytest.mark.parametrize("n_sites,ph_bits", WIDE)
def test_wide_with_phonon(n_sites, ph_bits):
    """Every site set to every value, counters across the word boundaries
    (at 13 sites: site 6's bits 62-64 span words 1 and 2; at 16 sites site
    0's bits 32-34 open word 1, site 10's 62-64 span words 1 and 2)."""
    jham, tham = models(n_sites, ph_bits)
    words, tw = random_words(n_sites, ph_bits, n=n_sites * (jham.max_ph + 1))
    site = np.repeat(np.arange(n_sites), jham.max_ph + 1)
    num = np.tile(np.arange(jham.max_ph + 1), n_sites)
    got = thub.with_phonon(tham, tw, torch.as_tensor(site), torch.as_tensor(num))
    want = jhub.with_phonon(jham, jnp.asarray(words), jnp.asarray(site), jnp.asarray(num))
    np.testing.assert_array_equal(got.numpy(), t64(want))
    np.testing.assert_array_equal(thub.phonon_nums(tham, got).numpy()[np.arange(len(site)), site],
                                  num)


@pytest.mark.parametrize("n_sites,ph_bits", WIDE)
def test_wide_offdiag_batch(n_sites, ph_bits):
    jham, tham = models(n_sites, ph_bits)
    words, tw = random_words(n_sites, ph_bits, n=96)
    vals = np.random.default_rng(3).standard_normal(len(words))
    vals[::7] = 0.0
    jw, ja = jhub.offdiag_batch(jham, jnp.asarray(words), jnp.asarray(vals), -0.02)
    tw2, ta = thub.offdiag_batch(tham, tw, torch.as_tensor(vals), -0.02)
    assert ta.shape == (len(words), thub.n_candidates(tham))
    np.testing.assert_array_equal(tw2.numpy(), t64(jw))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-12, atol=0)
    assert (ta != 0).sum() > 10 * len(words)


@pytest.mark.parametrize("n_sites,ph_bits", WIDE)
def test_wide_neel_connections_and_params(n_sites, ph_bits, tmp_path):
    """neel_bits_1d and reference_connections at 65 and 80 bits, and the
    parameter file of the lattice."""
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
    path = tmp_path / "params.txt"
    path.write_text(f"n_elec\n{n_sites}\nlat_len\n{n_sites}\nn_dim\n1\neps\n0.01\nU\n2.0\n"
                    "omega\n1.0\ng\n0.5\ngs_energy\n-3.25\n")
    assert tio.parse_hh_input(path) == jio.parse_hh_input(path)


def wide_model(n_sites):
    kw = dict(n_sites=n_sites, n_elec=n_sites, ph_bits=3, **COUPLINGS)
    return jhub.HubbardHolstein(**kw), thub.HubbardHolstein(**kw)


@pytest.mark.parametrize("n_sites", [13, 16])
def test_wide_frisys_hh_steps_match_reference(n_sites):
    """Four steps of frisys_hh from the reference's state after four, each
    fed the reference's draws."""
    jham, tham = wide_model(n_sites)
    cfg = dict(eps=0.02, vec_nonz=60, matr_samp=200, capacity=1024, spawn_cap=320,
               target_norm=400.0, shift_interval=2, init_thresh=1.0)
    jstep, _, jstate, jaux = jfh.build(jham, 0.1, jfh.FrisysHHConfig(**cfg), seed=3)
    tstep, _, _, taux = tfh.build(tham, 0.1, tfh.FrisysHHConfig(**cfg), seed=3)
    for k in EST:
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    for _ in range(4):
        jstate, _ = jstep(jstate, *[jaux[k] for k in EST])
    _, jm = assert_steps_match(jstep, jstate, jaux, tstep, taux, 4)
    assert int(jm["n_dets"]) > 50


@pytest.mark.parametrize("n_sites", [13, 16])
def test_wide_frifull_hh_steps_match_reference(n_sites):
    """Three frifull_hh steps from the reference's state after three, fed
    its draws; the whole stream in one merge."""
    jham, tham = wide_model(n_sites)
    cfg = dict(eps=0.02, target_nonz=60, capacity=4096, target_norm=400.0, shift_interval=2,
               init_thresh=1.0)
    jstep, _, jstate, jaux = jff.build(jham, 0.1, jpower.PowerConfig(**cfg), seed=3)
    tstep, _, _, taux = tff.build(tham, 0.1, tpower.PowerConfig(**cfg), seed=3)
    for _ in range(3):
        jstate, _ = jstep(jstate, *[jaux[k] for k in EST])
    _, jm = assert_steps_match(jstep, jstate, jaux, tstep, taux, 3)
    assert int(jm["n_dets"]) > 50
    assert np.asarray(jstate.arena.keys).shape[1] == 3


def test_frisys_hh_wide_configuration():
    """``frisys_hh_wide``: frisys_hh's couplings and budgets on 16 sites
    with ph_bits 3 (80 bits, three words); the 12-site frisys_hh keeps
    its two words."""
    from fries_tpu_torch import rung

    wide, narrow = rung.frisys_hh_wide_system(), rung.frisys_hh_system()
    assert (wide.n_sites, wide.n_elec, wide.ph_bits, wide.n_bits, wide.n_words) == \
        (16, 16, 3, 80, 3)
    assert (narrow.n_bits, narrow.n_words) == (60, 2)
    assert (wide.u, wide.omega, wide.g, wide.t) == (narrow.u, narrow.omega, narrow.g,
                                                    narrow.t) == (2.0, 1.0, 0.5, 1.0)
    cfg = rung.frisys_hh_config()
    assert (cfg.eps, cfg.vec_nonz, cfg.matr_samp, cfg.capacity, cfg.spawn_cap) == \
        (0.01, 1_000_000, 1_000_000, 1 << 21, 1_400_000)
