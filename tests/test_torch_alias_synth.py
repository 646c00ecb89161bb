"""The port's Walker alias tables and ``synth.h2o_ccpvdz_like`` against the
reference package: ``compress.setup_alias`` equals the reference's tables
exactly; ``compress.sample_alias`` draws from the port's key tree, not
JAX's, so it is held to the target distribution in statistics: a chi-square
over 10^6 draws of 13 categories (two of them of probability zero, never
drawn) below 52.3, its 1e-7 upper quantile at 10 degrees of freedom (a fixed
key: deterministic); and the H2O/cc-pVDZ-sized system's integrals equal
the reference's exactly, seed for seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fries_tpu import compress as jcomp, synth as jsynth  # noqa: E402
from fries_tpu_torch import compress as tcomp, rng, synth as tsynth  # noqa: E402

CHI2_BOUND = 52.3     # scipy.stats.chi2.isf(1e-7, 10) = 52.31


def distributions():
    rng_ = np.random.default_rng(4)
    p = rng_.random(13) ** 3
    p[[2, 9]] = 0.0
    return [p / p.sum(), np.full(7, 1 / 7), np.asarray([1.0]), np.asarray([0.5, 0.0, 0.5])]


@pytest.mark.parametrize("case", range(4))
def test_setup_alias_matches_reference(case):
    p = distributions()[case]
    ta, tp = tcomp.setup_alias(p)
    ja, jp = jcomp.setup_alias(p)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tp, jp)
    assert ta.dtype == np.int64 and tp.dtype == np.float64


def test_sample_alias_distribution():
    p = distributions()[0]
    aliases, probs = tcomp.setup_alias(p)
    n = 1_000_000
    draws = tcomp.sample_alias(rng.KeyTree(11), aliases, probs, (n,))
    assert draws.dtype == torch.int32 and draws.shape == (n,)
    counts = np.bincount(draws.numpy(), minlength=len(p))
    assert counts[p == 0].sum() == 0
    live = p > 0
    expected = n * p[live]
    chi2 = float((((counts[live] - expected) ** 2) / expected).sum())
    assert chi2 < CHI2_BOUND, chi2
    # a (2, 3) shape and a one-category table
    one = tcomp.sample_alias(rng.KeyTree(2), *tcomp.setup_alias([1.0]), (2, 3))
    assert one.shape == (2, 3) and (one == 0).all()


@pytest.mark.parametrize("seed", [0, 3])
def test_h2o_ccpvdz_like_matches_reference(seed):
    j = jsynth.h2o_ccpvdz_like(seed=seed)
    t = tsynth.h2o_ccpvdz_like(seed=seed)
    np.testing.assert_array_equal(t.hcore.numpy(), np.asarray(j.hcore))
    np.testing.assert_array_equal(t.eris.numpy(), np.asarray(j.eris))
    np.testing.assert_array_equal(t.symm.numpy(), np.asarray(j.symm))
    assert (t.n_orb, t.n_elec) == (j.n_orb, j.n_elec) == (24, 10)
