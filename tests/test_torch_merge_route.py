"""The merge dispatchers' routing rule and the two regimes past kernels A
and C's bounds, against the reference package on the CPU.

``merge.kernel_fits`` at its edges (rows 32 / 33, words 16 / 17, every
keep-mask layout, C + S at 2^31); on the CPU the dispatchers always take the
plain merges and count no card route; a frisys_hh step on keys of 17 words
(86 sites at ph_bits 4, 516 bits: one word more than kernel A takes) from
the reference's state and fed its draws: keys, counts and flags exact,
values at rtol 1e-10 (sums in another order).  The subspace at 33 trial
vectors is tests/test_torch_subspace_33.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu.drivers import frisys_hh as jfh  # noqa: E402
from fries_tpu.ops import hubbard as jhub  # noqa: E402
from fries_tpu_torch import profiling  # noqa: E402
from fries_tpu_torch.drivers import frisys_hh as tfh  # noqa: E402
from fries_tpu_torch.ops import hubbard as thub  # noqa: E402
from fries_tpu_torch.runtime import arena as tar, merge  # noqa: E402
from test_torch_frifull_hh import EST, assert_steps_match  # noqa: E402

FITS = [
    # (n_vecs, n_words, capacity, n_spawns, keep layout), fits
    ((1, 1, 1024, 4096, None), True),
    ((32, 2, 1024, 4096, None), True),
    ((33, 2, 1024, 4096, None), False),
    ((0, 2, 1024, 4096, None), False),
    ((2, 16, 1024, 4096, None), True),
    ((2, 17, 1024, 4096, None), False),
    ((2, 0, 1024, 4096, None), False),
    ((1, 2, 2**30, 2**30 - 1, None), True),
    ((1, 2, 2**30, 2**30, None), False),
    ((1, 2, 1024, 4096, (1, 0, 0)), True),
    ((2, 2, 1024, 4096, (2, 0, 1)), True),
    ((2, 16, 1024, 4096, (2, 0, 1)), True),
    ((2, 2, 1024, 4096, (2, 1, 0)), False),
    ((2, 2, 1024, 4096, (2, 0, 0)), False),
    ((3, 2, 1024, 4096, (3, 1, 2)), False),
    ((4, 2, 1024, 4096, (4, 0, 3)), False),
    ((4, 2, 1024, 4096, None), True),
    ((2, 17, 1024, 4096, (2, 0, 1)), False),
]


@pytest.mark.parametrize("shape,fits", FITS, ids=[str(s) for s, _ in FITS])
def test_kernel_fits_edges(shape, fits):
    assert merge.kernel_fits(*shape) is fits


def test_limits_are_the_wrappers():
    """One set of bounds: kernel C's row limit is kernel A's."""
    from fries_tpu_torch.runtime import merge_multi

    assert merge_multi.MAX_ROWS == merge.MAX_ROWS == 32 and merge.MAX_WORDS == 16
    assert merge.KEEP_LAYOUTS == ((1, 0, 0), (2, 0, 1))


def test_cpu_dispatch_counts_no_card_route():
    """On the CPU both dispatchers take the plain merges at any shape, and
    the card-route counter does not move."""
    rng = np.random.default_rng(3)
    a = tar.make(64, 17, 33)
    keys = torch.as_tensor(rng.integers(1, 50, size=(40, 17)))
    vals = torch.as_tensor(rng.standard_normal(40))
    ini = torch.ones(40, dtype=torch.bool)
    before = profiling.total("merge.plain_on_card")
    m1, _ = tar.accumulate_multi_best(a, keys, vals, torch.as_tensor(rng.integers(0, 33, 40)),
                                      ini)
    m2, _ = tar.accumulate_best(a, keys, vals, ini, 1, 2,
                                keep_mask=torch.zeros(64, dtype=torch.bool))
    assert profiling.total("merge.plain_on_card") == before
    assert int(m1.n_used[0]) == int(m2.n_used[0]) > 0


def test_frisys_hh_17_words_matches_reference():
    """Three frisys_hh steps on a half-filled 86-site chain at ph_bits 4
    (516 bits, W = 17) from the reference's state after two, fed its draws:
    the dispatcher's card route past kernel A's 16 words."""
    kw = dict(n_sites=86, n_elec=86, ph_bits=4, u=1.5, omega=0.7, g=0.4, t=1.0)
    jham, tham = jhub.HubbardHolstein(**kw), thub.HubbardHolstein(**kw)
    assert (tham.n_bits, tham.n_words) == (jham.n_bits, jham.n_words) == (516, 17)
    cfg = dict(eps=0.02, vec_nonz=30, matr_samp=80, capacity=512, spawn_cap=160,
               target_norm=200.0, shift_interval=2, init_thresh=1.0)
    jstep, _, jstate, jaux = jfh.build(jham, 0.1, jfh.FrisysHHConfig(**cfg), seed=3)
    tstep, _, _, taux = tfh.build(tham, 0.1, tfh.FrisysHHConfig(**cfg), seed=3)
    for k in EST:
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    for _ in range(2):
        jstate, _ = jstep(jstate, *[jaux[k] for k in EST])
    _, jm = assert_steps_match(jstep, jstate, jaux, tstep, taux, 3)
    assert int(jm["n_dets"]) > 20
