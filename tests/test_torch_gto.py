"""The port's integral pipeline against the reference's, on the CPU:
basis tables (and ``in`` / ``.get`` on every table), the Boys function, one
ERI shell quartet per angular-momentum class up to (gg|gg) from the
Ne/cc-pVQZ shells, the cartesian-to-spherical transform up to l = 4, the
correlation-consistent AO integrals of H2O and N2 in cc-pVDZ, and the
STO-3G integrals (s/p shells and the s-only closed forms).  The same
inputs go through ``fries_tpu.{basis,gto,sto3g}`` and
``fries_tpu_torch.{basis,gto,sto3g}``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fries_tpu import basis as jbasis, gto as jgto, sto3g as jsto3g  # noqa: E402
from fries_tpu_torch import basis as tbasis, gto as tgto, sto3g as tsto3g  # noqa: E402

CPU = "cpu"
R_H2O, TH_H2O = 1.84345, np.deg2rad(110.6)
H2O = (("O", "H", "H"), np.array([[0.0, 0.0, 0.0],
                                  [0.0, R_H2O * np.sin(TH_H2O / 2), R_H2O * np.cos(TH_H2O / 2)],
                                  [0.0, -R_H2O * np.sin(TH_H2O / 2), R_H2O * np.cos(TH_H2O / 2)]]))
N2 = (("N", "N"), np.array([[0.0, 0.0, -1.034], [0.0, 0.0, 1.034]]))


@pytest.mark.parametrize("name", ["cc-pvdz", "aug-cc-pvdz", "cc-pvqz"])
def test_basis_tables_equal(name):
    elements = ["Ne"] if name == "cc-pvqz" else ["H", "N", "O", "Ne"]
    for sym in elements:
        assert tbasis.get_shells(name, sym) == jbasis.get_shells(name, sym), sym
        assert tbasis.get_shells(name.upper(), sym) == tbasis.BASIS_SETS[name][sym]
    assert sorted(tbasis.BASIS_SETS[name]) == sorted(elements)


def test_basis_tables_in_and_get():
    """Every table is a plain dict: ``in`` and ``.get`` agree with ``[]``
    (the reference's lazy cc-pVQZ table answers False and None for Ne)."""
    for table in tbasis.BASIS_SETS.values():
        assert type(table) is dict
        for sym in ("H", "N", "O", "Ne", "Xe"):
            assert (sym in table) == (table.get(sym) is not None)
            if sym in table:
                assert table.get(sym) == table[sym]
    assert "Ne" in tbasis.CCPVQZ and tbasis.CCPVQZ.get("Ne")[0] == 10
    assert "H" not in tbasis.CCPVQZ and tbasis.CCPVQZ.get("H") is None
    with pytest.raises(KeyError):
        tbasis.get_shells("cc-pvqz", "H")


BOYS_X = np.array([0.0, 1e-14, 1e-8, 1e-3, 0.5, 1.0, 5.0, 10.0, 20.0, 30.0, 34.999, 35.0,
                   35.001, 50.0, 200.0])


@pytest.mark.parametrize("nmax", range(17))
def test_boys_matches_reference(nmax):
    ref = jgto._boys_vec(nmax, BOYS_X)
    got = tgto._boys_vec(nmax, torch.tensor(BOYS_X, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=0)


@pytest.fixture(scope="module")
def qz_shells():
    """Ne/cc-pVQZ's shells of both packages, one representative per l (the
    contracted s and p, the first d, f and g), at the origin and displaced
    so that the pair centres differ."""
    out = []
    for build in (jgto.build_shells, tgto.build_shells):
        a, _ = build(("Ne",), np.zeros((1, 3)), "cc-pvqz")
        b, _ = build(("Ne",), np.array([[0.3, -0.2, 1.1]]), "cc-pvqz")
        first = {}
        for i, sh in enumerate(a):
            first.setdefault(sh.l, i)
        out.append(({l: a[i] for l, i in first.items()}, {l: b[i] for l, i in first.items()}))
    return out


# every pair class (la >= lb) with itself, and mixed classes of every l
ERI_CLASSES = [(a, b, a, b) for a in range(5) for b in range(a + 1)] + [
    (0, 0, 4, 4), (4, 0, 1, 0), (3, 2, 1, 1), (4, 3, 2, 1), (4, 4, 3, 3), (2, 1, 3, 0),
    (1, 0, 0, 0), (2, 2, 0, 0)]


@pytest.mark.parametrize("cls", ERI_CLASSES,
                         ids=lambda c: "({}{}|{}{})".format(*("spdfg"[x] for x in c)))
def test_eri_quartet_matches_reference(qz_shells, cls):
    (ja, jb), (ta, tb) = qz_shells
    la, lb, lc, ld = cls
    ref = jgto._eri_quartet(jgto._PairData(ja[la], jb[lb]), jgto._PairData(jb[lc], ja[ld]))
    got = tgto._eri_quartet(tgto._PairData([(ta[la], tb[lb])], CPU),
                            tgto._PairData([(tb[lc], ta[ld])], CPU)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_sph_transform_matches_reference():
    """The block cart -> spherical matrix and metadata over s to g (the
    Ne/cc-pVQZ shells), and the per-harmonic parities."""
    js, _ = jgto.build_shells(("Ne",), np.zeros((1, 3)), "cc-pvqz")
    ts, _ = tgto.build_shells(("Ne",), np.zeros((1, 3)), "cc-pvqz")
    m_ref, meta_ref = jgto.sph_transform(js)
    m, meta = tgto.sph_transform(ts, CPU)
    np.testing.assert_array_equal(m.numpy(), m_ref)
    assert meta == meta_ref
    assert tgto._SPH_PARITY == jgto._SPH_PARITY
    assert tgto._CART_COMPS == jgto._CART_COMPS
    for l in range(5):
        np.testing.assert_array_equal(tgto._SPH_COEF[l], jgto._SPH_COEF[l])


@pytest.mark.parametrize("system", ["h2o", "n2"])
def test_integrals_cc_match_reference(system):
    symbols, centers = {"h2o": H2O, "n2": N2}[system]
    ref = jgto.integrals_cc(symbols, centers, "cc-pvdz")
    got = tgto.integrals_cc(symbols, centers, "cc-pvdz", device=CPU)
    for name, x, y in zip(("S", "T", "V", "ERI"), ref[:4], got[:4]):
        assert y.dtype == torch.float64
        np.testing.assert_allclose(y.numpy(), x, rtol=0, atol=1e-12, err_msg=name)
    assert got[4] == pytest.approx(ref[4], abs=1e-12)
    assert got[5] == ref[5]


def test_sto3g_sp_integrals_match_reference():
    ref = jgto.integrals(*jgto.WATER_GEOM)
    got = tgto.integrals(*jgto.WATER_GEOM, device=CPU)
    for x, y in zip(ref[:4], got[:4]):
        np.testing.assert_allclose(y.numpy(), x, rtol=0, atol=1e-12)
    assert got[4] == pytest.approx(ref[4], abs=1e-12)


def test_sto3g_s_integrals_match_reference():
    centers = np.array([[0, 0, 0], [0, 0, 1.4], [0.3, 0, 2.8]], float)
    ref = jsto3g.integrals(centers, charges=[1.0, 2.0, 1.0])
    got = tsto3g.integrals(centers, charges=[1.0, 2.0, 1.0], device=CPU)
    for x, y in zip(ref, got):
        np.testing.assert_allclose(y.numpy(), x, rtol=0, atol=1e-12)
    assert tsto3g.nuclear_repulsion(centers) == jsto3g.nuclear_repulsion(centers)


def test_h_chain_matches_reference():
    """The s-only RHF and Löwdin H-chain Hamiltonians."""
    for basis in ("lowdin", "rhf"):
        jham, jcore = jsto3g.h_chain(1.6, 4, basis=basis)
        tham, tcore = tsto3g.h_chain(1.6, 4, basis=basis, device=CPU)
        assert tcore == pytest.approx(jcore, abs=1e-14)
        if basis == "lowdin":
            np.testing.assert_allclose(tham.hcore.numpy(), np.asarray(jham.hcore), atol=1e-12)
            np.testing.assert_allclose(tham.eris.numpy(), np.asarray(jham.eris), atol=1e-12)
        else:   # MO signs are free: compare what they leave unchanged
            np.testing.assert_allclose(np.abs(tham.hcore.numpy()), np.abs(np.asarray(jham.hcore)),
                                       atol=1e-9)
