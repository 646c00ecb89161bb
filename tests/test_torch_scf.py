"""The port's RHF and Hamiltonian builder against the reference's, on the
CPU: the published H2O/STO-3G SCF energy; E_HF, the irreps and the MO
integrals of H2O/cc-pVDZ, N2/cc-pVDZ (r = 2.068 and the stretched 4.2) and
Ne/aug-cc-pVDZ built by ``fries_tpu.scf`` and ``fries_tpu_torch.scf`` from
one geometry, compared after the gauge alignment (signs, and the rotation
inside the clusters of degenerate MOs of one irrep that Ne's d shells
have); ``match_reference`` on permuted, sign-flipped and rotated inputs;
and the MO orthonormality check the port adds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fries_tpu import gto as jgto, scf as jscf, sto3g as jsto3g  # noqa: E402
from fries_tpu_torch import gto as tgto, real_systems, scf as tscf, sto3g as tsto3g  # noqa: E402

CPU = "cpu"
E_H2O_SCF_LIT = -74.942079928192   # Crawford programming projects, STO-3G


def test_h2o_sto3g_scf_matches_published():
    s, t, v, eri, e_nuc = tgto.integrals(*tgto.WATER_GEOM, device=CPU)
    _, e_el = tsto3g.rhf(s, t + v, eri, 10)
    assert abs(e_el + e_nuc - E_H2O_SCF_LIT) < 1e-9
    c, mo_e, e_el2 = tscf.rhf(s, t + v, eri, 10)
    assert abs(e_el2 + e_nuc - E_H2O_SCF_LIT) < 1e-9
    js, jt, jv, jeri, _ = jgto.integrals(*jgto.WATER_GEOM)
    assert e_el == pytest.approx(jsto3g.rhf(js, jt + jv, jeri, 10)[1], abs=1e-10)


def test_water_sto3g_molecule_matches_reference():
    """gto.molecule's frozen-core fold: core energy and the MO integrals'
    sign-free invariants."""
    jham, jcore = jgto.water(n_frozen=1)
    tham, tcore = tgto.water(n_frozen=1, device=CPU)
    assert tcore == pytest.approx(jcore, abs=1e-10)
    assert (tham.n_orb, tham.n_elec) == (jham.n_orb, jham.n_elec)
    np.testing.assert_allclose(np.abs(tham.hcore.numpy()), np.abs(np.asarray(jham.hcore)),
                               atol=1e-9)


@pytest.mark.parametrize("name", ["h2o_ccpvdz", "n2_ccpvdz", "n2_stretched", "ne_augccpvdz"])
def test_build_molecule_matches_reference(name):
    symbols, centers, basis, n_frozen = real_systems.SYSTEMS[name]
    jham, jinfo = jscf.build_molecule(symbols, centers, basis=basis, n_frozen=n_frozen)
    tham, tinfo = real_systems.build(name, CPU)
    assert abs(tinfo["e_hf_total"] - jinfo["e_hf_total"]) < 1e-10
    assert abs(tinfo["e_elec"] - jinfo["e_elec"]) < 1e-10
    assert tinfo["e_nuc"] == pytest.approx(jinfo["e_nuc"], abs=1e-12)
    np.testing.assert_array_equal(tinfo["irreps"], jinfo["irreps"])
    np.testing.assert_array_equal(tham.symm.numpy(), np.asarray(jham.symm))
    assert (tham.n_orb, tham.n_elec, tham.n_frozen) == (jham.n_orb, jham.n_elec, jham.n_frozen)
    np.testing.assert_allclose(tinfo["mo_energy"].numpy(), jinfo["mo_energy"], atol=1e-9)
    o, off = tscf.gauge_alignment(tinfo["C"], torch.as_tensor(jinfo["C"]), tinfo["S"],
                                  tinfo["mo_energy"], tinfo["irreps"])
    assert off < 1e-8
    blocks = int((o.abs() > 1e-12).sum()) - o.shape[0]
    assert (blocks > 0) == (name == "ne_augccpvdz")   # Ne's two Ag d pairs
    hcore, eris = tscf.rotate_mo_integrals(tham.hcore, tham.eris, o)
    np.testing.assert_allclose(hcore.numpy(), np.asarray(jham.hcore), rtol=0, atol=1e-10)
    np.testing.assert_allclose(eris.numpy(), np.asarray(jham.eris), rtol=0, atol=1e-10)


def test_rhf_orders_eigenpairs_itself(monkeypatch):
    """rhf sorts each eigh's eigenpairs: with eigh returning them in
    reverse order (cuSOLVER can misorder a degenerate cluster in its last
    bits), the build equals the plain one."""
    want, want_info = real_systems.build("ne_augccpvdz", CPU)
    eigh = torch.linalg.eigh

    def reversed_eigh(a):
        w, v = eigh(a)
        return w.flip(0), v.flip(1)

    monkeypatch.setattr(torch.linalg, "eigh", reversed_eigh)
    got, info = real_systems.build("ne_augccpvdz", CPU)
    assert info["e_hf_total"] == pytest.approx(want_info["e_hf_total"], abs=1e-12)
    np.testing.assert_array_equal(info["irreps"], want_info["irreps"])
    np.testing.assert_allclose(info["mo_energy"].numpy(), want_info["mo_energy"].numpy(),
                               atol=1e-12)
    assert bool((info["mo_energy"].diff() >= 0).all())


@pytest.fixture(scope="module")
def n2_hcore():
    ham, info = real_systems.build("n2_ccpvdz", CPU)
    return info["hcore_mo"].numpy(), info["mo_energy"].numpy(), info["irreps"]


def test_match_reference_matches_reference(n2_hcore):
    """Both packages' match_reference on one input, with and without the
    target's irreps: the target is our hcore with each degenerate (pi) pair
    swapped and every third MO's sign flipped; and a target that differs
    beyond the gauge raises in both."""
    h, mo_e, irreps = n2_hcore
    n = len(mo_e)
    perm = np.arange(n)
    pairs = [a for a, b in tscf._clusters(mo_e, 1e-7) if b - a == 2]
    assert pairs
    for a in pairs:
        perm[[a, a + 1]] = perm[[a + 1, a]]
    sign = np.where(np.arange(n) % 3 == 0, -1.0, 1.0)
    h_ref = sign[:, None] * h[np.ix_(perm, perm)] * sign[None, :]
    for ref_irreps in (None, irreps[perm]):
        want = jscf.match_reference(h, h_ref, mo_e, irreps, ref_irreps=ref_irreps)
        got = tscf.match_reference(torch.as_tensor(h), h_ref, torch.as_tensor(mo_e), irreps,
                                   ref_irreps=ref_irreps)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-12)
        assert got[2] == pytest.approx(want[2], abs=1e-12)
        assert got[2] < 1e-9
    bad = h_ref + 1e-3 * np.eye(n)
    for fn in (jscf.match_reference, tscf.match_reference):
        with pytest.raises(RuntimeError, match="beyond phase freedom"):
            fn(h, bad, mo_e, irreps)


def test_orthonormality_check_raises_on_corrupted_c():
    """purify_and_label checks C^T S C = I: two MOs of one irrep mixed by
    1e-3 pass the symmetry labelling but fail the check."""
    symbols, centers, basis, _ = real_systems.SYSTEMS["h2o_ccpvdz"]
    s, t, v, eri, _, meta = tgto.integrals_cc(symbols, centers, basis, device=CPU)
    ops, reps = tscf.symmetry_ops(centers, np.array([8.0, 1.0, 1.0]), meta, device=CPU)
    group = torch.stack([torch.eye(len(meta), dtype=torch.float64)]
                        + [reps[0] @ r for r in reps[1:]] + list(reps[1:]))
    c, mo_e, _ = tscf.rhf(s, t + v, eri, 10, sym_group=torch.unique(group, dim=0))
    c_ok, irreps = tscf.purify_and_label(c, mo_e, s, ops, reps)
    assert tscf.check_orthonormal(c_ok, s) <= 1e-10
    k = next(k for k in range(5, len(irreps)) if irreps[k + 1] == irreps[k])
    bad = c.clone()
    bad[:, k] = bad[:, k] + 1e-3 * bad[:, k + 1]
    with pytest.raises(RuntimeError, match="orthonormal"):
        tscf.purify_and_label(bad, mo_e, s, ops, reps)
    with pytest.raises(RuntimeError, match="orthonormal"):
        tscf.check_orthonormal(bad, s)


def test_symmetry_ops_match_reference():
    """The detected operations, their AO representations and the irrep ids
    of every character vector: C2v for H2O, D2h for N2 and Ne."""
    import itertools

    for name in ("h2o_ccpvdz", "n2_ccpvdz", "ne_augccpvdz"):
        symbols, centers, basis, _ = real_systems.SYSTEMS[name]
        shells, charges = tgto.build_shells(symbols, centers, basis)
        meta = tgto.sph_transform(shells, CPU)[1]
        jops, jmats = jscf.symmetry_ops(centers, charges, meta)
        tops, tmats = tscf.symmetry_ops(centers, charges, meta, device=CPU)
        assert tops == jops and len(tops) == (4 if name == "h2o_ccpvdz" else 8)
        for a, b in zip(tmats, jmats):
            np.testing.assert_array_equal(a.numpy(), b)
        for chars in itertools.product((1, -1), repeat=len(jops) - 1):
            full = (1,) + chars
            try:
                want = jscf._irrep_id(jops, full)
            except KeyError:
                with pytest.raises(KeyError):
                    tscf._irrep_id(tops, full)
                continue
            assert tscf._irrep_id(tops, full) == want
