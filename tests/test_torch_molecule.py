"""fries_tpu_torch.ops (molecule, heat_bath), synth and io against the
reference package: matrix elements, diagonals, heat-bath tables and
probability rows, selection weights.  rtol 1e-13 (the reference's one-hot
matmul gathers reconstruct f64 table entries to ~2^-48, the port indexes
them exactly)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from fries_tpu import dets as jd  # noqa: E402
from fries_tpu import io as jio  # noqa: E402
from fries_tpu import synth as jsynth  # noqa: E402
from fries_tpu.ops import heat_bath as jhb  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu_torch import convert, dets as td, io as tio, synth as tsynth  # noqa: E402
from fries_tpu_torch.ops import heat_bath as thb  # noqa: E402
from fries_tpu_torch.ops import molecule as tmol  # noqa: E402

RTOL = 1e-13
SYMM = np.array([0, 1, 0, 1, 0, 1, 2, 3])


def pair(n_frozen=0):
    """The same system in both packages (8 orbitals, 4 active electrons)."""
    j = jsynth.make_system(8, 6, symm=SYMM, seed=3)
    if n_frozen:
        f = n_frozen // 2
        j = jmol.MolecularHamiltonian(j.hcore, j.eris, j.symm[f:], 8 - f, 6 - n_frozen,
                                      n_frozen)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), np.asarray(j.symm),
                            j.n_orb, j.n_elec, j.n_frozen)
    return j, t


def sample_dets(j, n, seed):
    rng = np.random.default_rng(seed)
    bits = np.zeros((n, j.n_bits), bool)
    for i in range(n):
        for spin in range(2):
            bits[i, spin * j.n_orb + rng.choice(j.n_orb, j.n_elec // 2, replace=False)] = True
    words = np.asarray(jd.pack_bits(jnp.asarray(bits)))
    occ = np.asarray(jd.occ_list(jnp.asarray(words), j.n_bits, j.n_elec))
    return words, occ, bits


def i64(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("n_frozen", [0, 2])
def test_matrix_elements_and_diagonal(n_frozen):
    j, t = pair(n_frozen)
    words, occ, bits = sample_dets(j, 40, 1)
    close(tmol.diag_matrel(t, i64(occ)).numpy(), jmol.diag_matrel(j, jnp.asarray(occ)))
    close(tmol.diag_matrel_chunked(t, i64(occ), chunk=16).numpy(),
          jmol.diag_matrel(j, jnp.asarray(occ)))
    rng = np.random.default_rng(2)
    o1, o2 = occ[:, 0], occ[:, -1]
    virt = np.stack([np.flatnonzero(~row) for row in bits])
    u1, u2 = virt[:, 0], virt[:, rng.integers(1, virt.shape[1], 40)][0]
    close(tmol.doub_matr_el(t, i64(o1), i64(o2), i64(u1), i64(u2)).numpy(),
          jmol.doub_matr_el(j, *(jnp.asarray(x) for x in (o1, o2, u1, u2))))
    same = np.stack([np.flatnonzero(~row[(o // j.n_orb) * j.n_orb:(o // j.n_orb + 1) * j.n_orb])[0]
                     + (o // j.n_orb) * j.n_orb for row, o in zip(bits, o1)])
    close(tmol.sing_matr_el(t, i64(o1), i64(same), i64(occ)).numpy(),
          jmol.sing_matr_el(j, jnp.asarray(o1), jnp.asarray(same), jnp.asarray(occ)))
    jw, jo, je = jmol.hf_reference(j)
    tw, to, te = tmol.hf_reference(t)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    close(float(te), float(je))


def test_exact_offdiag_batch_and_enumeration():
    j, t = pair()
    words, occ, _ = sample_dets(j, 6, 3)
    tmpl = jmol.ExcitationTemplate.build(j.n_orb, j.n_elec)
    ttmpl = tmol.ExcitationTemplate.build(t.n_orb, t.n_elec)
    for f in ("d_e1", "d_e2", "d_t1", "d_t2", "s_e", "s_t"):
        np.testing.assert_array_equal(getattr(ttmpl, f), getattr(tmpl, f))
    vals = np.linspace(-1.0, 2.0, 6)
    jw, ja, jo = jmol.exact_offdiag_batch(j, tmpl, jnp.asarray(words), jnp.asarray(occ),
                                          jnp.asarray(vals), -0.1)
    tw, ta = tmol.exact_offdiag_batch(t, ttmpl, i64(words), i64(occ),
                                      torch.as_tensor(vals), -0.1)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    live = (tw != td.WORD_MASK).any(-1).numpy()   # masked candidates hold the sentinel
    assert live.any() and not live.all()
    np.testing.assert_array_equal(td.occ_list(tw, t.n_bits, t.n_elec).numpy()[live],
                                  np.asarray(jo)[live])
    close(ta.numpy(), ja)


def test_heat_bath_tables_and_rows():
    j, t = pair()
    jt, tt = jhb.setup(j), thb.setup(t)
    for f in ("d_same", "d_diff", "s_tens", "s_norm", "exch_sqrt", "exch_norms"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)))
    words, occ, bits = sample_dets(j, 50, 4)
    n, e = j.n_orb, j.n_elec
    rng = np.random.default_rng(5)
    o1_idx = rng.integers(0, e, 50)
    jocc, tocc = jnp.asarray(occ), i64(occ)
    for jr, tr in zip(jhb.o1_probs(jt, n, jocc), thb.o1_probs(tt, n, tocc)):
        close(tr.numpy(), jr)
    for fn in ("o2_probs", "o2_probs_half"):
        jr = getattr(jhb, fn)(jt, n, e, jocc, jnp.asarray(o1_idx))
        tr = getattr(thb, fn)(tt, n, e, tocc, i64(o1_idx))
        for a, b in zip(tr, jr):
            close(a.numpy(), b)
    o1_orb = occ[np.arange(50), o1_idx]
    excl = rng.random(50) < 0.5
    jr = jhb.u1_probs(jt, n, e, jnp.asarray(bits), jnp.asarray(o1_orb), jnp.asarray(excl))
    tr = thb.u1_probs(tt, n, e, torch.as_tensor(bits), i64(o1_orb), torch.as_tensor(excl))
    for a, b in zip(tr, jr):
        close(a.numpy(), b)
    si = tmol.SymmInfo.build(SYMM)
    jsi = jmol.SymmInfo.build(SYMM)
    np.testing.assert_array_equal(si.lookup, jsi.lookup)
    o2_orb = occ[:, 0]
    u1_orb = np.asarray(jr[2])[:, 0] + (o1_orb // n) * n
    for half in (False, True):
        jr2 = jhb.u2_probs(jt, n, jnp.asarray(SYMM), jnp.asarray(jsi.lookup),
                           jnp.asarray(o1_orb), jnp.asarray(o2_orb), jnp.asarray(u1_orb),
                           occ_bits=jnp.asarray(bits), half=half)
        tr2 = thb.u2_probs(tt, n, i64(SYMM), i64(si.lookup), i64(o1_orb), i64(o2_orb),
                           i64(u1_orb), occ_bits=torch.as_tensor(bits), half=half)
        for a, b in zip(tr2, jr2):
            close(a.numpy(), b)
    counts_j = jhb.unocc_symm_counts(n, e, jnp.asarray(SYMM), jnp.asarray(jsi.counts), jocc)
    counts_t = thb.unocc_symm_counts(n, e, i64(SYMM), i64(si.counts), tocc)
    np.testing.assert_array_equal(counts_t.numpy(), np.asarray(counts_j))
    for a, b in zip(thb.sing_allowed(n, e, i64(SYMM), counts_t, tocc),
                    jhb.sing_allowed(n, e, jnp.asarray(SYMM), counts_j, jocc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_selection_weights():
    j, t = pair()
    jt, tt = jhb.setup(j), thb.setup(t)
    words, occ, bits = sample_dets(j, 60, 6)
    n = j.n_orb
    rng = np.random.default_rng(7)
    o_lo, o_hi = occ[:, 0], occ[np.arange(60), rng.integers(1, j.n_elec, 60)]
    virt = [np.flatnonzero(~row) for row in bits]
    u = np.stack([rng.choice(v, 2, replace=False) for v in virt])
    u_lo, u_hi = u.min(1), u.max(1)
    js = jmol.SymmInfo.build(SYMM)
    args_j = [jnp.asarray(x) for x in (o_lo, o_hi, u_lo, u_hi)]
    args_t = [i64(x) for x in (o_lo, o_hi, u_lo, u_hi)]
    close(thb.unnorm_weight(tt, n, *args_t).numpy(), jhb.unnorm_weight(jt, n, *args_j))
    close(thb.norm_weight(tt, n, j.n_elec, i64(SYMM), i64(js.lookup), i64(occ),
                          torch.as_tensor(bits), *args_t).numpy(),
          jhb.norm_weight(jt, n, j.n_elec, jnp.asarray(SYMM), jnp.asarray(js.lookup),
                          jnp.asarray(occ), jnp.asarray(bits), *args_j))


def test_synth_bit_identical_and_fcidump_roundtrip(tmp_path):
    j = jsynth.n2_ccpvdz_like(seed=1)
    t = tsynth.n2_ccpvdz_like(seed=1)
    np.testing.assert_array_equal(t.hcore.numpy(), np.asarray(j.hcore))
    np.testing.assert_array_equal(t.eris.numpy(), np.asarray(j.eris))
    np.testing.assert_array_equal(t.symm.numpy(), np.asarray(j.symm))
    assert (t.n_orb, t.n_elec) == (28, 14)
    small = jsynth.make_system(6, 4, symm=np.array([0, 1, 0, 1, 2, 3]), seed=2)
    path = tmp_path / "FCIDUMP"
    jio.write_fcidump(small, path, point_group="D2h", core_energy=1.25)
    th, tcore = tio.parse_fcidump(path, "D2h")
    jh, jcore = jio.parse_fcidump(path, "D2h", native=False)
    assert tcore == jcore == 1.25
    np.testing.assert_array_equal(th.hcore.numpy(), np.asarray(jh.hcore))
    np.testing.assert_array_equal(th.eris.numpy(), np.asarray(jh.eris))
    np.testing.assert_array_equal(th.symm.numpy(), np.asarray(jh.symm))
    path2 = tmp_path / "FCIDUMP2"
    tio.write_fcidump(th, path2, point_group="D2h", core_energy=1.25)
    assert path2.read_text() == path.read_text()
