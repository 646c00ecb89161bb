"""The port's atomic RHF tools (``fries_tpu_torch.atomic_hf``,
``fries_tpu_torch.derive_ccpvqz``) against ``tools/atomic_hf.py`` and
``tools/derive_ccpvqz.py``: the closed-form same-center one-electron
integrals and ERI blocks, the (s, p) basis's integrals and ``atom_energy``
on a small set (1e-10); ``atomic_rhf_uncontracted`` on the batched engine
against the script's scalar one on a small set (the energy to 1e-10, the
1s / 2s / 2p rows to 1e-8); and the Ne cc-pVQZ derivation: its energy just
below the literature -128.543470 Ha and its rows ``basis.py``'s to 5e-7."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu_torch import atomic_hf, basis, derive_ccpvqz, gto  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S_EXPS, P_EXPS = [57.0, 10.3, 2.1, 0.5], [3.1, 0.7]


def script(name):
    spec = importlib.util.spec_from_file_location(
        f"tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return script("atomic_hf")


@pytest.mark.parametrize("ls", [(0, 0), (1, 1), (0, 1), (1, 0)])
def test_same_center_one_electron(ref, ls):
    a, b = np.array([[1.3], [0.4], [25.0]]), np.array([[0.7, 2.2, 90.0]])
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for name in ("_overlap_cart", "_kinetic_cart"):
        np.testing.assert_allclose(getattr(atomic_hf, name)(*ls, ta, tb).numpy(),
                                   getattr(ref, name)(*ls, a, b), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(atomic_hf._nuclear_cart(*ls, ta, tb, 10.0).numpy(),
                               ref._nuclear_cart(*ls, a, b, 10.0), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("ls", [(0, 0, 0, 0), (1, 1, 0, 0), (0, 1, 0, 1), (1, 1, 1, 1)])
def test_same_center_eri_block(ref, ls):
    from fries_tpu import gto as jgto

    exps = {0: S_EXPS, 1: P_EXPS}
    zero = np.zeros(3)
    jsh = [jgto.Shell(l, zero, exps[l], np.ones(len(exps[l])), 0) for l in ls]
    tsh = [gto.Shell(l, zero, exps[l], np.ones(len(exps[l])), 0) for l in ls]
    want = ref._same_center_eri(*jsh)
    got = atomic_hf._same_center_eri(*tsh, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


def test_sp_basis_integrals_and_energy(ref):
    want = ref.AtomSPBasis(S_EXPS, P_EXPS, 10).integrals()
    got = atomic_hf.AtomSPBasis(S_EXPS, P_EXPS, 10, device="cpu").integrals()
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-12)
    e = atomic_hf.atom_energy(S_EXPS, P_EXPS, device="cpu")
    assert abs(e - ref.atom_energy(S_EXPS, P_EXPS)) < 1e-10


def script_rows(c, ns, npr):
    """tools/derive_ccpvqz.py's main's rows: the two lowest s orbitals over
    the s rows, the x components of the lowest p orbital (scaled here to
    unit 2-norm: their scale is the orbital's direction's x part)."""
    s_mos = [i for i in range(c.shape[1]) if np.abs(c[:ns, i]).sum() > 1e-6]
    px = ns + 3 * np.arange(npr)
    p_mo = next(i for i in range(c.shape[1]) if np.abs(c[px, i]).sum() > 1e-6)
    rows = {"1s": c[:ns, s_mos[0]], "2s": c[:ns, s_mos[1]],
            "2p": c[px, p_mo] / np.linalg.norm(c[px, p_mo])}
    return {k: derive_ccpvqz._positive(v) for k, v in rows.items()}


def test_atomic_rhf_uncontracted_against_the_script():
    e_ref, c_ref, _, _ = script("derive_ccpvqz").atomic_rhf_uncontracted(S_EXPS, P_EXPS)
    e, c, _ = derive_ccpvqz.atomic_rhf_uncontracted(S_EXPS, P_EXPS, device="cpu")
    assert abs(e - e_ref) < 1e-10
    _, rows = derive_ccpvqz.contractions(S_EXPS, P_EXPS, device="cpu")
    want = script_rows(np.asarray(c_ref), len(S_EXPS), len(P_EXPS))
    assert tuple(c.shape) == np.asarray(c_ref).shape
    for name in ("1s", "2s", "2p"):
        np.testing.assert_allclose(rows[name], want[name], rtol=0, atol=1e-8, err_msg=name)


def test_ne_ccpvqz_derivation():
    e, rows = derive_ccpvqz.contractions(basis._NE_QZ_S_EXP, basis._NE_QZ_P_EXP, device="cpu")
    assert -128.5435 < e < derive_ccpvqz.E_HF_LITERATURE
    for name, row in derive_ccpvqz.BASIS_ROWS.items():
        np.testing.assert_allclose(rows[name], row, rtol=0, atol=5e-7, err_msg=name)


def test_new_tools_import_neither_jax_nor_the_scripts():
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; sys.modules['fries_tpu'] = None\n"
            "sys.modules['tools'] = None\n"
            "import fries_tpu_torch.anchor_scale, fries_tpu_torch.make_fcidump\n"
            "import fries_tpu_torch.atomic_hf, fries_tpu_torch.derive_ccpvqz\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'fries_tpu.', 'tools.')) "
            "for m in sys.modules if sys.modules[m] is not None)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
