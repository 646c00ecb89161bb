"""Re-derive the Ne cc-pVQZ s / p contraction coefficients by Dunning's
construction: the contracted 1s, 2s and 2p functions are the atomic-HF
orbitals of the uncontracted (12s, 6p) HF set (Dunning, JCP 90, 1007
(1989), sec. II).  The exponents are ``basis.py``'s (the standard published
cc-pVQZ values); the check is the uncontracted RHF energy, which must sit
just below the literature E_HF(Ne, cc-pVQZ) = -128.543470 Ha, and the rows
must equal ``basis.py``'s (``_NE_QZ_1S``, ``_NE_QZ_2S``, ``_NE_QZ_2P``) to
the 5e-7 of their seven printed decimals.

Counterpart of ``tools/derive_ccpvqz.py``: the integrals come from the
port's batched engine (:func:`fries_tpu_torch.gto.shell_integrals`, one
primitive per shell), in place of the script's scalar per-AO helpers, and
the SCF is :func:`fries_tpu_torch.atomic_hf.rhf` (the script's density
mixing; canonical orthogonalization, which keeps every overlap eigenvalue
of this set, where the script orthogonalizes symmetrically: the same
orbitals).  The 2p row is the radial part of the lowest p orbital, which the
SCF returns as any rotation of the degenerate three: the orbital's (6, 3)
coefficients are r u^T for a direction u, so r is read along u and scaled
to unit 2-norm, as ``basis.py``'s row is; the script prints the x
components of whichever rotation it gets.

    python -m fries_tpu_torch.derive_ccpvqz            # on the card
    python -m fries_tpu_torch.derive_ccpvqz --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from fries_tpu_torch import basis as basis_data
from fries_tpu_torch import atomic_hf, cli, gto

E_HF_LITERATURE = -128.543470


def atomic_rhf_uncontracted(s_exps, p_exps, n_elec=10, z=10, device="cuda"):
    """RHF of an atom in an uncontracted (s, p) primitive set (one shell per
    primitive, the s shells first; normalized spherical AOs).  Returns
    (E, C (n_ao, n_mo), MO energies)."""
    zero = np.zeros(3)
    shells = ([gto.Shell(0, zero, [e], [1.0], 0) for e in s_exps]
              + [gto.Shell(1, zero, [e], [1.0], 0) for e in p_exps])
    s_ao, t_ao, v_ao, eri, _, _ = gto.shell_integrals(shells, np.zeros((1, 3)),
                                                      np.asarray([float(z)]), device=device)
    return atomic_hf.rhf(s_ao, t_ao, v_ao, eri, n_elec, max_iter=200)


def _positive(c):
    """``c`` with its largest-magnitude entry positive."""
    return c if c[np.abs(c).argmax()] >= 0 else -c


def contractions(s_exps, p_exps, device="cuda"):
    """(E, {"1s", "2s": the two lowest s orbitals over the s primitives;
    "2p": the lowest p orbital's radial part over the p primitives, unit
    2-norm}) of the uncontracted atomic RHF."""
    e, c, _ = atomic_rhf_uncontracted(s_exps, p_exps, device=device)
    c = c.cpu().numpy()
    ns, npr = len(s_exps), len(p_exps)
    s_rows, p_rows = c[:ns], c[ns:ns + 3 * npr]
    s_mos = [i for i in range(c.shape[1]) if np.abs(s_rows[:, i]).sum() > 1e-6]
    p_mo = next(i for i in range(c.shape[1]) if np.abs(p_rows[:, i]).sum() > 1e-6)
    rows = {"1s": _positive(s_rows[:, s_mos[0]]), "2s": _positive(s_rows[:, s_mos[1]])}
    pc = p_rows[:, p_mo].reshape(npr, 3)              # r_i u_k
    u = pc[np.linalg.norm(pc, axis=1).argmax()]
    r = pc @ (u / np.linalg.norm(u))
    rows["2p"] = _positive(r / np.linalg.norm(r))
    return e, rows


BASIS_ROWS = {"1s": basis_data._NE_QZ_1S, "2s": basis_data._NE_QZ_2S,
              "2p": basis_data._NE_QZ_2P}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m fries_tpu_torch.derive_ccpvqz",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = cli._device(args)
    s_all, p_all = list(basis_data._NE_QZ_S_EXP), list(basis_data._NE_QZ_P_EXP)
    print(f"# 12s: {s_all}\n# 6p: {p_all}")
    e, rows = contractions(s_all, p_all, dev)
    print(f"# uncontracted RHF e_tot = {e:.8f}  (literature cc-pVQZ {E_HF_LITERATURE:.6f}; "
          f"uncontracted should be slightly below)")
    for name, over in (("1s", "12s"), ("2s", "12s"), ("2p", "6p")):
        print(f"# {name} contraction over {over} (max |row - basis.py| "
              f"{np.abs(rows[name] - BASIS_ROWS[name]).max():.1e}):")
        print("[" + ",\n ".join(f"{v:.7f}" for v in rows[name]) + "]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
