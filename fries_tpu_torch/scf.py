"""Symmetry-adapted restricted Hartree-Fock and the Hamiltonian builder for
correlation-consistent bases, on torch tensors.

Counterpart of ``fries_tpu/scf.py``: canonical-MO core Hamiltonian,
physicist-notation ERIs, PySCF-convention irrep labels (XOR-product
abelian groups) and the electronic HF energy, for the sign-flip subgroups
of D2h (D2h/C2v/C2h/D2/Cs/C2/Ci/C1).  The SCF (DIIS, group-averaged Fock)
and the MO transform run in float64 on the device of the integrals; the
point-group bookkeeping is host data.

Two differences from the reference:

* after :func:`purify_and_label` the MOs are checked to be orthonormal,
  ``C^T S C = I`` to 1e-10 (:func:`check_orthonormal`), and a build that
  fails the check raises; the reference never checks;
* the DIIS extrapolation solves with ``torch.linalg.solve_ex`` and falls
  back to the plain Fock matrix where the solve reports a singular B
  matrix (the reference's ``LinAlgError``) or gives non-finite weights;
* :func:`rhf` orders each ``eigh``'s eigenpairs itself: cuSOLVER can
  return a degenerate cluster out of ascending order in the last bits,
  which the reference's order check (kept in :func:`purify_and_label`)
  would refuse.

MO phases and the rotation inside a cluster of degenerate MOs of one
irrep are arbitrary in any HF code (LAPACK, MKL and cuSOLVER each return
their own); :func:`gauge_alignment` finds the orthogonal map between two
such MO sets and :func:`match_reference` aligns an MO basis with another
through its hcore matrix alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fries_tpu_torch import basis as basis_data
from fries_tpu_torch import gto
from fries_tpu_torch.ops import molecule as mol

F64 = torch.float64

# D2h sign-flip operations (sx, sy, sz) in a fixed order
_ALL_OPS = [
    (1, 1, 1), (-1, -1, 1), (-1, 1, -1), (1, -1, -1),
    (-1, -1, -1), (1, 1, -1), (1, -1, 1), (-1, 1, 1),
]
_OP_NAMES = ["E", "C2z", "C2y", "C2x", "i", "sxy", "sxz", "syz"]


def symmetry_ops(centers, charges, ao_meta, tol=1e-7, device="cuda"):
    """Detect the sign-flip point group and build signed-permutation AO
    representation matrices.

    Returns (op_signs, rep_mats): the subset of `_ALL_OPS` that maps the
    nuclear frame onto itself and, for each, the (nao, nao) float64 tensor
    R_g on ``device`` with (R_g)_{ij} = ±1 if AO j maps onto AO i."""
    centers = np.atleast_2d(np.asarray(centers, float))
    nao = len(ao_meta)
    atom_aos = {}
    for idx, (atom, _, _, _) in enumerate(ao_meta):
        atom_aos.setdefault(atom, []).append(idx)
    ops, mats = [], []
    for signs in _ALL_OPS:
        mapped = centers * np.asarray(signs, float)
        perm = []
        for i in range(len(centers)):
            d = np.linalg.norm(centers - mapped[i], axis=1)
            j = int(np.argmin(d))
            if d[j] > tol or abs(charges[i] - charges[j]) > 1e-12:
                break
            perm.append(j)
        else:
            r = np.zeros((nao, nao))
            for idx, (atom, _, _, par) in enumerate(ao_meta):
                src_list, tgt_list = atom_aos[atom], atom_aos[perm[atom]]
                tgt_idx = tgt_list[src_list.index(idx)]
                r[tgt_idx, idx] = (signs[0] ** par[0]) * (signs[1] ** par[1]) \
                    * (signs[2] ** par[2])
            ops.append(signs)
            mats.append(torch.tensor(r, dtype=F64, device=device))
    return ops, mats


def _irrep_id(op_signs, chars):
    """PySCF irrep ID from the character vector over ``op_signs`` (the XOR
    convention: D2h ag..b3u = 0..7; C2v a1, a2, b1, b2 = 0..3; ...)."""
    ch = {s: c for s, c in zip(op_signs, chars)}

    def c(name):
        return ch.get(_ALL_OPS[_OP_NAMES.index(name)], None)

    n = len(op_signs)
    if n == 8:  # D2h
        code = {(1, 1, 1): 0, (1, -1, -1): 1, (-1, 1, -1): 2,
                (-1, -1, 1): 3}[(c("C2z"), c("C2y"), c("C2x"))]
        return code + (0 if c("i") > 0 else 4)
    if n == 4 and c("C2z") is not None and c("sxz") is not None:  # C2v(z)
        if c("C2z") > 0:
            return 0 if c("sxz") > 0 else 1
        return 2 if c("sxz") > 0 else 3
    if n == 4 and c("C2z") is not None and c("i") is not None:  # C2h
        if c("i") > 0:
            return 0 if c("C2z") > 0 else 1
        return 2 if c("C2z") > 0 else 3
    if n == 4:  # D2
        return {(1, 1, 1): 0, (1, -1, -1): 1, (-1, 1, -1): 2,
                (-1, -1, 1): 3}[(c("C2z"), c("C2y"), c("C2x"))]
    if n == 2:
        other = [s for s in op_signs if s != (1, 1, 1)][0]
        return 0 if ch[other] > 0 else 1
    return 0  # C1


def rhf(s, hcore, eri_chem, n_elec, max_iter=200, tol=1e-11, sym_group=None, guess="gwh"):
    """Closed-shell RHF with DIIS.  Returns (C, mo_energy, e_elec).

    ``sym_group``: optional (n_ops, nao, nao) tensor of AO-basis point-group
    operations; when given, the Fock matrix is group-averaged each
    iteration (PySCF's symmetry=True).  ``guess``: "gwh" (generalized
    Wolfsberg-Helmholz; finds the bonded solution of stretched N2) or
    "core"."""
    n_occ = n_elec // 2
    evals, evecs = torch.linalg.eigh(s)
    x = evecs @ torch.diag(evals ** -0.5) @ evecs.T
    if guess == "gwh":
        hd = torch.diagonal(hcore)
        f = 0.5 * 1.75 * s * (hd[:, None] + hd[None, :])
        f.diagonal().copy_(hd)
    else:
        f = hcore
    errs, focks = [], []
    e_el = 0.0
    mo_e = c = None
    for it in range(max_iter):
        if sym_group is not None:
            f = (sym_group.transpose(1, 2) @ f @ sym_group).sum(0) / len(sym_group)
        mo_e, cp = torch.linalg.eigh(x.T @ f @ x)
        # cuSOLVER can leave a degenerate cluster out of ascending order in
        # its last bits (Ne/cc-pVQZ's g shell): order the pairs here
        order = torch.argsort(mo_e, stable=True)
        mo_e, c = mo_e[order], x @ cp[:, order]
        d = 2.0 * c[:, :n_occ] @ c[:, :n_occ].T
        g = (torch.einsum("ijkl,kl->ij", eri_chem, d)
             - 0.5 * torch.einsum("ikjl,kl->ij", eri_chem, d))
        f_new = hcore + g
        err = f_new @ d @ s - s @ d @ f_new
        errs.append(err)
        focks.append(f_new)
        if len(errs) > 8:
            errs.pop(0)
            focks.pop(0)
        e_new, err_max = (float(v) for v in torch.stack(
            [0.5 * torch.sum(d * (hcore + f_new)), err.abs().max()]).cpu())
        converged = it > 1 and abs(e_new - e_el) < tol and err_max < 1e-8
        e_el = e_new
        if converged:
            break
        m = len(errs)
        if m > 1:   # DIIS extrapolation
            e_stack = torch.stack(errs)
            b = -torch.ones((m + 1, m + 1), dtype=F64, device=s.device)
            b[m, m] = 0.0
            b[:m, :m] = torch.einsum("iab,jab->ij", e_stack, e_stack)
            rhs = torch.zeros(m + 1, dtype=F64, device=s.device)
            rhs[m] = -1.0
            w, info = torch.linalg.solve_ex(b, rhs)
            w = w[:m].cpu()
            if int(info) == 0 and bool(torch.isfinite(w).all()):
                f = sum(float(wi) * fi for wi, fi in zip(w, focks))
            else:
                f = f_new
        else:
            f = f_new
    return c, mo_e, e_el


def _clusters(mo_e, degen_tol):
    """(start, end) ranges of MOs whose energies lie within ``degen_tol``
    of the cluster's first."""
    mo_e = np.asarray(mo_e)
    out, start = [], 0
    for i in range(1, len(mo_e) + 1):
        if i == len(mo_e) or mo_e[i] - mo_e[start] > degen_tol:
            out.append((start, i))
            start = i
    return out


def check_orthonormal(c, s, tol=1e-10):
    """Raise unless the MO coefficients ``c`` are S-orthonormal: max
    |C^T S C - I| <= ``tol``.  Returns that deviation."""
    dev = float((c.T @ s @ c - torch.eye(c.shape[1], dtype=c.dtype, device=c.device)
                 ).abs().max())
    if not dev <= tol:
        raise RuntimeError(f"MOs not orthonormal: max|C^T S C - I| = {dev:.3e} > {tol:.0e}")
    return dev


def purify_and_label(c, mo_e, s, op_signs, rep_mats, degen_tol=1e-7):
    """Rotate degenerate MOs onto symmetry-pure combinations and assign
    PySCF irrep IDs.  Returns (C_pure, irreps (numpy int32)); raises if the
    result is not orthonormal (:func:`check_orthonormal`)."""
    nmo = c.shape[1]
    c = c.clone()
    mo_e_h = mo_e.cpu().numpy()
    if not np.all(np.diff(mo_e_h) >= 0):
        raise RuntimeError(f"MO energies are not finite and ascending: {mo_e_h.tolist()}")
    clusters = _clusters(mo_e_h, degen_tol)
    weights = [1.0, np.pi, np.e, np.sqrt(2), np.sqrt(3), np.sqrt(5),
               np.sqrt(7), np.sqrt(11)][: len(rep_mats)]
    lam = sum(w * r for w, r in zip(weights, rep_mats))
    for a, b in clusters:
        if b - a == 1:
            continue
        blk = c[:, a:b]
        m = blk.T @ s @ lam @ blk
        _, v = torch.linalg.eigh(0.5 * (m + m.T))
        c[:, a:b] = blk @ v
    reps = torch.stack(rep_mats)
    chars_all = torch.einsum("ak,ab,gbc,ck->kg", c, s, reps, c).cpu().numpy()
    irreps = np.zeros(nmo, np.int32)
    for k in range(nmo):
        vals = chars_all[k]
        chars = [1 if val > 0 else -1 for val in vals]
        if np.any(np.abs(np.abs(vals) - 1.0) > 1e-9):
            # finite SCF convergence leaks tiny cross-irrep components:
            # project onto the dominant irrep, P = prod_r (I + s_r R_r)/2,
            # then S-orthogonalize against the same-irrep MOs before it
            vec = c[:, k].clone()
            for sgn, r in zip(chars, rep_mats):
                vec = 0.5 * (vec + sgn * (r @ vec))
            want_id = _irrep_id(op_signs, chars)
            for j in range(k):
                if irreps[j] == want_id:
                    vec = vec - (c[:, j] @ s @ vec) * c[:, j]
            nrm = float(vec @ s @ vec)
            if nrm < 0.25:
                raise RuntimeError(f"MO {k} not symmetry-purifiable (projected norm {nrm:.3f})")
            c[:, k] = vec / np.sqrt(nrm)
            for r, want in zip(rep_mats, chars):
                val = float(c[:, k] @ s @ r @ c[:, k])
                if abs(val - want) > 1e-8:
                    raise RuntimeError(f"MO {k} impure after projection (char {val:.8f})")
        irreps[k] = _irrep_id(op_signs, chars)
    # PySCF orders exactly-degenerate MOs by ascending irrep ID
    for a, b in clusters:
        if b - a > 1:
            order = np.argsort(irreps[a:b], kind="stable")
            c[:, a:b] = c[:, a + torch.as_tensor(order, device=c.device)]
            irreps[a:b] = irreps[a + order]
    check_orthonormal(c, s)
    return c, irreps


def build_molecule(symbols, centers, basis="cc-pvdz", n_frozen=0, spherical=True,
                   device="cuda"):
    """Geometry -> (MolecularHamiltonian on ``device``, info dict).

    The Hamiltonian keeps frozen orbitals inside hcore/eris with the
    ``n_frozen`` field set.  info: e_elec, e_nuc, e_hf_total, mo_energy,
    irreps (all orbitals), C (AO -> MO), hcore_mo, S (AO overlap) and
    ``seconds`` (one_electron, eri, scf, mo_transform)."""
    centers = np.atleast_2d(np.asarray(centers, float))
    seconds = {}
    s, t, v, eri, e_nuc, ao_meta = gto.integrals_cc(symbols, centers, basis,
                                                    spherical=spherical, device=device,
                                                    timings=seconds)
    charges = np.asarray([basis_data.get_shells(basis, sym)[0] for sym in symbols], float)
    n_elec = int(charges.sum())
    hcore_ao = t + v
    t0 = time.perf_counter()
    op_signs, rep_mats = symmetry_ops(centers, charges, ao_meta, device=device)
    # the full abelian group from the generators' representations
    group = [torch.eye(s.shape[0], dtype=F64, device=device)]
    for r_m in rep_mats:
        group = group + [g @ r_m for g in group]
    uniq = []
    for g in group:
        if not any(torch.allclose(g, u) for u in uniq):
            uniq.append(g)
    c, mo_e, e_elec = rhf(s, hcore_ao, eri, n_elec, sym_group=torch.stack(uniq))
    c, irreps = purify_and_label(c, mo_e, s, op_signs, rep_mats)
    gto.sync(device)
    t1 = time.perf_counter()
    ham, info = _ham_from_mos(hcore_ao, eri, c, irreps, n_elec, n_frozen)
    gto.sync(device)
    seconds.update(scf=t1 - t0, mo_transform=time.perf_counter() - t1)
    info.update(e_elec=e_elec, e_nuc=e_nuc, e_hf_total=e_elec + e_nuc, mo_energy=mo_e, S=s,
                seconds=seconds)
    return ham, info


def _ham_from_mos(hcore_ao, eri_ao_chem, c, irreps, n_elec, n_frozen):
    """Transform to the MO basis and wrap as MolecularHamiltonian."""
    hmo = c.T @ hcore_ao @ c
    eri_mo = torch.einsum("ijkl,ip,jq,kr,ls->pqrs", eri_ao_chem, c, c, c, c)
    tot_orb = hmo.shape[0]
    n_frz_orb = n_frozen // 2
    ham = mol.MolecularHamiltonian(
        hcore=hmo.contiguous(), eris=eri_mo.permute(0, 2, 1, 3).contiguous(),
        symm=torch.as_tensor(np.asarray(irreps[n_frz_orb:], np.int64), device=hmo.device),
        n_orb=tot_orb - n_frz_orb, n_elec=n_elec - n_frozen, n_frozen=n_frozen)
    return ham, {"C": c, "irreps": irreps, "hcore_mo": hmo}


def gauge_alignment(c, c_ref, s, mo_e, irreps, degen_tol=1e-7):
    """The orthogonal map O between two MO sets of one AO basis that differ
    only in gauge: ``C_ref ~ C @ O`` with O = blockdiag over the clusters of
    degenerate MOs of one irrep (±1 for a single MO).  Returns (O, off):
    O as the orthogonal polar factor of each block of ``C^T S C_ref``, and
    ``off``, the largest |entry| of ``C^T S C_ref`` outside the blocks (zero
    when the two sets are the same orbitals).  MO integrals rotate as
    h_ref = O^T h O, eri_ref = eri x O x O x O x O (every index)."""
    full = (c.T @ s @ c_ref).cpu().numpy()
    n = full.shape[0]
    o = np.zeros_like(full)
    mask = np.zeros((n, n), bool)
    for a, b in _clusters(mo_e.cpu().numpy() if torch.is_tensor(mo_e) else mo_e, degen_tol):
        for ir in sorted(set(int(x) for x in irreps[a:b])):
            idx = np.array([k for k in range(a, b) if irreps[k] == ir])
            u, _, vt = np.linalg.svd(full[np.ix_(idx, idx)])
            o[np.ix_(idx, idx)] = u @ vt
            mask[np.ix_(idx, idx)] = True
    off = float(np.abs(np.where(mask, 0.0, full)).max()) if (~mask).any() else 0.0
    return torch.tensor(o, dtype=F64, device=c.device), off


def rotate_mo_integrals(hcore, eris, o):
    """(hcore, physicist eris) carried across the orthogonal MO map ``o``
    (:func:`gauge_alignment`): h' = O^T h O, <pq|rs>' over O on each index."""
    return (o.T @ hcore @ o,
            torch.einsum("abcd,ap,bq,cr,ds->pqrs", eris, o, o, o, o))


def match_reference(hmo_ours, hmo_ref, mo_e, irreps, ref_irreps=None,
                    degen_tol=1e-7, rtol=1e-6):
    """Align our MO basis with a reference MO basis via its hcore matrix.

    Returns (perm, U, err) such that ``C[:, perm] @ U`` reproduces the
    reference orbitals: the permutation only swaps (near-)degenerate
    orbitals (matched by irrep against ``ref_irreps`` when given, by hcore
    diagonal otherwise), U is orthogonal and block-diagonal over
    degenerate same-irrep groups (±1 phases for singletons).  Raises if
    the bases differ by more than that gauge freedom.  Small matrices on
    the host: tensors are read into numpy, the results are numpy."""
    as_np = lambda x: None if x is None else (
        x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
    hmo_ours, hmo_ref, mo_e = as_np(hmo_ours), as_np(hmo_ref), as_np(mo_e)
    irreps, ref_irreps = as_np(irreps), as_np(ref_irreps)
    n = hmo_ours.shape[0]
    perm = np.arange(n)
    clusters = _clusters(mo_e, degen_tol)
    for start, end in clusters:
        if end - start > 1:
            used = []
            if ref_irreps is not None:
                ours_ir = [int(irreps[k]) for k in range(start, end)]
                for k in range(start, end):
                    want = int(ref_irreps[k])
                    used.append(next(jj for jj, ir in enumerate(ours_ir)
                                     if ir == want and jj not in used))
            else:
                ours = np.array([hmo_ours[k, k] for k in range(start, end)])
                for r in (hmo_ref[k, k] for k in range(start, end)):
                    used.append(int(np.argmin([abs(o - r) if jj not in used else np.inf
                                               for jj, o in enumerate(ours)])))
            perm[start:end] = start + np.asarray(used)
    h = hmo_ours[np.ix_(perm, perm)]
    # the gauge after the permutation: U orthogonal and block-diagonal over
    # (degenerate cluster) x (same irrep); solved by per-block orthogonal
    # Procrustes sweeps from a spanning-tree sign propagation
    blocks = []
    for start, end in clusters:
        members = list(range(start, end))
        if ref_irreps is not None:
            by_ir = {}
            for k in members:
                by_ir.setdefault(int(ref_irreps[k]), []).append(k)
            blocks.extend(sorted(by_ir.values()))
        else:
            blocks.append(members)
    u = np.eye(n)
    scale = np.max(np.abs(hmo_ref))
    sgn = np.ones(n)
    thresh = 1e-4 * scale
    order = np.argsort(-np.abs(hmo_ref), axis=None)
    visited = np.zeros(n, bool)
    edges = [(i, j) for e in order for i, j in [divmod(int(e), n)] if i != j
             and abs(hmo_ref[i, j]) > thresh and abs(h[i, j]) > thresh]
    # one component per irrep block (plus isolated rows): seed each with +1
    while not visited.all():
        visited[int(np.argmin(visited))] = True
        changed = True
        while changed:
            changed = False
            for i, j in edges:
                if visited[i] != visited[j]:
                    a, b = (i, j) if visited[i] else (j, i)
                    sgn[b] = sgn[a] * np.sign(h[i, j] * hmo_ref[i, j])
                    visited[b] = True
                    changed = True
    u = u * sgn[None, :]
    for sweep in range(60):
        cur = u.T @ h @ u
        if np.max(np.abs(cur - hmo_ref)) < 0.3 * rtol * scale and sweep > 1:
            break
        improved = False
        for blk in blocks:
            idx = np.asarray(blk)
            other = np.setdiff1d(np.arange(n), idx)
            hu = h @ u
            m = (u[:, idx].T @ hu[:, other]) @ hmo_ref[np.ix_(idx, other)].T
            uu, _, vv = np.linalg.svd(m)
            r = uu @ vv
            if np.max(np.abs(r - np.eye(len(idx)))) > 1e-12:
                u[:, idx] = u[:, idx] @ r
                improved = True
        if not improved:
            break
    err = np.max(np.abs(u.T @ h @ u - hmo_ref))
    if err > rtol * scale:
        raise RuntimeError(f"MO bases differ beyond phase freedom: max|dh| = {err:.3e}")
    return perm, u, err
