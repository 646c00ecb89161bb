"""The production-scale exact anchor: a 12-orbital / 6-electron synthetic
system spans C(12,3)^2 = 48,400 determinants, far past the dense-FCI
checks of the tests and large enough that production budgets (vec_nonz
2e4, matr_samp 1e5) really compress.  Its exact ground state comes from a
matrix-free Lanczos (H v through ``molecule.exact_offdiag_batch`` over the
whole enumerated basis, :func:`fries_tpu_torch.linalg.lanczos_ground_state`);
the frisys HB-PP driver then runs from HF with the Ritz vector's largest
components as the estimator's trial, and the exit code is 0 when the
projected energy lies within three times its 2 sigma of the Lanczos one.
That test is only as strong as the bar is narrow: on this strongly
correlated system the bar is hundreds of mEh to Ha (PERF.md), so an exit
code of 0 alone does not show that the run agrees with the exact energy.

Counterpart of ``tools/anchor_scale.py``, with its defaults, flags,
result line and exit code.  Differences by design:

* no cache file: the card runs the Lanczos in seconds, so each run solves
  it (``--e0`` still skips it, and then the trial is HF only);
* the trial's top-k Ritz components are chosen by
  :func:`fries_tpu_torch.cisd.largest`: |c| rounded to 1e-10, ties in the
  basis's key order, where the script's ``np.argsort`` is not stable;
* ``--run_seed`` draws another realization of the same system (the
  script's run seed is always ``--seed`` + 1, and ``--seed`` also makes
  the system);
* the result line adds the run seed, the Lanczos seconds, the device,
  the peak memory and two readings of the estimator's denominator after
  the burn-in (its smallest value and its spread, each over its mean): a
  spread far above 1 means the walkers' overlap with the trial changed
  sign, and the ratio of the averages then carries little information.

    python -m fries_tpu_torch.anchor_scale               # the 48,400 anchor
    python -m fries_tpu_torch.anchor_scale --h_chain 1.8 --n_orb 10

``--device`` defaults to ``cuda`` and stops where there is no card; pass
``--device cpu`` to run on the CPU (a small ``--n_orb``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from itertools import combinations
from math import comb

import numpy as np
import torch

from fries_tpu_torch import cisd, cli, dets, gto, linalg, stats, sto3g, synth
from fries_tpu_torch.drivers import frisys
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.ops import ordered


def full_basis_words(n_orb: int, n_alpha: int, n_beta: int, device="cpu"):
    """Every determinant of the (n_orb, n_alpha, n_beta) FCI space as
    (N, W) words on ``device``, in key order (alpha orbitals on bits
    0..n_orb-1, beta on n_orb..2 n_orb-1)."""
    alphas = [sum(1 << o for o in c) for c in combinations(range(n_orb), n_alpha)]
    betas = [sum(1 << o for o in c) for c in combinations(range(n_orb), n_beta)]
    n_w = dets.n_words(2 * n_orb)
    words = torch.tensor([[(a | b << n_orb) >> 32 * w & dets.WORD_MASK for w in range(n_w)]
                          for a in alphas for b in betas], dtype=torch.int64, device=device)
    return words[dets.sort_dets(words)]


def make_full_matvec(ham, basis_words, chunk: int = 2048):
    """(hv, diag): H v over the whole sorted basis by exact enumeration,
    ``chunk`` source determinants at a time, and H's diagonal."""
    d = basis_words.shape[0]
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    occ = dets.occ_list(basis_words, ham.n_bits, ham.n_elec)
    diag = mol.diag_matrel_chunked(ham, occ)

    def hv(v):
        y = diag * v
        for s in range(0, d, chunk):
            nw, amp = mol.exact_offdiag_batch(ham, tmpl, basis_words[s:s + chunk],
                                              occ[s:s + chunk], v[s:s + chunk], 1.0)
            pos, fnd = dets.lookup_dets(basis_words, nw.reshape(-1, ham.n_words))
            ordered.index_add(y, pos[fnd], amp.reshape(-1)[fnd])
        return y

    return hv, diag


def exact_energy(ham, n_alpha: int, n_beta: int, m: int = 80, chunk: int = 2048):
    """(E0, Ritz vector, basis words) of the lowest state in the
    (n_alpha, n_beta) sector, by Lanczos with ``m`` steps."""
    basis = full_basis_words(ham.n_orb, n_alpha, n_beta, ham.device)
    hv, _ = make_full_matvec(ham, basis, chunk=chunk)
    e0, ritz = linalg.lanczos_ground_state(hv, basis.shape[0], m=m, device=ham.device)
    return e0, ritz, basis


def ritz_trial(basis, ritz, k: int):
    """The estimator's trial: the ``k`` largest Ritz components
    (:func:`fries_tpu_torch.cisd.largest`), scaled to max |c| = 1, as numpy
    (words, coefficients)."""
    words, tv = cisd.largest(basis, ritz, k)
    return words, tv / np.abs(tv).max()


def anchor_config(args) -> frisys.FrisysConfig:
    """The run's FrisysConfig from :func:`parser`'s flags."""
    return frisys.FrisysConfig(
        eps=args.eps, vec_nonz=args.vec_nonz, matr_samp=args.matr_samp,
        capacity=args.capacity, spawn_cap=4 * args.matr_samp,
        target_norm=2.0 * args.vec_nonz, init_thresh=1.0)


def parser():
    ap = argparse.ArgumentParser(prog="python -m fries_tpu_torch.anchor_scale",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_orb", type=int, default=12)
    ap.add_argument("--n_elec", type=int, default=6)
    ap.add_argument("--h_chain", type=float, default=None,
                    help="a linear H_{n_orb} chain at this bond length (bohr) in STO-3G "
                         "on RHF orbitals in place of the synthetic system; n_elec = n_orb")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--run_seed", type=int, default=None,
                    help="the frisys run's seed (default --seed + 1): another realization "
                         "of the same system")
    ap.add_argument("--iters", type=int, default=12000)
    ap.add_argument("--burn", type=int, default=2000)
    ap.add_argument("--block", type=int, default=1000)
    ap.add_argument("--vec_nonz", type=int, default=20000)
    ap.add_argument("--matr_samp", type=int, default=100000)
    ap.add_argument("--lanczos_m", type=int, default=80)
    ap.add_argument("--capacity", type=int, default=1 << 17)
    ap.add_argument("--eps", type=float, default=0.02)
    ap.add_argument("--scan", type=int, default=25, help="iterations per run_steps call")
    ap.add_argument("--e0", type=float, default=None,
                    help="skip the Lanczos and take this exact energy (it must match "
                         "n_orb / n_elec / seed; the trial is then HF only)")
    ap.add_argument("--trial_k", type=int, default=256,
                    help="the estimator's trial: the top-k components of the Ritz vector "
                         "(0: HF only)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None, log=print):
    """The anchor; returns the exit code (0: |error| < 3 x 2 sigma)."""
    args = parser().parse_args(argv)
    dev = cli._device(args)
    core_energy = 0.0
    if args.h_chain is not None:
        args.n_elec = args.n_orb
        ham, core_energy = sto3g.h_chain(args.h_chain, args.n_orb, basis="rhf", device=dev)
        log(f"# H{args.n_orb} chain R={args.h_chain} bohr (RHF MOs) E_nuc={core_energy:.6f}")
    else:
        ham = synth.make_system(args.n_orb, args.n_elec, seed=args.seed, scale_two=0.1,
                                device=dev)
    half = args.n_elec // 2
    gto.sync(dev)
    t0 = time.perf_counter()
    ritz = basis = None
    if args.e0 is not None:
        e0 = args.e0
        dim = comb(args.n_orb, half) * comb(args.n_orb, args.n_elec - half)
    else:
        e0, ritz, basis = exact_energy(ham, half, args.n_elec - half, m=args.lanczos_m)
        dim = basis.shape[0]
    gto.sync(dev)
    t_lanczos = time.perf_counter() - t0
    log(f"# dim={dim} lanczos E0={e0:.9f} ({t_lanczos:.0f}s)")

    trial = None
    if args.trial_k and ritz is not None:
        # an HF-only trial gives an error bar of Ha on this strongly
        # correlated system; the Ritz top-k plays the production runs'
        # CISD / HCI trial
        trial = ritz_trial(basis, ritz, args.trial_k)
        log(f"# trial: top-{args.trial_k} Ritz components "
            f"(|c| >= {np.abs(trial[1]).min():.2e} of the largest)")

    run_seed = args.seed + 1 if args.run_seed is None else args.run_seed
    _, run_steps, state, aux = frisys.build(ham, anchor_config(args), seed=run_seed,
                                            trial=trial)
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    nums, dens = [], []
    t0 = time.perf_counter()
    n_blocks = -(-args.iters // args.block)
    n_sub = -(-args.block // args.scan)
    for i in range(n_blocks):
        for _ in range(n_sub):
            state, traj = run_steps(state, *est, args.scan)
            nums.append(traj["proj_num"].cpu().numpy().reshape(-1))
            dens.append(traj["proj_den"].cpu().numpy().reshape(-1))
            if bool(traj["overflow"].any()):
                break
        ov = bool(traj["overflow"].any())
        log(f"# block {i + 1}/{n_blocks} overflow={ov} ({time.perf_counter() - t0:.0f}s)")
        if ov:
            raise SystemExit("arena overflow")
    gto.sync(dev)
    seconds = time.perf_counter() - t0
    num, den = np.concatenate(nums), np.concatenate(dens)
    exact_corr = e0 - float(aux["e_ref"])
    out = stats.trajectory_stats(num, den, exact_corr=exact_corr, burn_in=args.burn)
    result = {
        "dim": dim,
        "system": (f"H{args.n_orb}/STO-3G R={args.h_chain}" if args.h_chain is not None
                   else f"synth-{args.n_orb}o{args.n_elec}e"),
        "e_total": e0 + core_energy,
        "lanczos_e0": e0,
        "e_ref": float(aux["e_ref"]),
        "exact_corr": exact_corr,
        "run_seed": run_seed,
        "iters": len(num),
        "vec_nonz": args.vec_nonz,
        "matr_samp": args.matr_samp,
        "error_mEh": float(out["error_mEh"]),
        "two_sigma_mEh": float(out["two_sigma_mEh"]),
        "iat": float(out["iat"]),
        "efficiency": float(out["efficiency"]),
        "sec_per_iter": seconds / len(num),
        "lanczos_s": t_lanczos,
        "device": str(dev),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        # how near the ratio estimator's denominator came to zero after the
        # burn-in: its smallest value and its spread over its mean
        "den_min_over_mean": float(den[args.burn:].min() / den[args.burn:].mean()),
        "den_std_over_mean": float(den[args.burn:].std() / den[args.burn:].mean()),
    }
    log(json.dumps(result))
    ok = abs(result["error_mEh"]) < 3 * result["two_sigma_mEh"]
    log(f"# |error| < 3*2sigma: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(log=lambda s: print(s, flush=True)))
