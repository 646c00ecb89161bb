"""Command line of the port: the ``frisys_mol`` workload.

Same flags and per-iteration output streams as ``python -m fries_tpu.cli
frisys_mol`` (projnum.txt, projden.txt, S.txt, norm.txt, N.txt, nini.txt,
nkept.txt, nnonz.txt, sgn_coh.txt, plus params.txt and arena_occ.txt).  Runs
on the first CUDA device when there is one, else on the CPU.  The other
workloads of the reference exit with "not ported yet".

Usage:  python -m fries_tpu_torch.cli frisys_mol --fcidump_path FCIDUMP \\
            --epsilon 1e-3 --vec_nonz 100000 --mat_nonz 100000 \\
            --max_dets 1000000 --max_iter 10000
"""

from __future__ import annotations

import argparse
import os
import sys

_OTHER_WORKLOADS = (
    "frifull_mol", "frimulti_mol", "fciqmc_mol", "fciqmc_fp_mol", "frifull_hh",
    "frisys_hh", "subsp_mol", "subsp_mol_lowmem", "subspfull_mol",
    "observables_mol", "obs_repl_mol", "dice_dots",
)

_STREAMS = {
    "proj_num": "projnum.txt", "proj_den": "projden.txt", "shift": "S.txt",
    "norm": "norm.txt", "n_dets": "N.txt", "n_ini": "nini.txt",
    "nkept": "nkept.txt", "nnonz": "nnonz.txt", "sgn_coh": "sgn_coh.txt",
}


def _parser():
    parser = argparse.ArgumentParser(prog="fries_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("frisys_mol", help="systematic HB-PP FCI-FRI")
    p.add_argument("--fcidump_path")
    p.add_argument("--hf_path")
    p.add_argument("--point_group", default="C1")
    p.add_argument("--result_dir", default="./")
    p.add_argument("--max_iter", type=int, default=1000000)
    p.add_argument("--max_dets", type=int, required=True)
    p.add_argument("--initiator", type=float, default=0.0, dest="init_thresh")
    p.add_argument("--target", type=float, default=0.0, dest="target_norm")
    p.add_argument("--save_interval", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load_dir")
    p.add_argument("--n_chips", type=int, default=1)
    p.add_argument("--epsilon", type=float, required=True)
    p.add_argument("--vec_nonz", type=int, required=True)
    p.add_argument("--mat_nonz", type=int, required=True)
    p.add_argument("--distribution", default="HB", choices=["HB", "HB_unnorm"])
    p.add_argument("--det_space")
    p.add_argument("--trial_vec")
    p.add_argument("--ini_vec")
    p.add_argument("--ham_shift", type=float)
    return parser


def _unported(args):
    for flag, why in (("hf_path", "HF-directory input"),
                      ("load_dir", "checkpoint resume"),
                      ("det_space", "the semistochastic subspace"),
                      ("trial_vec", "trial vectors from files"),
                      ("ini_vec", "initial vectors from files")):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} ({why}) is not ported yet")
    if args.n_chips > 1:
        raise NotImplementedError("--n_chips > 1 is not ported yet")
    if not args.fcidump_path:
        raise SystemExit("frisys_mol needs --fcidump_path")


def run_frisys(args):
    import torch

    from fries_tpu_torch import io
    from fries_tpu_torch.drivers import frisys
    from fries_tpu_torch.runtime import arena as ar

    _unported(args)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    ham, core_en = io.parse_fcidump(args.fcidump_path, args.point_group, device=device)
    e_ref = None if args.ham_shift is None else args.ham_shift - core_en
    cfg = frisys.FrisysConfig(
        eps=args.epsilon, vec_nonz=args.vec_nonz, matr_samp=args.mat_nonz,
        capacity=args.max_dets, spawn_cap=int(args.mat_nonz * 1.4),
        init_thresh=args.init_thresh, target_norm=args.target_norm,
        unnorm=args.distribution == "HB_unnorm")
    _, run_steps, state, aux = frisys.build(ham, cfg, seed=args.seed, e_ref=e_ref)

    os.makedirs(args.result_dir, exist_ok=True)
    with open(os.path.join(args.result_dir, "params.txt"), "w") as f:
        for k, v in sorted(vars(args).items()):
            f.write(f"{k}: {v}\n")
    est = (aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
           aux["ref_key"])
    files = {k: open(os.path.join(args.result_dir, v), "a") for k, v in _STREAMS.items()}
    try:
        block = min(args.save_interval, 100)
        done = 0
        while done < args.max_iter:
            n = min(block, args.max_iter - done)
            state, traj = run_steps(state, *est, n)
            traj = {k: v.cpu().numpy() for k, v in traj.items()}
            if traj["overflow"].any():
                raise SystemExit(
                    "ERROR: spawn/arena buffer overflow in the block ending at "
                    f"iteration {done + n}; results from this block are invalid. "
                    "Re-run with larger --max_dets (or mat_nonz spawn capacity)")
            for name, f in files.items():
                for x in traj[name]:
                    f.write(repr(x.item()) + "\n")
                f.flush()
            done += n
            print(f"{done}, en est: {traj['proj_num'][-1] / traj['proj_den'][-1]:.8f}, "
                  f"shift: {traj['shift'][-1]:.6f}, norm: {traj['norm'][-1]:.2f}")
            if done % args.save_interval == 0 or done >= args.max_iter:
                occ = ar.occupancy_stats(state.arena)
                with open(os.path.join(args.result_dir, "arena_occ.txt"), "a") as f:
                    f.write(f"{done},{occ['used']},{occ['capacity']},"
                            f"{occ['fill']:.4f},{occ['live']},{occ['nonzero']},"
                            f"{occ['zero_live']}\n")
    finally:
        for f in files.values():
            f.close()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _OTHER_WORKLOADS:
        raise SystemExit(f"{argv[0]}: not ported yet (the port runs frisys_mol only)")
    return run_frisys(_parser().parse_args(argv))


if __name__ == "__main__":
    main()
