"""Command line of the port: every workload of ``python -m fries_tpu.cli``.

Same flags and per-iteration output streams as the reference:

* ``frifull_mol`` (exact H * v; no ``--mat_nonz``) and ``frisys_mol``
  (``--det_space`` a text file of deterministic-subspace determinants,
  ``--trial_vec`` / ``--ini_vec`` prefixes of ``<prefix>dets`` /
  ``<prefix>vals`` text files): projnum.txt, projden.txt, S.txt, norm.txt,
  N.txt, nini.txt, nkept.txt, nnonz.txt, sgn_coh.txt, plus params.txt and
  arena_occ.txt;
* ``frimulti_mol`` (``--distribution`` NU or HB, ``--trial_vec``,
  ``--ini_vec``, ``--ham_shift``): the same streams;
* ``fciqmc_mol`` (integer walkers, ``--distribution`` default NU) and
  ``fciqmc_fp_mol`` (fp walkers, default HB): ``--target`` is the walker
  target of the shift control, ``--attempt_cap`` the spawn attempts per
  step (default 4 x ``--target``, or 400,000), ``--epsilon`` defaults to
  1e-3 and there is no ``--vec_nonz``; the same streams but nini.txt and
  nkept.txt, which FCIQMC does not report;
* ``frifull_hh`` (exact H * v) and ``frisys_hh`` (``--mat_nonz``) on the
  Hubbard-Holstein model of ``--params_path`` (the keyed parameter file:
  n_elec, lat_len, n_dim, eps, U, omega, g, gs_energy), ``--ph_bits``
  phonon bits per site (default 3; 0 when g is 0); no ``--fcidump_path``
  and no ``--epsilon`` (eps comes from the file): the frisys streams;
* ``subsp_mol`` (``--time_reversal`` +1 / -1 for a spin-flip sector),
  ``subsp_mol_lowmem`` (<trial|H|v> enumerated every step, no stored H *
  trial) and ``subspfull_mol`` (exact H application): h_mat / d_mat
  (``--out_format`` txt, bin, npy or none), shifts.txt (the norm factors
  every shift interval), norms.txt, n_ini.txt and params.txt; the trial
  vectors are ``<prefix>XXdets`` / ``<prefix>XXvals`` text files or one
  ``.dice`` file;
* ``observables_mol`` (the Rayleigh estimator of O = sum_s a^+_cre,s
  a_des,s; ``--obs_des``, ``--obs_cre``, ``--exponent``, ``--burn_in``,
  ``--n_obs``, ``--btw_obs``) and ``obs_repl_mol`` (the replica estimator):
  obs_num.txt / obs_den.txt (the in-period steps of the Rayleigh estimator,
  every step of the replica one) and params.txt;
* ``dice_dots``: the overlap matrix of two sets of Dice / SHCI vectors
  (``--vecs1``, ``--vecs2``, ``--n_orb``, ``--n_states1``, ``--n_states2``),
  printed and written to dice_dots.txt in the working directory.

The molecular workloads read ``--fcidump_path`` or ``--hf_path`` (an HF
input directory, whose core energy is taken as 0).  Every driver but
``dice_dots`` writes ``checkpoint.npz`` every ``--save_interval``
iterations and at the end, and ``checkpoint_overflow.npz`` (the state
before the block) before it stops on an overflow; ``--load_dir DIR``
resumes from ``DIR/checkpoint.npz`` (:mod:`fries_tpu_torch.runtime.checkpoint`)
and appends to the streams.  All run on ``--device`` (default ``cuda``; a
run asking for CUDA where there is no CUDA device stops with an error,
``--device cpu`` runs the plain versions on the CPU).  ``frisys_mol
--n_chips N`` runs N hash-sharded ranks (:mod:`fries_tpu_torch.parallel`):
NCCL with one rank per card on ``cuda``, gloo on the CPU, or this process's
rank of a ``torchrun`` world; rank 0 writes the output files and the
checkpoints (in the reference's stacked layout), ``--load_dir`` resumes on
the same ``--n_chips``, and ``--max_dets`` is the capacity of each rank.
Every other subcommand raises on ``--n_chips > 1``.

Usage:  python -m fries_tpu_torch.cli frisys_mol --fcidump_path FCIDUMP \\
            --epsilon 1e-3 --vec_nonz 100000 --mat_nonz 100000 \\
            --max_dets 1000000 --max_iter 10000 [--det_space dets.txt]
        python -m fries_tpu_torch.cli frifull_mol --fcidump_path FCIDUMP \\
            --epsilon 5e-3 --vec_nonz 30000 --max_dets 262144
        python -m fries_tpu_torch.cli fciqmc_mol --fcidump_path FCIDUMP \\
            --target 1000000 --max_dets 1000000 --initiator 3
        python -m fries_tpu_torch.cli subsp_mol --fcidump_path FCIDUMP \\
            --epsilon 0.02 --vec_nonz 100000 --mat_nonz 200000 \\
            --max_dets 524288 --trial_vecs trial --num_trial 2
        python -m fries_tpu_torch.cli frisys_hh --params_path hubbard_params.txt \\
            --vec_nonz 100000 --mat_nonz 100000 --max_dets 1000000
        python -m fries_tpu_torch.cli observables_mol --fcidump_path FCIDUMP \\
            --epsilon 0.005 --vec_nonz 30000 --max_dets 262144 \\
            --obs_des 2 --obs_cre 3
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_STREAMS = {
    "proj_num": "projnum.txt", "proj_den": "projden.txt", "shift": "S.txt",
    "norm": "norm.txt", "n_dets": "N.txt", "n_ini": "nini.txt",
    "nkept": "nkept.txt", "nnonz": "nnonz.txt", "sgn_coh": "sgn_coh.txt",
}


def _add_run(p):
    """The flags of every workload."""
    p.add_argument("--result_dir", default="./")
    p.add_argument("--max_iter", type=int, default=1000000)
    p.add_argument("--max_dets", type=int, required=True)
    p.add_argument("--initiator", type=float, default=0.0, dest="init_thresh")
    p.add_argument("--target", type=float, default=0.0, dest="target_norm")
    p.add_argument("--save_interval", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--load_dir")
    p.add_argument("--n_chips", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "plain versions of the kernels)")


def _add_common(p, mat_nonz=True, walkers=False):
    """The flags every molecular workload shares; ``walkers`` (FCIQMC):
    ``--epsilon`` defaults to 1e-3 and there is no ``--vec_nonz``."""
    p.add_argument("--fcidump_path")
    p.add_argument("--hf_path")
    p.add_argument("--point_group", default="C1")
    _add_run(p)
    if walkers:
        p.add_argument("--epsilon", type=float, default=1e-3)
    else:
        p.add_argument("--epsilon", type=float, required=True)
        p.add_argument("--vec_nonz", type=int, required=True)
    if mat_nonz:
        p.add_argument("--mat_nonz", type=int, required=True)
        p.add_argument("--ham_shift", type=float)


def _parser():
    parser = argparse.ArgumentParser(prog="fries_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("frifull_mol", help="exact H*v FRI power method")
    _add_common(p, mat_nonz=False)
    p = sub.add_parser("frisys_mol", help="systematic HB-PP FCI-FRI")
    _add_common(p)
    p.add_argument("--distribution", default="HB", choices=["HB", "HB_unnorm"])
    p.add_argument("--det_space")
    p.add_argument("--trial_vec")
    p.add_argument("--ini_vec")
    p = sub.add_parser("frimulti_mol", help="multinomial-compression FRI")
    _add_common(p)
    p.add_argument("--distribution", default="NU", choices=["NU", "HB"])
    p.add_argument("--trial_vec")
    p.add_argument("--ini_vec")
    for name, dist, help_ in (("fciqmc_mol", "NU", "integer-walker initiator FCIQMC"),
                              ("fciqmc_fp_mol", "HB", "floating-point FCIQMC")):
        p = sub.add_parser(name, help=help_)
        _add_common(p, mat_nonz=False, walkers=True)
        p.add_argument("--distribution", default=dist, choices=["NU", "HB"])
        p.add_argument("--attempt_cap", type=int, default=0)
    for name, help_ in (("frifull_hh", "exact H*v FRI, Hubbard-Holstein"),
                        ("frisys_hh", "factorized FRI, Hubbard-Holstein")):
        p = sub.add_parser(name, help=help_)
        _add_run(p)
        p.add_argument("--params_path", required=True)
        p.add_argument("--vec_nonz", type=int, required=True)
        if name == "frisys_hh":
            p.add_argument("--mat_nonz", type=int, required=True)
        p.add_argument("--ph_bits", type=int, default=3)
    for name, help_ in (("subsp_mol", "multi-state subspace iteration"),
                        ("subsp_mol_lowmem", "subspace iteration with <trial|H|v> "
                                             "enumerated every step"),
                        ("subspfull_mol", "subspace iteration with exact H application")):
        p = sub.add_parser(name, help=help_)
        _add_common(p)
        p.add_argument("--trial_vecs", required=True)
        p.add_argument("--num_trial", "--n_trial", type=int, required=True, dest="n_trial")
        p.add_argument("--restart_int", type=int, default=10)
        p.add_argument("--time_reversal", type=int, default=0, choices=[-1, 0, 1])
        p.add_argument("--out_format", default="txt", choices=["none", "txt", "npy", "bin"])
    for name, help_ in (("observables_mol", "Rayleigh observable estimator"),
                        ("obs_repl_mol", "replica observable estimator")):
        p = sub.add_parser(name, help=help_)
        _add_common(p, mat_nonz=False)
        p.add_argument("--obs_des", type=int, required=True)
        p.add_argument("--obs_cre", type=int, required=True)
        if name == "observables_mol":
            p.add_argument("--exponent", type=float, default=0.5)
            p.add_argument("--burn_in", type=int, default=1000)
            p.add_argument("--n_obs", type=int, default=100)
            p.add_argument("--btw_obs", type=int, default=100)
    p = sub.add_parser("dice_dots", help="dot products between Dice vectors")
    p.add_argument("--vecs1", required=True)
    p.add_argument("--vecs2", required=True)
    p.add_argument("--n_orb", type=int, required=True)
    p.add_argument("--n_states1", type=int, required=True)
    p.add_argument("--n_states2", type=int, required=True)
    return parser


RANK_TIMEOUT = 1800.0
"""The process-group timeout of a sharded run, in seconds: how long a rank
waits at a collective for the others, long enough for rank 0 to write a
checkpoint of many GB while the other ranks wait at the next step."""


def _check_run(args, molecular=True):
    """Stop on what the port does not run: several chips outside
    frisys_mol, or a molecular workload without an integral input."""
    if args.n_chips > 1 and args.cmd != "frisys_mol":
        raise NotImplementedError(f"--n_chips > 1 runs frisys_mol only, not {args.cmd}")
    if molecular and not (args.fcidump_path or args.hf_path):
        raise SystemExit(f"{args.cmd} needs --fcidump_path or --hf_path")


def _device(args):
    import torch

    device = torch.device(args.device)
    if getattr(args, "shards", None) is not None:
        return args.shards.device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def _load(args):
    """(device, Hamiltonian, e_ref override or None) of a molecular run: the
    FCIDUMP, or the HF input directory (core energy 0)."""
    from fries_tpu_torch import io

    _check_run(args)
    device = _device(args)
    if args.fcidump_path:
        ham, core_en = io.parse_fcidump(args.fcidump_path, args.point_group, device=device)
    else:
        ham, core_en = io.parse_hf_input(args.hf_path, device=device)[0], 0.0
    ham_shift = getattr(args, "ham_shift", None)
    e_ref = None if ham_shift is None else ham_shift - core_en
    return device, ham, e_ref


def _write_params(args):
    os.makedirs(args.result_dir, exist_ok=True)
    with open(os.path.join(args.result_dir, "params.txt"), "w") as f:
        for k, v in sorted(vars(args).items()):
            if k != "shards":
                f.write(f"{k}: {v}\n")


def _lead(args):
    """True on the process that writes the outputs (rank 0 of a sharded run)."""
    shards = getattr(args, "shards", None)
    return shards is None or shards.rank == 0


def _resume(args, state):
    """The state of ``--load_dir``'s checkpoint.npz, or ``state``."""
    from fries_tpu_torch.runtime import checkpoint

    if not args.load_dir:
        return state
    path = os.path.join(args.load_dir, "checkpoint.npz")
    try:
        state = checkpoint.restore(path, state, getattr(args, "shards", None))
    except ValueError as err:
        raise SystemExit(f"--load_dir: {err}") from None
    if _lead(args):
        print(f"resumed from {path} at iteration {state.iterat}")
    return state


def _checkpoint(args, state, done):
    """checkpoint.npz every --save_interval iterations and at the end."""
    from fries_tpu_torch.runtime import checkpoint

    if done % args.save_interval == 0 or done >= args.max_iter:
        checkpoint.save_state(os.path.join(args.result_dir, "checkpoint.npz"), state,
                              getattr(args, "shards", None))
        return True
    return False


def _snapshot(state):
    """``state`` as it stands before a block, for checkpoint_overflow.npz:
    the block draws from the same generator object, so its stream is
    copied."""
    import dataclasses

    import torch

    if getattr(state, "generator", None) is None:
        return state
    gen = torch.Generator(device="cpu")
    gen.set_state(state.generator.get_state())
    return dataclasses.replace(state, generator=gen)


def _overflow_exit(args, done, n, prev_state):
    """Save the state before the block to checkpoint_overflow.npz and stop."""
    from fries_tpu_torch.runtime import checkpoint

    checkpoint.save_state(os.path.join(args.result_dir, "checkpoint_overflow.npz"),
                          prev_state, getattr(args, "shards", None))
    raise SystemExit(
        "ERROR: spawn/arena buffer overflow in the block ending at "
        f"iteration {done + n}; results from this block are invalid. "
        "Re-run with larger --max_dets (or mat_nonz spawn capacity); "
        "last good state saved to checkpoint_overflow.npz")


def _run_power_driver(args, run_steps, state, aux, protected=None):
    """The iteration loop of the single-vector drivers: run in blocks,
    stream the metrics to the reference's output files (a stream the driver
    does not report is left empty) and checkpoint."""
    import torch

    from fries_tpu_torch.runtime import arena as ar

    lead = _lead(args)
    shards = getattr(args, "shards", None)
    if lead:
        _write_params(args)
    state = _resume(args, state)
    est = (aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
           aux["ref_key"])
    files = ({k: open(os.path.join(args.result_dir, v), "a") for k, v in _STREAMS.items()}
             if lead else {})
    kw = {} if protected is None else {"protected_keys": protected}
    try:
        block = min(args.save_interval, 100)
        done = 0
        while done < args.max_iter:
            n = min(block, args.max_iter - done)
            prev_state = _snapshot(state)
            state, traj = run_steps(state, *est, n, **kw)
            traj = {k: v.cpu().numpy() for k, v in traj.items()}
            if traj["overflow"].any():
                _overflow_exit(args, done, n, prev_state)
            for name, f in files.items():
                if name not in traj:   # a driver reports a subset of the streams
                    continue
                for x in traj[name]:
                    f.write(repr(x.item()) + "\n")
                f.flush()
            done += n
            if lead:
                print(f"{done}, en est: {traj['proj_num'][-1] / traj['proj_den'][-1]:.8f}, "
                      f"shift: {traj['shift'][-1]:.6f}, norm: {traj['norm'][-1]:.2f}")
            if _checkpoint(args, state, done):
                occ = ar.occupancy_stats(state.arena)
                if shards is not None:   # the whole world's rows
                    names = ("used", "capacity", "live", "nonzero", "zero_live")
                    tot = shards.sum(torch.tensor([int(occ[k]) for k in names]))
                    occ = dict(zip(names, tot.tolist()))
                    occ["fill"] = occ["used"] / occ["capacity"]
                if not lead:
                    continue
                with open(os.path.join(args.result_dir, "arena_occ.txt"), "a") as f:
                    f.write(f"{done},{occ['used']},{occ['capacity']},"
                            f"{occ['fill']:.4f},{occ['live']},{occ['nonzero']},"
                            f"{occ['zero_live']}\n")
    finally:
        for f in files.values():
            f.close()


def run_frifull(args):
    from fries_tpu_torch.drivers import frifull, power

    _, ham, _ = _load(args)
    cfg = power.PowerConfig(
        eps=args.epsilon, target_nonz=args.vec_nonz, capacity=args.max_dets,
        init_thresh=args.init_thresh, target_norm=args.target_norm)
    _, run_steps, state, aux = frifull.build(ham, cfg, seed=args.seed)
    _run_power_driver(args, run_steps, state, aux)


def _frisys_rank(shards, args):
    """One rank of a sharded frisys_mol run; returns the SystemExit message
    that stopped it, if any."""
    args.shards = shards
    try:
        run_frisys(args)
    except SystemExit as err:
        return str(err)
    return None


def run_frisys(args, join_timeout: float = float("inf")):
    """``frisys_mol``; with ``--n_chips`` N > 1, N ranks that are killed
    once the run has taken ``join_timeout`` seconds (none by default)."""
    from fries_tpu_torch import io
    from fries_tpu_torch.drivers import frisys

    shards = getattr(args, "shards", None)
    if args.n_chips > 1 and shards is None:
        from fries_tpu_torch import parallel

        device = _device(args)
        backend = "nccl" if device.type == "cuda" else "gloo"
        stops = parallel.launch(_frisys_rank, args.n_chips, backend, device, args=(args,),
                                timeout=RANK_TIMEOUT, join_timeout=join_timeout)
        if stops[0]:
            raise SystemExit(stops[0])
        return
    _, ham, e_ref = _load(args)
    determ_keys = io.read_dets(args.det_space, ham.n_bits) if args.det_space else None
    trial = io.load_vec_txt(args.trial_vec, ham.n_bits) if args.trial_vec else None
    init_vec = io.load_vec_txt(args.ini_vec, ham.n_bits) if args.ini_vec else None
    cfg = frisys.FrisysConfig(
        eps=args.epsilon, vec_nonz=args.vec_nonz, matr_samp=args.mat_nonz,
        capacity=args.max_dets, spawn_cap=int(args.mat_nonz * 1.4),
        init_thresh=args.init_thresh, target_norm=args.target_norm,
        unnorm=args.distribution == "HB_unnorm", n_shards=args.n_chips)
    _, run_steps, state, aux = frisys.build(
        ham, cfg, seed=args.seed, determ_keys=determ_keys, trial=trial,
        init_vec=init_vec, e_ref=e_ref, shards=shards)
    _run_power_driver(args, run_steps, state, aux, protected=aux["protected_keys"])


def run_frimulti(args):
    from fries_tpu_torch import io
    from fries_tpu_torch.drivers import frimulti

    _, ham, e_ref = _load(args)
    trial = io.load_vec_txt(args.trial_vec, ham.n_bits) if args.trial_vec else None
    init_vec = io.load_vec_txt(args.ini_vec, ham.n_bits) if args.ini_vec else None
    cfg = frimulti.FrimultiConfig(
        eps=args.epsilon, vec_nonz=args.vec_nonz, matr_samp=args.mat_nonz,
        capacity=args.max_dets, spawn_cap=int(args.mat_nonz * 1.4),
        init_thresh=args.init_thresh, target_norm=args.target_norm,
        distribution=args.distribution)
    _, run_steps, state, aux = frimulti.build(ham, cfg, seed=args.seed, trial=trial,
                                              init_vec=init_vec, e_ref=e_ref)
    _run_power_driver(args, run_steps, state, aux)


def run_fciqmc(args):
    from fries_tpu_torch.drivers import fciqmc

    _, ham, _ = _load(args)
    cfg = fciqmc.FciqmcConfig(
        eps=args.epsilon, target_walkers=args.target_norm, capacity=args.max_dets,
        attempt_cap=args.attempt_cap or 4 * int(args.target_norm or 100000),
        init_thresh=args.init_thresh, distribution=args.distribution,
        integer_walkers=args.cmd == "fciqmc_mol")
    _, run_steps, state, aux = fciqmc.build(ham, cfg, seed=args.seed)
    _run_power_driver(args, run_steps, state, aux)


def run_hh(args):
    from fries_tpu_torch import io
    from fries_tpu_torch.drivers import frifull_hh, frisys_hh, power
    from fries_tpu_torch.ops import hubbard

    _check_run(args, molecular=False)
    device = _device(args)
    params = io.parse_hh_input(args.params_path)
    ham = hubbard.HubbardHolstein(
        n_sites=params["lat_len"], n_elec=params["n_elec"],
        ph_bits=args.ph_bits if params["g"] else 0,
        u=params["u"], omega=params["omega"], g=params["g"])
    e_ref, eps = params["gs_energy"], params["eps"]
    if args.cmd == "frifull_hh":
        cfg = power.PowerConfig(eps=eps, target_nonz=args.vec_nonz, capacity=args.max_dets,
                                init_thresh=args.init_thresh, target_norm=args.target_norm)
        _, run_steps, state, aux = frifull_hh.build(ham, e_ref, cfg, seed=args.seed,
                                                    device=device)
    else:
        cfg = frisys_hh.FrisysHHConfig(
            eps=eps, vec_nonz=args.vec_nonz, matr_samp=args.mat_nonz,
            capacity=args.max_dets, spawn_cap=int(args.mat_nonz * 1.4),
            init_thresh=args.init_thresh, target_norm=args.target_norm)
        _, run_steps, state, aux = frisys_hh.build(ham, e_ref, cfg, seed=args.seed,
                                                   device=device)
    _run_power_driver(args, run_steps, state, aux)


def _csv(row, fmt=lambda x: repr(float(x))):
    """One comma-separated line, as the reference's streams write it."""
    return ",".join(map(fmt, row)) + "\n"


def _trial_vectors(args, ham):
    """(T, Nt, W) sentinel-padded trial keys and (T, Nt) values from the
    ``--trial_vecs`` files."""
    from fries_tpu_torch import io
    from fries_tpu_torch.drivers import subspace

    rows = []
    for j in range(args.n_trial):
        if args.trial_vecs.endswith(".dice"):
            rows.append(io.load_vec_dice(args.trial_vecs, ham.n_orb, ham.n_bits, state=j))
            continue
        prefix = f"{args.trial_vecs}{j:02d}"
        if not os.path.exists(prefix + "dets") and os.path.exists(f"{args.trial_vecs}{j}_dets"):
            prefix = f"{args.trial_vecs}{j}_"   # the older <prefix>J_ naming
        rows.append(io.load_vec_txt(prefix, ham.n_bits))
    return subspace.pad_rows(rows, ham.n_words)


def run_subspace(args):
    from fries_tpu_torch import io
    from fries_tpu_torch.drivers import subspace

    _, ham, e_ref = _load(args)
    trial_keys, trial_vals = _trial_vectors(args, ham)
    cfg = subspace.SubspaceConfig(
        eps=args.epsilon, n_trial=args.n_trial, vec_nonz=args.vec_nonz,
        matr_samp=args.mat_nonz, capacity=args.max_dets,
        spawn_cap=int(args.mat_nonz * 1.4), restart_int=args.restart_int,
        init_thresh=args.init_thresh, spin_parity=args.time_reversal,
        lowmem=args.cmd == "subsp_mol_lowmem", exact_h=args.cmd == "subspfull_mol")
    _, run_steps, state, _ = subspace.build(ham, cfg, trial_keys, trial_vals,
                                            seed=args.seed, e_ref=e_ref)

    _write_params(args)
    state = _resume(args, state)
    out = lambda name, mode="a": open(os.path.join(args.result_dir, name), mode)
    fmt = args.out_format
    hfile = dfile = None
    if fmt == "txt":
        hfile, dfile = out("h_mat.txt"), out("d_mat.txt")
    elif fmt == "bin":   # raw little-endian f64 records
        hfile, dfile = out("h_mat.dat", "ab"), out("d_mat.dat", "ab")
    shift_f, norm_f, nini_f = out("shifts.txt"), out("norms.txt"), out("n_ini.txt")
    try:
        done = 0
        block = min(args.save_interval, 100)
        while done < args.max_iter:
            n = min(block, args.max_iter - done)
            prev_state = _snapshot(state)
            state, traj = run_steps(state, n)
            traj = {k: v.cpu().numpy() for k, v in traj.items()}
            if traj["overflow"].any():
                _overflow_exit(args, done, n, prev_state)
            for i in range(n):
                h, d = traj["h_mat"][i], traj["d_mat"][i]
                if fmt == "txt":
                    hfile.write(_csv(h.ravel()))
                    dfile.write(_csv(d.ravel()))
                elif fmt == "bin":
                    hfile.write(np.ascontiguousarray(h, np.float64).tobytes())
                    dfile.write(np.ascontiguousarray(d, np.float64).tobytes())
                elif fmt == "npy":
                    io.npy_append(os.path.join(args.result_dir, "h_mat.npy"), h)
                    io.npy_append(os.path.join(args.result_dir, "d_mat.npy"), d)
                # the controller's absolute iteration (after a resume too)
                if (prev_state.iterat + i + 1) % cfg.shift_interval == 0:
                    shift_f.write(_csv(traj["norm_factors"][i]))
                norm_f.write(_csv(traj["norms"][i]))
                nini_f.write(_csv(traj["n_ini"][i], lambda x: str(int(x))))
            for f in (hfile, dfile, shift_f, norm_f, nini_f):
                if f is not None:
                    f.flush()
            done += n
            print(f"subspace iteration {done}")
            _checkpoint(args, state, done)
    finally:
        for f in (hfile, dfile, shift_f, norm_f, nini_f):
            if f is not None:
                f.close()


def run_observables(args):
    from fries_tpu_torch.drivers import observables

    _, ham, _ = _load(args)
    cfg = observables.ObservablesConfig(
        eps=args.epsilon, target_nonz=args.vec_nonz, capacity=args.max_dets,
        obs_des=args.obs_des, obs_cre=args.obs_cre,
        exponent=getattr(args, "exponent", 0.5), burn_in=getattr(args, "burn_in", 1000),
        n_obs=getattr(args, "n_obs", 100), btw_obs=getattr(args, "btw_obs", 100),
        replica=args.cmd == "obs_repl_mol")
    _, run_steps, state, _ = observables.build(ham, cfg, seed=args.seed)
    _write_params(args)
    state = _resume(args, state)
    numf = open(os.path.join(args.result_dir, "obs_num.txt"), "a")
    denf = open(os.path.join(args.result_dir, "obs_den.txt"), "a")
    try:
        done = 0
        block = min(args.save_interval, 200)
        while done < args.max_iter:
            n = min(block, args.max_iter - done)
            prev_state = _snapshot(state)
            state, traj = run_steps(state, n)
            traj = {k: v.cpu().numpy() for k, v in traj.items()}
            if traj["overflow"].any():
                _overflow_exit(args, done, n, prev_state)
            keep = np.ones(n, bool) if cfg.replica else traj["in_obs"]
            for f, name in ((numf, "obs_num"), (denf, "obs_den")):
                for x in traj[name][keep]:
                    f.write(repr(x.item()) + "\n")
                f.flush()
            done += n
            print(f"observables iteration {done}")
            _checkpoint(args, state, done)
    finally:
        numf.close()
        denf.close()


def run_dice_dots(args):
    """The (n_states1, n_states2) overlaps of two sets of Dice vectors."""
    from fries_tpu_torch import io

    n_bits = 2 * args.n_orb
    vecs1 = [io.load_vec_dice(args.vecs1, args.n_orb, n_bits, state=i)
             for i in range(args.n_states1)]
    vecs2 = [io.load_vec_dice(args.vecs2, args.n_orb, n_bits, state=j)
             for j in range(args.n_states2)]
    mats = np.zeros((args.n_states1, args.n_states2))
    for i, (k1, v1) in enumerate(vecs1):
        d1 = {tuple(k): v for k, v in zip(k1, v1)}
        for j, (k2, v2) in enumerate(vecs2):
            mats[i, j] = sum(d1.get(tuple(k), 0.0) * v for k, v in zip(k2, v2))
    print(mats)
    np.savetxt("dice_dots.txt", mats, delimiter=",")


def main(argv=None):
    args = _parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    return {"frifull_mol": run_frifull, "frisys_mol": run_frisys,
            "frimulti_mol": run_frimulti, "fciqmc_mol": run_fciqmc,
            "fciqmc_fp_mol": run_fciqmc, "subsp_mol": run_subspace,
            "subsp_mol_lowmem": run_subspace, "subspfull_mol": run_subspace,
            "frifull_hh": run_hh, "frisys_hh": run_hh,
            "observables_mol": run_observables, "obs_repl_mol": run_observables,
            "dice_dots": run_dice_dots}[args.cmd](args)


if __name__ == "__main__":
    main()
