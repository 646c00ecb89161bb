"""The flagship science run: a real molecule built from geometry, its CISD
trial, semistochastic HB-PP frisys under deadbeat + tracking shift control,
and trajectory statistics behind an honesty gate, compared with the
published row.

Counterpart of ``tools/flagship.py`` with the gate of
``tools/package_n2_result.py`` folded in.  Systems (``SYSTEMS``):

  ne   Ne aug-cc-pVDZ, 1s frozen (published rows: 100k plain, 150k with
       the 50 largest CISD determinants as the deterministic space)
  n2   N2 cc-pVDZ at r = 2.068 a0, 4 frozen (1M)
  h2o  H2O cc-pVDZ, all electrons (1M)

Protocol, as the reference's commands: --target == vec_nonz == mat_nonz,
CISD trial and initial vector, the initial one-norm at --init_frac of the
target.  Each block of --block iterations runs in scans of --scan steps,
appends the five streams (projnum, projden, S, norm, nkept) to
``result_dir`` and prints a progress line; the run stops with a non-zero
exit on an arena overflow, and after the block that passes --max_hours.
``checkpoint.npz`` is written every --save_interval iterations and at the
end; --load_dir DIR resumes from DIR/checkpoint.npz, keeps DIR's streams up
to its iteration and appends (a resumed run equals the straight one).  At
the end ``result.json`` holds the statistics: the error +- 2 sigma only
when the post-burn-in trajectory holds at least 20 independent samples
(N_post / IAT), else the transient's diagnosis.

    python -m fries_tpu_torch.flagship --system ne --budget 150000 \\
        --determ 50 --initiator 1.0 --iters 12000 --burn 4000

``--device`` defaults to ``cuda`` and stops where there is no card; pass
``--device cpu`` to run on the CPU.  :func:`run` takes any Hamiltonian, so
a small system runs through it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from fries_tpu_torch import cisd, cli, real_systems, stats
from fries_tpu_torch.drivers import frisys
from fries_tpu_torch.runtime import checkpoint

# exact correlation energies (BASELINE.md:10-11, from the reference's
# calc_stats.py:7-10); published rows as (mean, 2 sigma) in mEh by
# (budget, deterministic space size)
SYSTEMS = {
    "ne": {
        "exact_corr": -0.213127,
        "budget": 100_000,
        "capacity": 1 << 18,
        "published": "Results.tex:21-25: 0.0223 +/- 0.0070 mEh, eff 85802",
        "real_system": "ne_augccpvdz",
        "rows": {(100_000, 0): (0.0223, 0.0070, "BASELINE.md:18"),
                 (150_000, 50): (0.0113, 0.0048, "BASELINE.md:34")},
    },
    "n2": {
        "exact_corr": -0.321981,
        "budget": 1_000_000,
        "capacity": 1 << 21,
        "published": "Results.tex:64: 0.0275 +/- 0.0208 mEh, eff 9592",
        "real_system": "n2_ccpvdz",
        "rows": {(1_000_000, 0): (0.0275, 0.0208, "BASELINE.md:24")},
    },
    "h2o": {
        "exact_corr": -0.217834,
        "budget": 1_000_000,
        "capacity": 1 << 21,
        "published": "Results.tex:46: 0.0171 +/- 0.0067 mEh, eff 92963",
        "real_system": "h2o_ccpvdz",
        "rows": {(1_000_000, 0): (0.0171, 0.0067, "BASELINE.md:21")},
    },
}

# the JAX package's own Ne anchor (PARITY.md:206-216), in mEh
JAX_ANCHORS = {("ne", 150_000, 50): (0.0098, 0.0033, "PARITY.md:206-216")}

MIN_INDEPENDENT = 20.0
STREAMS = ("projnum", "projden", "S", "norm", "nkept")
_TRAJ = {"projnum": "proj_num", "projden": "proj_den", "S": "shift", "norm": "norm",
         "nkept": "n_dets"}
SPAWN_SLACK = 32_768


def build_system(name: str, device="cuda"):
    """(ham, trial words (N, W) int64, trial coefficients (N,), CISD
    correlation energy, info) of a flagship system, built on ``device``;
    info holds the build's and the CISD's seconds and E_HF."""
    t0 = time.perf_counter()
    ham, info = real_systems.build(SYSTEMS[name]["real_system"], device)
    _sync(ham.device)
    t1 = time.perf_counter()
    e_cisd, words, vec = cisd.cisd_ground_state(ham)
    _sync(ham.device)
    t2 = time.perf_counter()
    words, vec = words.cpu().numpy().astype(np.int64), vec.cpu().numpy()
    return ham, words, vec, float(e_cisd), {
        "build_s": t1 - t0, "cisd_s": t2 - t1, "e_hf_total": float(info["e_hf_total"]),
        "n_cisd": len(vec)}


def prepare(trial_words, trial_vals, args, meta):
    """(FrisysConfig, trial, initial vector, deterministic space or None) of
    a run: the trial cut to its ``--trial_k`` largest coefficients, the
    ``--determ`` largest of them as the deterministic space
    (:func:`fries_tpu_torch.cisd.largest`: a stable choice where the
    reference's argsort is not), the initial vector the trial scaled to a
    one-norm of ``--init_frac`` of the target (the raw trial at 0)."""
    budget = args.budget or meta["budget"]
    words = np.asarray(trial_words).astype(np.int64)
    vals = np.asarray(trial_vals, np.float64)
    if args.trial_k and args.trial_k < len(vals):
        words, vals = cisd.largest(words, vals, args.trial_k)
    cfg = frisys.FrisysConfig(
        eps=args.eps, vec_nonz=budget, matr_samp=budget,
        capacity=args.capacity or meta["capacity"], spawn_cap=budget + SPAWN_SLACK,
        target_norm=float(budget), init_thresh=args.initiator,
        shift_damping=args.damp, shift_tracking=args.track)
    determ = cisd.largest(words, vals, args.determ)[0] if args.determ else None
    scale = args.init_frac * budget / np.abs(vals).sum() if args.init_frac > 0 else 1.0
    return cfg, (words, vals), (words, vals * scale), determ


def summarize(num, den, meta, burn, published=None, anchor=None):
    """The statistics of a run's projnum / projden streams after
    ``min(burn, 2/3 of the run)`` iterations, behind the gate: with at
    least 20 independent samples the error and its 2 sigma (mEh) against
    ``meta["exact_corr"]``, and where ``published`` / ``anchor`` (mean, 2
    sigma in mEh) is given whether the error agrees with it within the
    two 2-sigma bars added in quadrature; with fewer, the transient's
    diagnosis and the unconverged point estimate."""
    num = np.asarray(num, np.float64)
    burn = min(int(burn), len(num) * 2 // 3)
    out = stats.trajectory_stats(num, den, exact_corr=meta["exact_corr"], burn_in=burn)
    n_post = len(num) - burn
    n_indep = n_post / max(out["iat"], 1.0)
    res = {"burn_in": burn, "e_corr": out["e_corr"], "iat": out["iat"],
           "efficiency": out["efficiency"], "n_independent_samples": round(float(n_indep), 1)}
    if n_indep >= MIN_INDEPENDENT:
        res["error_mEh"] = out["error_mEh"]
        res["two_sigma_mEh"] = out["two_sigma_mEh"]
        for name, row in (("published", published), ("jax_anchor", anchor)):
            if row is not None:
                comb = np.hypot(out["two_sigma_mEh"], row[1])
                res[f"consistent_with_{name}"] = bool(abs(out["error_mEh"] - row[0]) <= comb)
        res["within_0p1_mEh"] = bool(abs(out["error_mEh"]) <= 0.1)
    else:
        res["diagnosis"] = (
            f"TRANSIENT NOT BURNED IN: {n_post} post-burn iterations at IAT "
            f"{out['iat']:.0f} = {n_indep:.1f} independent samples (< 20); the stationary "
            f"error bar is not quotable. Unconverged point estimate: "
            f"{out['error_mEh']:+.3f} mEh (would-be 2sigma {out['two_sigma_mEh']:.3f})")
        res["unconverged_estimate_mEh"] = out["error_mEh"]
    return res


def card():
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _open_streams(args, iterat):
    """The stream files of ``args.result_dir`` opened for appending, with
    their earlier lines: none for a fresh run; on a resume the first
    ``iterat`` lines of ``args.load_dir``'s streams, rewritten first."""
    kept = {name: [] for name in STREAMS}
    if args.load_dir:
        for name in STREAMS:
            with open(os.path.join(args.load_dir, f"{name}.txt")) as f:
                lines = f.read().splitlines()[:iterat]
            if len(lines) < iterat:
                raise SystemExit(f"--load_dir: {name}.txt holds {len(lines)} lines, the "
                                 f"checkpoint {iterat} iterations")
            kept[name] = lines
    files = {}
    for name in STREAMS:
        files[name] = open(os.path.join(args.result_dir, f"{name}.txt"), "w")
        files[name].write("".join(line + "\n" for line in kept[name]))
    return files, {name: [float(x) for x in lines] for name, lines in kept.items()}


def run(ham, trial, args, meta, e_cisd=None, log=print):
    """One flagship run of ``args`` (:func:`parser`'s flags) on ``ham``
    (on its device) from ``trial`` = (words, coefficients), against
    ``meta`` (a :data:`SYSTEMS` entry, or one of its own for another
    system: ``exact_corr``, ``budget``, ``capacity``, ``published``,
    ``rows``).  Writes the streams, ``checkpoint.npz``, ``num.npy`` /
    ``den.npy`` and ``result.json`` to ``args.result_dir`` and returns the
    result.  Raises SystemExit on an arena overflow."""
    dev = ham.device
    cfg, trial, init_vec, determ = prepare(*trial, args, meta)
    budget = cfg.vec_nonz
    key = (budget, args.determ)
    published = meta.get("rows", {}).get(key)
    anchor = JAX_ANCHORS.get((args.system, *key))
    os.makedirs(args.result_dir, exist_ok=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"# trial: {len(trial[1])} CISD dets; deterministic space "
        f"{0 if determ is None else len(determ)}")
    t0 = time.perf_counter()
    _, run_steps, state, aux = frisys.build(ham, cfg, seed=args.seed, trial=trial,
                                            init_vec=init_vec, determ_keys=determ)
    _sync(dev)
    build_s = time.perf_counter() - t0
    log(f"# build done ({build_s:.2f}s); e_ref = {aux['e_ref']:.10f}; H|trial> = "
        f"{len(aux['num_vals'])} rows; dense block {aux['n_elements']} elements")
    if args.load_dir:
        path = os.path.join(args.load_dir, "checkpoint.npz")
        try:
            state = checkpoint.restore(path, state)
        except ValueError as err:
            raise SystemExit(f"--load_dir: {err}") from None
        log(f"# resumed from {path} at iteration {state.iterat}")
    ckpt = os.path.join(args.result_dir, "checkpoint.npz")
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    files, seen = _open_streams(args, state.iterat)
    done = state.iterat
    t_run, n_run = time.perf_counter(), 0
    try:
        while done < args.iters:
            n = min(args.scan, args.iters - done, args.block - done % args.block)
            state, traj = run_steps(state, *est, n, protected_keys=aux["protected_keys"])
            traj = {k: v.cpu().numpy().reshape(-1) for k, v in traj.items()}
            for name in STREAMS:
                vals = traj[_TRAJ[name]]
                files[name].write("".join(
                    (f"{int(v)}\n" if name == "nkept" else f"{float(v)!r}\n") for v in vals))
                seen[name].extend(float(v) for v in vals)
            done += n
            n_run += n
            if traj["overflow"].any():
                raise SystemExit(f"arena overflow in the iterations {done - n + 1}-{done}")
            if done % args.save_interval == 0 or done == args.iters:
                checkpoint.save_state(ckpt, state)
            if done % args.block and done < args.iters:
                continue
            for f in files.values():
                f.flush()
            el = time.perf_counter() - t_run
            window = 20 * args.scan
            wnum = np.asarray(seen["projnum"][-window:])
            wden = np.asarray(seen["projden"][-window:])
            log(f"# blk {-(-done // args.block)}/{-(-args.iters // args.block)} it={done} "
                f"{el:.0f}s {el / n_run * 1e3:.1f} ms/it "
                f"e_win={wnum.mean() / wden.mean():.6f} den_win={wden.mean():.3e} "
                f"S={seen['S'][-1]:.4f} norm={seen['norm'][-1]:.3e} "
                f"dets={int(seen['nkept'][-1])}")
            if el > args.max_hours * 3600 and done < args.iters:
                checkpoint.save_state(ckpt, state)
                log("# wall-clock budget reached")
                break
    finally:
        for f in files.values():
            f.close()
    sec_per_iter = (time.perf_counter() - t_run) / max(n_run, 1)
    num, den = np.asarray(seen["projnum"]), np.asarray(seen["projden"])
    np.save(os.path.join(args.result_dir, "num.npy"), num)
    np.save(os.path.join(args.result_dir, "den.npy"), den)
    norm = np.asarray(seen["norm"])
    result = {
        "system": args.system,
        "config": (f"FCI-FRI HB sys, n_a={args.initiator}, {budget} nonz, eps={args.eps}"
                   + (f", semistoch {args.determ}" if args.determ else "")
                   + f", damp={args.damp}, track={args.track}"),
        "iters": len(num),
        "seed": args.seed,
        "e_ref": float(aux["e_ref"]),
        "e_cisd_corr": e_cisd,
        "exact_corr": meta["exact_corr"],
        **summarize(num, den, meta, args.burn, published, anchor),
        "sec_per_iter": sec_per_iter,
        "iterations_this_process": n_run,
        "build_s": build_s,
        "published_row": (meta["published"] if published is None
                          else f"{published[2]}: {published[0]} +/- {published[1]} mEh"),
        "published_mEh": None if published is None else list(published[:2]),
        "jax_anchor_mEh": None if anchor is None else list(anchor[:2]),
        "target_norm": cfg.target_norm,
        "norm_final": float(norm[-1]),
        "norm_max": float(norm.max()),
        "norm_max_over_target": float(norm.max() / cfg.target_norm),
        "n_dets_final": int(seen["nkept"][-1]),
        "capacity": cfg.capacity,
        "device": str(dev),
        "card": card() if dev.type == "cuda" else None,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }
    if "diagnosis" in result:
        log("# " + result["diagnosis"])
    log(json.dumps(result))
    with open(os.path.join(args.result_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def parser():
    ap = argparse.ArgumentParser(prog="python -m fries_tpu_torch.flagship",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--system", choices=sorted(SYSTEMS), default="ne")
    ap.add_argument("--iters", type=int, default=16000,
                    help="iterations of the whole run, a resumed one included")
    ap.add_argument("--burn", type=int, default=5000)
    ap.add_argument("--eps", type=float, default=0.001)
    ap.add_argument("--budget", type=int, default=0,
                    help="vec_nonz = matr_samp = target (0 = the system's published)")
    ap.add_argument("--capacity", type=int, default=0)
    ap.add_argument("--initiator", type=float, default=0.5)
    ap.add_argument("--init_frac", type=float, default=0.5,
                    help="initial one-norm as a fraction of the target; 0 = the raw "
                         "CISD vector (the reference's free-growth protocol)")
    ap.add_argument("--determ", type=int, default=0,
                    help="semistochastic: the top-k CISD determinants as the "
                         "deterministic space")
    ap.add_argument("--trial_k", type=int, default=0,
                    help="cut the trial vector to its top-k CISD determinants (0 = all)")
    ap.add_argument("--damp", type=float, default=1.0,
                    help="shift damping (1.0 deadbeat; the reference's rate-only "
                         "controller is 0.05 with --track 0)")
    ap.add_argument("--track", type=float, default=0.05,
                    help="target-tracking shift term (0 = rate only)")
    ap.add_argument("--scan", type=int, default=25)
    ap.add_argument("--block", type=int, default=500)
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--result_dir", default="")
    ap.add_argument("--max_hours", type=float, default=100.0)
    ap.add_argument("--save_interval", type=int, default=500)
    ap.add_argument("--load_dir", default="")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = cli._device(args)
    args.result_dir = args.result_dir or os.path.join("results", f"flagship_{args.system}")
    ham, words, vals, e_cisd, info = build_system(args.system, device)
    print(f"# {args.system}: E_HF {info['e_hf_total']:.10f} built in {info['build_s']:.2f}s; "
          f"CISD e_corr {e_cisd:.6f} over {info['n_cisd']} dets in {info['cisd_s']:.2f}s",
          flush=True)
    run(ham, (words, vals), args, SYSTEMS[args.system], e_cisd=e_cisd,
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
