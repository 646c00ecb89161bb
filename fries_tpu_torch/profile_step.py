"""Where the time of one step goes on the card.

Builds one of the configurations of :mod:`fries_tpu_torch.rung` (the ones
``chip_smoke.py`` times: ``--workload frisys``, the 1e6 rung; ``--workload
semistoch``, the rung with a deterministic space; ``--workload frifull``,
bench.py's exact-H configuration, ``--dedup_cap N`` for its dedup variant;
``--workload subsp``, bench.py's subspace configuration, and its modes
``subsp_lowmem``, ``subsp_multi`` and ``subspfull`` (exact H); ``--workload
fciqmc``, bench.py's 5M-walker FCIQMC configuration; ``--workload
frimulti``; the Hubbard-Holstein ``frifull_hh`` and ``frisys_hh``; the
observable estimators ``observables`` and ``obs_repl``; ``unfused``, the
rung with its five comp_sub rounds; the four-word configurations on real
Ne/cc-pVQZ ``ne_qz``, ``ne_qz_unnorm`` and ``ne_qz_subsp``; the
seven-word ``ne2_qz`` and ``ne2_qz_subsp`` on Ne2/cc-pVQZ and the 80-bit
``frisys_hh_wide``; or the other
real molecules ``rung_real`` (the 1e6 rung on N2/cc-pVDZ),
``semistoch_cisd`` (with the 150-determinant CISD space), ``frifull_real``
(H2O/cc-pVDZ's (10e, 12o)) and ``fciqmc_real`` (stretched N2); the
hash-sharded ``rung_real_sharded`` and ``subsp_sharded``, each in a
one-rank NCCL world, where the exchange shows as four phases: ``exchange:
bucket build``, ``exchange: count all-gather``, ``exchange: host read`` and
``exchange: payload``), runs
warm-up steps (frifull, subspfull, frisys_hh and frisys_hh_wide: until the vectors hold
their budgets of nonzeros; fciqmc and fciqmc_real: bench.py's 60; the
observables: the 6 of their burn-in; the others 3), then

* counts the host synchronizations of one step (``torch.cuda`` sync debug
  mode, one warning per synchronizing call),
* profiles a few steps with ``torch.profiler`` and prints the device time of
  each labelled phase (the spawn and its compression rounds, the emissions,
  C+D's histogram seed, the threshold fixpoints, norm_weight, the merges
  and their spawn sort, the exact spawn, the dedup and the compaction of
  the chunked exact-H step, the diagonal, the vector compressions, the
  pivotal tournaments; for FCIQMC and frimulti the attempt parents, the
  excitation samplers and their categorical rows, the matrix elements, the
  binomial rounding, the spawn compaction, death, the estimator; for the
  Hubbard-Holstein paths ``offdiag_batch`` and frisys_hh's level 1, level
  2 and finalize; for the subspace modes the lowmem h rows and
  ``multi_comp``; for the observables ``one_elec``, the exact spawn and the
  merges), the
  device time inside each pair of nested phases (``"C+D & threshold
  fixpoint"``: the fixpoint rounds of the C+D stage), the top kernels, the
  device's busy time and its idle share of the traced span (from the chrome
  trace, written to ``build/fries_tpu_torch/step_trace.json`` by default).

The phase labels are ``record_function`` wrappers installed by this script
around the package's functions; the package itself carries no
instrumentation.  The profiler ties a device operation to the innermost
range that launched it, and a range's span on the device runs from its own
first operation to its last: a range whose work begins with a nested one
shows without it.  So a merge's wrapper is two rows, ``merge: spawn sort``
(shared by both merges) and ``merge: kernel entry`` (kernel A) or
``merge_multi: kernel entry`` (kernel C), to be summed.  A function the
imported package lacks gets no label, so the script also profiles an older
checkout of the package put first on ``PYTHONPATH`` (its C+D emission is
labelled ``emit_plain``).  Usage (needs a CUDA device)::

    python -m fries_tpu_torch.profile_step [--workload frifull] [--steps 3] [--trace out.json]
"""

from __future__ import annotations

import argparse
import bisect
import functools
import itertools
import json
import time
import warnings
from pathlib import Path


def _labelled(label, fn):
    import torch

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def install_labels():
    """Wrap the phases in profiler ranges (module attributes are looked up at
    call time, so the step picks the wrappers up); returns the labels."""
    from fries_tpu_torch import compress
    from fries_tpu_torch.drivers import fciqmc, frimulti, frisys, frisys_hh, observables, subspace
    from fries_tpu_torch.ops import heat_bath, hubbard, molecule, near_uniform
    from fries_tpu_torch.runtime import arena, emit, merge, merge_multi, shard

    phases = (
        (compress, "comp_sub", "comp_sub (A+B, E)"),
        (compress, "comp_sub_factored", "C+D"),
        (compress, "_factored_seed", "C+D histogram seed"),
        (compress, "_threshold_fixpoint", "threshold fixpoint"),
        (compress, "comp_sub_piv", "comp_sub_piv (A+B, C+D, E)"),
        (compress, "piv_comp", "piv_comp (vector)"),
        (compress, "piv_select_tree", "piv_select_tree (1-D)"),
        (compress, "piv_select_tree_2d", "piv_select_tree_2d"),
        (compress, "find_preserve", "find_preserve"),
        (compress, "sys_comp", "sys_comp"),
        (emit, "emit", "emit, dense rows (A+B, E)"),
        (emit, "emit_factored", "emit_factored (C+D)"),
        (emit, "emit_plain", "emit_plain"),
        (merge, "accumulate", "merge: kernel entry"),
        (merge, "sort_spawns", "merge: spawn sort"),
        (arena, "dedup_spawns", "dedup_spawns"),
        (arena, "compact", "compact"),
        (molecule, "exact_offdiag_batch", "exact spawn"),
        (merge_multi, "accumulate", "merge_multi: kernel entry"),
        (molecule, "diag_matrel_chunked", "diagonal"),
        (heat_bath, "norm_weight", "norm_weight"),
        (near_uniform, "sample_doubles", "sampler: NU doubles"),
        (near_uniform, "sample_doubles_heat_bath", "sampler: HB doubles"),
        (near_uniform, "sample_singles", "sampler: singles"),
        (compress, "sample_categorical_rows", "categorical rows"),
        (molecule, "doub_matr_el", "matrix elements"),
        (molecule, "sing_matr_el", "matrix elements"),
        (compress, "round_binomially", "binomial rounding"),
        (fciqmc, "_attempt_parents", "attempt parents"),
        (fciqmc, "_partition_spawns", "spawn compaction"),
        (fciqmc, "_death", "death"),
        (fciqmc, "_estimate", "estimator"),
        (hubbard, "offdiag_batch", "offdiag_batch"),
        (hubbard, "diag_matrel", "diagonal"),
        (frisys_hh, "level_one", "frisys_hh level 1"),
        (frisys_hh, "level_two", "frisys_hh level 2"),
        (frisys_hh, "finalize", "frisys_hh finalize"),
        (subspace, "lowmem_h_mat", "lowmem h_row"),
        (compress, "multi_comp", "multi_comp"),
        (observables, "apply_one_elec", "one_elec"),
        (shard, "bucket_rows", "exchange: bucket build"),
        (shard, "gather_counts", "exchange: count all-gather"),
        (shard, "read_counts", "exchange: host read"),
        (shard, "payload", "exchange: payload"))
    phases = [(mod, name, label) for mod, name, label in phases if hasattr(mod, name)]
    for mod, name, label in phases:
        setattr(mod, name, _labelled(label, getattr(mod, name)))
    for mod, name in ((frisys, "make_hbpp_spawner"), (fciqmc, "make_spawner"),
                      (frimulti, "make_spawner"), (frisys_hh, "make_spawner")):
        if hasattr(mod, name):
            make = getattr(mod, name)
            setattr(mod, name, lambda *a, make=make, **k: _labelled("spawn (total)",
                                                                   make(*a, **k)))
    return {label for *_, label in phases} | {"spawn (total)"}


def trace_device_activity(path, n_steps, labels):
    """(busy ms per step, idle share of the span, ops per step, top kernels,
    busy ms per step of each labelled phase, busy ms per step inside each
    pair of labelled phases) from a chrome trace: the union of kernel /
    memcpy / memset intervals, and per phase the summed time of the device
    operations that start inside the phase's ranges on the device timeline
    (nested phases count in each enclosing one; the spawn, which encloses
    most phases, is left out of the pairs)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    gpu = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not gpu:
        return 0.0, 1.0, 0.0, {}, {}, {}
    starts = sorted((e["ts"], e["dur"]) for e in gpu)
    ts = [t for t, _ in starts]
    inside = [set() for _ in starts]
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and e.get("name") in labels:
            lo = bisect.bisect_left(ts, e["ts"])
            hi = bisect.bisect_left(ts, e["ts"] + e["dur"])
            for i in range(lo, hi):
                inside[i].add(e["name"])
    phase, pairs = {}, {}
    for (_, dur), names in zip(starts, inside):
        for name in names:
            phase[name] = phase.get(name, 0.0) + dur
        for pair in itertools.combinations(sorted(names - {"spawn (total)"}), 2):
            key = " & ".join(pair)
            pairs[key] = pairs.get(key, 0.0) + dur
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = {}
    for e in gpu:
        total[e["name"][:90]] = total.get(e["name"][:90], 0.0) + e["dur"]
    top = sorted(total.items(), key=lambda kv: -kv[1])[:12]
    per_step = lambda d: {k: v / 1e3 / n_steps for k, v in d}
    return (busy / 1e3 / n_steps, 1.0 - busy / (spans[-1][1] - spans[0][0]),
            len(gpu) / n_steps, per_step(top), per_step(sorted(phase.items())),
            per_step(sorted(pairs.items())))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", choices=[
        "frisys", "semistoch", "frifull", "subsp", "subsp_lowmem", "subsp_multi", "subspfull",
        "fciqmc", "frimulti", "frifull_hh", "frisys_hh", "observables", "obs_repl",
        "unfused", "ne_qz", "ne_qz_unnorm", "ne_qz_subsp", "ne2_qz", "ne2_qz_subsp",
        "frisys_hh_wide", "rung_real", "semistoch_cisd",
        "frifull_real", "fciqmc_real", "rung_real_sharded", "subsp_sharded"],
        default="frisys")
    parser.add_argument("--dedup_cap", type=int, default=0,
                        help="frifull: collapse each chunk's stream to this many rows")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--trace", default=str(
        Path(__file__).resolve().parent.parent / "build" / "fries_tpu_torch" / "step_trace.json"))
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    labels = install_labels()
    from fries_tpu_torch import rung

    dev = torch.device("cuda")
    kw = {}
    if args.workload == "frisys":
        step, state, est, _ = rung.build(dev)
    elif args.workload == "semistoch":
        step, state, est, aux = rung.build_semistoch(dev)
        kw = {"protected_keys": aux["protected_keys"]}
    elif args.workload == "frifull":
        step, state, est, _ = rung.build_frifull(dev, args.dedup_cap)
    elif args.workload == "fciqmc":
        step, state, est, _ = rung.build_fciqmc(dev)
    elif args.workload == "rung_real":
        step, state, est, _ = rung.build_real(dev)
    elif args.workload == "rung_real_sharded":
        from fries_tpu_torch import parallel

        step, state, est, _ = rung.build_real_sharded(parallel.init_world(0, 1, "nccl", dev))
    elif args.workload == "subsp_sharded":
        from fries_tpu_torch import parallel

        step, state, _ = rung.build_subsp_sharded(parallel.init_world(0, 1, "nccl", dev))
        est = ()
    elif args.workload == "semistoch_cisd":
        step, state, est, aux = rung.build_semistoch_cisd(dev)
        kw = {"protected_keys": aux["protected_keys"]}
    elif args.workload == "frifull_real":
        step, state, est, _ = rung.build_frifull_real(dev)
    elif args.workload == "fciqmc_real":
        step, state, est, _ = rung.build_fciqmc_real(dev)
    elif args.workload == "frimulti":
        step, state, est, _ = rung.build_frimulti(dev)
    elif args.workload == "frifull_hh":
        step, state, est, _ = rung.build_frifull_hh(dev)
    elif args.workload == "frisys_hh":
        step, state, est, _ = rung.build_frisys_hh(dev)
    elif args.workload == "frisys_hh_wide":
        step, state, est, _ = rung.build_frisys_hh_wide(dev)
    elif args.workload == "ne2_qz":
        step, state, est, _ = rung.build_ne2_qz(dev)
    elif args.workload == "ne2_qz_subsp":
        step, state, _ = rung.build_ne2_qz_subsp(dev)
        est = ()
    elif args.workload == "unfused":
        step, state, est, _ = rung.build(dev, fuse_ab=False, fuse_cd=False)
    elif args.workload in ("ne_qz", "ne_qz_unnorm"):
        step, state, est, _ = rung.build_ne_qz(dev, unnorm=args.workload == "ne_qz_unnorm")
    elif args.workload == "ne_qz_subsp":
        step, state, _ = rung.build_ne_qz_subsp(dev)
        est = ()
    elif args.workload == "subspfull":
        step, state, _ = rung.build_subspfull(dev)
        est = ()
    elif args.workload in ("observables", "obs_repl"):
        step, state, _ = rung.build_observables(dev, replica=args.workload == "obs_repl")
        est = ()
    else:
        modes = {"subsp": {}, "subsp_lowmem": {"lowmem": True},
                 "subsp_multi": {"compress_mode": "multi"}}[args.workload]
        step, state, _ = rung.build_subspace(dev, **modes)
        est = ()
    budget = {"frifull": rung.frifull_config().target_nonz,
              "frisys_hh": rung.frisys_hh_config().vec_nonz,
              "frisys_hh_wide": rung.frisys_hh_config().vec_nonz}.get(args.workload)
    step_kw = step
    step = lambda state, *est: step_kw(state, *est, **kw)
    for i in range(60):
        state, m = step(state, *est)
        if args.workload in ("fciqmc", "fciqmc_real"):
            continue
        if args.workload in ("observables", "obs_repl"):
            if i >= 5:   # the burn-in: the next step starts a period
                break
            continue
        if args.workload == "subspfull":
            full = bool(((state.arena.vals != 0).sum(1)
                         >= rung.subspfull_config().vec_nonz).all())
        else:
            full = budget is None or int(m["nnonz"]) >= budget
        if i >= 2 and (full or i >= 39):
            break
    torch.cuda.synchronize()

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _ = step(state, *est)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step(state, *est)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(args.trace)
    busy_ms, idle, n_ops, top, phases, pairs = trace_device_activity(
        args.trace, args.steps, labels)
    report = {
        "device": torch.cuda.get_device_name(0), "workload": args.workload,
        "steps": args.steps,
        "wall_ms_per_step": 1e3 * wall / args.steps,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": idle,
        "device_ops_per_step": n_ops,
        "host_syncs_per_step": syncs,
        "phase_busy_ms_per_step": phases,
        "nested_phase_busy_ms_per_step": pairs,
        "top_kernels_ms_per_step": top,
    }
    print(json.dumps(report, indent=1))
    if args.workload.endswith("_sharded"):
        from fries_tpu_torch import parallel

        parallel.close_world()
    return report


if __name__ == "__main__":
    main()
