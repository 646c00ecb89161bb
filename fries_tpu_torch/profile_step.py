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
one-rank NCCL world, where the exchange shows as its four spans), runs
warm-up steps (frifull, subspfull, frisys_hh and frisys_hh_wide: until the vectors hold
their budgets of nonzeros; fciqmc and fciqmc_real: bench.py's 60; the
observables: the 6 of their burn-in; the others 3), then

* counts the host synchronizations of one step (``torch.cuda`` sync debug
  mode, one warning per synchronizing call) and the program's host reads of
  that step by site (:func:`fries_tpu_torch.profiling.last_step_counts`),
* profiles a few steps with ``torch.profiler`` and prints the device time of
  each of the program's spans (:mod:`fries_tpu_torch.profiling`, the
  ``fries.*`` names: the step, the spawn and its compression stages, the
  seeds, the threshold fixpoints and their reads, the grid layouts, the
  emissions, the finalize, norm_weight, the merges with their spawn sort and
  kernel entry, the keys, the diagonal, the estimator, the vector's
  preservation and compression, the exchange's four phases, the pivotal
  tournaments, and the FCIQMC, subspace, Hubbard-Holstein and observable
  phases), the device time inside each pair of nested spans
  (``"fries.comp_sub_factored & fries.fixpoint"``: the fixpoint rounds of
  the C+D stage), the top kernels, the device's busy time and its idle
  share of the traced span (from the chrome trace, written to
  ``build/fries_tpu_torch/step_trace.json`` by default).

A span's device time is that of the operations launched inside it: the
profiler links each device operation to the runtime call that launched it,
and the spans are host ranges around those calls.  Nested spans count in
each enclosing one.  Usage (needs a CUDA device)::

    python -m fries_tpu_torch.profile_step [--workload frifull] [--steps 3] [--trace out.json]
"""

from __future__ import annotations

import argparse
import bisect
import itertools
import json
import time
import warnings
from pathlib import Path

PREFIX = "fries."                       # the program's span names
HOST_CATS = ("cpu_op", "user_annotation")
ENCLOSING = {"fries.step", "fries.spawn"}   # left out of the pairs


def program_spans(path) -> set:
    """The names of the program's spans (``fries.*`` host ranges) in a
    chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return {e["name"] for e in events if e.get("cat") in HOST_CATS
            and str(e.get("name", "")).startswith(PREFIX)}


def trace_device_activity(path, n_steps, labels):
    """(busy ms per step, idle share of the span, ops per step, top kernels,
    busy ms per step of each labelled phase, busy ms per step inside each
    pair of labelled phases) from a chrome trace: the union of kernel /
    memcpy / memset intervals, and per phase the summed time of the device
    operations that belong to it: those that start inside the phase's ranges
    on the device timeline (``gpu_user_annotation``), and those launched
    (the runtime call of the same correlation id) inside its host ranges
    (the program's spans, ``cpu_op`` events).  Nested phases count in each
    enclosing one; the step and the spawn, which enclose most phases, are
    left out of the pairs."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    gpu = sorted((e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e),
                 key=lambda e: e["ts"])
    if not gpu:
        return 0.0, 1.0, 0.0, {}, {}, {}
    ts = [e["ts"] for e in gpu]
    inside = [set() for _ in gpu]
    launched = {}      # correlation id -> (host time, thread) of the runtime call
    host = []          # the labelled host ranges: (start, end, name, thread)
    for e in events:
        cat, name = e.get("cat"), e.get("name")
        if "dur" not in e:
            continue
        if cat == "gpu_user_annotation" and name in labels:
            lo = bisect.bisect_left(ts, e["ts"])
            hi = bisect.bisect_left(ts, e["ts"] + e["dur"])
            for i in range(lo, hi):
                inside[i].add(name)
        elif cat in HOST_CATS and name in labels:
            host.append((e["ts"], e["ts"] + e["dur"], name, e.get("tid")))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = (e["ts"], e.get("tid"))
    # a sweep over the launches in time order, holding the host ranges open at each
    host.sort()
    order = sorted((launched[c], i) for i, c in enumerate(
        e.get("args", {}).get("correlation") for e in gpu) if c in launched)
    active, nxt = [], 0
    for (t, tid), i in order:
        while nxt < len(host) and host[nxt][0] <= t:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= t]
        inside[i].update(name for _, _, name, h_tid in active if h_tid == tid)
    phase, pairs = {}, {}
    for e, names in zip(gpu, inside):
        dur = e["dur"]
        for name in names:
            phase[name] = phase.get(name, 0.0) + dur
        for pair in itertools.combinations(sorted(names - ENCLOSING), 2):
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
    from fries_tpu_torch import profiling, rung

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
    reads = profiling.last_step_counts()

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
        args.trace, args.steps, program_spans(args.trace))
    report = {
        "device": torch.cuda.get_device_name(0), "workload": args.workload,
        "steps": args.steps,
        "wall_ms_per_step": 1e3 * wall / args.steps,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": idle,
        "device_ops_per_step": n_ops,
        "host_syncs_per_step": syncs,
        "host_reads_per_step": reads,
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
