"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the integrals from the seed on the card, builds the program's
step, and runs the cell file's warm-up steps; ``setup_s`` is the time from
the start of this module to the end of the warm-up.  The window then steps
for ``--seconds`` and ends at a ``torch.cuda.synchronize()``: ``step_ms`` is
the window over the steps it finished, ``peak_mem_gib`` the allocator's
peak over set-up and window.  With ``--trace 1`` the window is followed by
one step under ``torch.cuda`` sync debug mode (host synchronizations) and
``TRACE_STEPS`` steps under ``torch.profiler``, and the
per-layer metrics are reported instead.  Then the program's state is
freed, and the reference steps the compared steps again
(:mod:`benchmark.check`).

Prints the warm-up's reach and the window's counts on a line of their own,
the compared numbers beside their limits as the last lines of standard
error, and the result as the last line of standard output.  Exits non-zero
without a result where the card is missing, or where JAX or the JAX
package is loaded at the end.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import catalog, check, data, spans  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fries_tpu")
GIB = 2 ** 30
TRACE_STEPS = 3   # profiled steps of a traced run: a small trace


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``fries_tpu_torch`` is not ``fries_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _host(metrics: dict) -> dict:
    return {k: (v.item() if hasattr(v, "item") else v) for k, v in metrics.items()}


def _failed(metrics: dict) -> bool:
    m = _host(metrics)
    return bool(m.get("overflow")) or not all(
        math.isfinite(float(m[k])) for k in ("proj_num", "proj_den", "norm") if k in m)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read ({err})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def _install_spans(cell, root) -> tuple[spans.Spans, list]:
    """The labels (and byte counters) of the cell's per-layer metrics."""
    sp = spans.Spans()
    readers = []
    for entry in cell.per_layer:
        mod = catalog.metric(entry["name"], root)
        counts = getattr(mod, "COUNTS", {})
        for fn in getattr(mod, "FUNCTIONS", ()):
            sp.install(fn, counts.get(fn))
        readers.append((entry, mod))
    return sp, readers


def _traced(prog, state, cell, sp, readers, build_s, dev):
    """The per-layer metrics, the device's busy and window seconds and the
    breakdown, from one step in sync debug mode and the profiled steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _, _ = prog.advance(state)
        _sync(dev)
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)

    n = TRACE_STEPS
    sp.counting = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            state, _, _ = prog.advance(state)
        _sync(dev)
        window_s = time.perf_counter() - t
    sp.counting = False
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        reading = spans.read_trace(path, n, window_s, set(sp.installed))
    ctx = {"trace": reading, "spans": sp, "syncs_per_step": syncs, "build_s": build_s,
           "steps": n}
    metrics = {}
    for entry, mod in readers:
        value = mod.read(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    sp.remove()
    device = {"busy_s": reading.busy_s, "window_s": reading.window_s}
    breakdown = {"device_ops": reading.device_ops, "idle_gaps": reading.idle_gaps}
    return metrics, device, breakdown


def run(workload: str, seed: int, seconds: float, trace: bool, root: Path = catalog.ROOT,
        device: str = "cuda", log=print) -> dict:
    """One run of ``workload``; returns the result (with ``compared``)."""
    import numpy as np
    import torch

    cell = catalog.cell(workload, root)
    p = cell.params
    solver = catalog.solver(p["solver"], root)
    dev = torch.device(device)
    system = data.make_system(cell.config, dev)
    ref_inputs = data.System(system.hcore.cpu().clone(), system.eris.cpu().clone(),
                             system.symm.cpu().clone(), system.n_orb, system.n_elec)
    sp, readers = _install_spans(cell, root) if trace else (None, [])

    tb = time.perf_counter()
    prog = solver.Program(system, p, seed, dev)
    _sync(dev)
    build_s = time.perf_counter() - tb
    state = prog.state
    start = check.snapshot(state)
    compared = []     # the warm-up's first and last steps, on the host
    m = {}
    n_warm = int(p["warmup_steps"])
    for i in range(n_warm):
        before = state
        state, m, u = prog.advance(state)
        if i in (0, n_warm - 1):
            compared.append((check.snapshot(before), check.snapshot(state), _host(m), u))
    _sync(dev)
    setup_s = time.perf_counter() - T0
    warm = _host(m)

    # the objects of the set-up out of the collector's way: a full collection
    # inside the window then walks only what the window made
    gc.collect()
    gc.freeze()
    pick_rng = np.random.default_rng([seed, 2])
    picked = last = None
    window_metrics = []
    n_steps = 0
    t_start = time.perf_counter()
    while True:
        new, m, u = prog.advance(state)
        window_metrics.append(m)
        last = (state, new, m, u)
        n_steps += 1
        if pick_rng.integers(n_steps) == 0:   # each step kept with chance 1/n: uniform
            picked = last
        state = new
        if time.perf_counter() - t_start >= seconds:
            break
    _sync(dev)
    window = time.perf_counter() - t_start
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = sum(_failed(mm) for mm in window_metrics)
    end = _host(window_metrics[-1])
    log(json.dumps({"workload": workload, "seed": seed, "card": power_limit()
                    if dev.type == "cuda" else "cpu",
                    "warmup": {"steps": n_warm, **warm},
                    "window": {"steps": n_steps, "seconds": window, **end}}, default=float))

    result = {"correct": False, "attempted": n_steps, "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu", "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        metrics, busy, breakdown = _traced(prog, state, cell, sp, readers, build_s, dev)
        result["metrics"] = metrics
        result["device"].update(busy)
        result["breakdown"] = breakdown
    else:
        result["metrics"] = {
            "step_ms": {"value": 1e3 * window / n_steps, "unit": "ms/step"},
            "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}

    # the steps compared, on the host; then the program's state is freed
    held = [picked] if picked is last else [picked, last]
    compared += [(check.snapshot(b), check.snapshot(a), _host(mm), u) for b, a, mm, u in held]
    del prog, state, new, last, picked, held, window_metrics, system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    reference = solver.Reference(ref_inputs.to(dev), p, seed, dev)
    tr = time.perf_counter()
    numbers = check.compare(start, compared, reference)
    log(json.dumps({"check": {"steps": len(compared), "build_s": tr - tc,
                              "steps_s": time.perf_counter() - tr}}))
    limits = p["check"]["limits"]
    result["correct"] = all(numbers[k] <= limits[k] for k in limits)
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    cell = catalog.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 1
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
