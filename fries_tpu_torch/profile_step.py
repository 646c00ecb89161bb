"""Where the time of one frisys step goes on the card.

Builds the main path at :mod:`fries_tpu_torch.rung` (the configuration
``chip_smoke.py`` times), runs warm-up steps, then

* counts the host synchronizations of one step (``torch.cuda`` sync debug
  mode, one warning per synchronizing call),
* profiles a few steps with ``torch.profiler`` and prints the device time of
  each labelled phase (the spawn and its compression rounds, norm_weight,
  the merge, the diagonal, find_preserve, sys_comp), the top kernels, the
  device's busy time and its idle share of the traced span (from the chrome
  trace, written to ``build/fries_tpu_torch/step_trace.json`` by default).

The phase labels are ``record_function`` wrappers installed by this script
around the package's functions; the package itself carries no
instrumentation.  Usage (needs a CUDA device)::

    python -m fries_tpu_torch.profile_step [--steps 3] [--trace out.json]
"""

from __future__ import annotations

import argparse
import functools
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
    """Wrap the main path's phases in profiler ranges (module attributes are
    looked up at call time, so the step picks the wrappers up)."""
    from fries_tpu_torch import compress
    from fries_tpu_torch.drivers import frisys
    from fries_tpu_torch.ops import heat_bath, molecule
    from fries_tpu_torch.runtime import emit, merge

    for mod, name, label in (
            (compress, "comp_sub", "comp_sub (A+B, E)"),
            (compress, "comp_sub_factored", "comp_sub_factored (C+D)"),
            (compress, "find_preserve", "find_preserve"),
            (compress, "sys_comp", "sys_comp"),
            (emit, "emit", "emit kernel"),
            (merge, "accumulate", "merge (sort + kernel)"),
            (molecule, "diag_matrel_chunked", "diagonal"),
            (heat_bath, "norm_weight", "norm_weight")):
        setattr(mod, name, _labelled(label, getattr(mod, name)))
    make = frisys.make_hbpp_spawner
    frisys.make_hbpp_spawner = lambda *a, **k: _labelled("spawn (total)", make(*a, **k))


def _device_time(evt):
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def trace_device_activity(path, n_steps):
    """(busy ms per step, idle share of the span, ops per step, top kernels)
    from a chrome trace: the union of kernel / memcpy / memset intervals."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    gpu = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
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
    return (busy / 1e3 / n_steps, 1.0 - busy / (spans[-1][1] - spans[0][0]),
            len(gpu) / n_steps, {k: v / 1e3 / n_steps for k, v in top})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--trace", default=str(
        Path(__file__).resolve().parent.parent / "build" / "fries_tpu_torch" / "step_trace.json"))
    args = parser.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    install_labels()
    from fries_tpu_torch import rung

    step, state, est, _ = rung.build(torch.device("cuda"))
    for _ in range(3):
        state, _ = step(state, *est)
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
    busy_ms, idle, n_ops, top = trace_device_activity(args.trace, args.steps)
    labels = {"spawn (total)", "comp_sub (A+B, E)", "comp_sub_factored (C+D)",
              "find_preserve", "sys_comp", "emit kernel", "merge (sort + kernel)",
              "diagonal", "norm_weight"}
    phases = {e.key: _device_time(e) / args.steps / 1e3
              for e in prof.key_averages() if e.key in labels}
    report = {
        "device": torch.cuda.get_device_name(0), "rung": "1e6", "steps": args.steps,
        "wall_ms_per_step": 1e3 * wall / args.steps,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": idle,
        "device_ops_per_step": n_ops,
        "host_syncs_per_step": syncs,
        "phase_device_ms_per_step": phases,
        "top_kernels_ms_per_step": top,
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
