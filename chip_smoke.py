#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (fries_tpu_torch) once on one NVIDIA GPU.

Phases, in order; any failure exits non-zero:

1. require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build and load the hand-written kernels (``fries_tpu_torch/csrc/*.cu``);
3. kernel A (sorted-merge accumulate) against its plain torch version at the
   1e6 rung's shapes (C = 2^21 arena rows, S = 1,032,768 spawns), both row
   layouts, plus the empty-spawn, empty-arena and overflow cases;
4. kernel B (comp_sub emission) against its plain version at the A+B stage's
   shapes (N = 2^21, K = 28) and level E's (N = 1,032,768, K = 7), with
   weighted and uniform parents, a few heavy ones among them so that every
   case emits kept subs;
5. the main path: ``drivers.frisys.build`` on the synthetic N2/cc-pVDZ-sized
   system, first a small system stepped on the card and on the CPU from the
   same state, then the 1e6 rung of ``fries_tpu_torch.rung`` (2 warm-up + 5
   timed steps) with the kernel launch counters reset just before the timed
   steps; afterwards the longest run of equal keys in one step's spawn
   stream (the merge kernel sums each run in one thread) is logged.

Prints one JSON line of per-kernel results before the last line, and as the
last line ``{"ok": true, "device": {...}}``.  Usage: ``python3 chip_smoke.py``.
"""

import json
import subprocess
import sys
import time

N_WARM, N_TIMED = 2, 5


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------

def merge_inputs(gen, dev, capacity, n_occ, n_spawn, n_universe, n_words=2,
                 ini_frac=0.6, invalid_frac=0.1, keep_frac=0.05, n_vecs=2):
    import torch
    from fries_tpu_torch import dets
    from fries_tpu_torch.runtime import arena as ar

    bits = 32 * n_words - 8
    uni = torch.unique(torch.randint(0, 1 << bits, (n_universe,), generator=gen,
                                     device=dev))
    uni = dets.unpack_key(uni ^ dets.INT64_MIN, n_words) if n_words == 2 else \
        (uni & dets.WORD_MASK)[:, None]
    pick = torch.randperm(uni.shape[0], generator=gen, device=dev)[:n_occ]
    occ = uni[torch.sort(pick).values]
    occ = occ[torch.sort(dets.pack_key(occ), stable=True).indices]
    a = ar.make(capacity, n_words, n_vecs, device=dev)
    a.keys[: occ.shape[0]] = occ
    v = torch.randn(occ.shape[0], generator=gen, device=dev, dtype=torch.float64)
    v[torch.rand(occ.shape[0], generator=gen, device=dev) < 0.2] = 0.0
    a.vals[0, : occ.shape[0]] = v
    a = ar.Arena(keys=a.keys, vals=a.vals, n_used=torch.tensor([occ.shape[0]], device=dev))
    sk = uni[torch.randint(0, uni.shape[0], (n_spawn,), generator=gen, device=dev)]
    sk[torch.rand(n_spawn, generator=gen, device=dev) < invalid_frac] = dets.WORD_MASK
    sv = 0.3 * torch.randn(n_spawn, generator=gen, device=dev, dtype=torch.float64)
    si = torch.rand(n_spawn, generator=gen, device=dev) < ini_frac
    keep = torch.rand(capacity, generator=gen, device=dev) < keep_frac
    return a, sk, sv, si, keep


def check_merge(label, a, sk, sv, si, layout, keep, timed=False):
    import torch
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import merge

    n_vecs, origin, dest = layout
    if n_vecs == 1:
        a = ar.Arena(keys=a.keys, vals=a.vals[:1].contiguous(), n_used=a.n_used)
    else:
        a = ar.Arena(keys=a.keys, vals=torch.stack([a.vals[0], torch.zeros_like(a.vals[0])]),
                     n_used=a.n_used)
    got, gs = merge.accumulate(a, sk, sv, si, origin, dest, keep_mask=keep)
    ref, rs = merge.accumulate_plain(a, sk, sv, si, origin, dest, keep)
    torch.cuda.synchronize()
    if not torch.equal(got.keys, ref.keys):
        raise AssertionError(f"merge {label}: keys differ")
    for name, x, y in (("n_out", got.n_used, ref.n_used),
                       ("overflow", gs["overflow"], rs["overflow"]),
                       ("nonini_occ_add", gs["nonini_occ_add"], rs["nonini_occ_add"])):
        if int(x.reshape(-1)[0]) != int(y.reshape(-1)[0]):
            raise AssertionError(f"merge {label}: {name} {int(x)} != {int(y)}")
    if not torch.allclose(got.vals, ref.vals, rtol=1e-12, atol=1e-12):
        raise AssertionError(f"merge {label}: values differ")
    err = float((got.vals - ref.vals).abs().max())
    out = {"max_abs_err": err, "n_out": int(got.n_used[0]),
           "overflow": bool(gs["overflow"])}
    if timed:
        out["ms"] = cuda_ms(lambda: merge.accumulate(a, sk, sv, si, origin, dest,
                                                     keep_mask=keep))
        out["plain_ms"] = cuda_ms(lambda: merge.accumulate_plain(
            a, sk, sv, si, origin, dest, keep))
    log(f"merge {label}: agrees ({json.dumps(out)})")
    return out


def phase_merge(dev):
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import arena as ar

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    a, sk, sv, si, keep = merge_inputs(gen, dev, rung.CAPACITY, rung.N_SAMP,
                                       rung.SPAWN_CAP, rung.N_SAMP * 8 // 5)
    res = check_merge("rung layout (2,0,1) + keep_mask", a, sk, sv, si, (2, 0, 1),
                      keep, timed=True)
    check_merge("rung layout (1,0,0)", a, sk, sv, si, (1, 0, 0), None)
    for w in (1, 2):
        a, sk, sv, si, keep = merge_inputs(gen, dev, 1024, 400, 700, 800, n_words=w)
        check_merge(f"small W={w} (2,0,1)", a, sk, sv, si, (2, 0, 1), keep)
    a, sk, sv, si, keep = merge_inputs(gen, dev, 128, 40, 32, 64, invalid_frac=1.0)
    check_merge("empty spawns", a, sk, sv, si, (2, 0, 1), keep)
    e = ar.make(128, 2, 2, device=dev)
    ek = torch.randint(0, 1 << 16, (64, 2), generator=gen, device=dev)
    ev = torch.randn(64, generator=gen, device=dev, dtype=torch.float64)
    check_merge("empty arena", e, ek, ev, torch.ones(64, dtype=torch.bool, device=dev),
                (1, 0, 0), None)
    a, sk, sv, si, keep = merge_inputs(gen, dev, 64, 60, 200, 400, ini_frac=1.0,
                                       invalid_frac=0.0)
    o = check_merge("overflow", a, sk, sv, si, (2, 0, 1), keep)
    if not o["overflow"]:
        raise AssertionError("merge overflow case did not overflow")
    return res


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------

def emission_plan(gen, dev, n, k, n_samp, out_size, uniform_frac,
                  heavy_frac=1e-3, heavy=1000.0):
    """comp_sub's plan over random parents; a ``heavy_frac`` share of them
    carries ``heavy`` times the mass, as the largest amplitudes of the main
    path do, so that some of their subs pass the preservation threshold."""
    import torch
    from fries_tpu_torch import compress

    r = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=torch.float64)
    values = torch.where(r(n) < 0.8, -torch.log(r(n)), 0.0)
    values = torch.where(r(n) < heavy_frac, heavy * values, values)
    mask = r(n, k) < 0.8
    mask[:, 0] = True
    w = torch.where(mask, r(n, k) + 1e-6, 0.0)
    w = w / w.sum(1, keepdim=True)
    ndiv = torch.where(r(n) < uniform_frac,
                       torch.randint(1, 17, (n,), generator=gen, device=dev), 0)
    plan, _ = compress.comp_sub_plan(values, ndiv, w.float(), mask, n_samp,
                                     float(r(())), out_size)
    return plan


def check_emit(label, plan, timed=False):
    import torch
    from fries_tpu_torch.runtime import emit

    gv, gp, gs = emit.emit(**plan)
    rv, rp, rs = emit.emit_plain(**plan)
    torch.cuda.synchronize()
    if not torch.equal(gp, rp):
        raise AssertionError(f"emit {label}: parents differ")
    live = rp >= 0
    r = torch.arange(rp.shape[0], device=rp.device) - plan["offsets"][rp.clamp_min(0)]
    kept = live & (r < plan["kept_counts"][rp.clamp_min(0)])
    if not bool(kept.any()):
        raise AssertionError(f"emit {label}: no kept emission to compare")
    if not (torch.equal(gs[kept], rs[kept]) and torch.equal(gv[kept], rv[kept])):
        raise AssertionError(f"emit {label}: kept emissions differ")
    same = gs == rs
    frac = float(same.double().mean())
    if frac < 0.9999:
        raise AssertionError(f"emit {label}: sub agreement {frac}")
    if not torch.allclose(gv[same], rv[same], rtol=1e-13, atol=1e-300):
        raise AssertionError(f"emit {label}: values differ")
    mass_rel = abs(float(gv.sum()) - float(rv.sum())) / max(abs(float(rv.sum())), 1e-300)
    if mass_rel > 1e-11:
        raise AssertionError(f"emit {label}: emitted mass differs ({mass_rel})")
    out = {"max_abs_err": float((gv - rv).abs().max()), "sub_agreement": frac,
           "n_out": int(min(int(plan["total"]), plan["out_size"])), "kept": int(kept.sum())}
    if timed:
        out["ms"] = cuda_ms(lambda: emit.emit(**plan))
        out["plain_ms"] = cuda_ms(lambda: emit.emit_plain(**plan))
    log(f"emit {label}: agrees ({json.dumps(out)})")
    return out


def phase_emit(dev):
    import torch
    from fries_tpu_torch import rung

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    n, cap, m = rung.N_SAMP, rung.CAPACITY, rung.SPAWN_CAP
    res = check_emit("A+B shapes (N=2^21, K=28), weighted",
                     emission_plan(gen, dev, cap, 28, n, m, 0.0), timed=True)
    check_emit("A+B shapes, 30% uniform parents",
               emission_plan(gen, dev, cap, 28, n, m, 0.3))
    check_emit("level E shapes (N=1,032,768, K=7), mixed",
               emission_plan(gen, dev, m, 7, n, m, 0.5))
    return res


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def phase_small_step(dev):
    """A small system stepped on the card and on the CPU (plain versions)
    from the same state with the same uniforms: keys exact, values close."""
    import numpy as np
    import torch
    from fries_tpu_torch import synth
    from fries_tpu_torch.drivers import frisys, power
    from fries_tpu_torch.runtime import arena as ar

    symm = np.array([0, 1, 0, 1, 0, 1, 2, 3])
    cfg = frisys.FrisysConfig(eps=0.02, vec_nonz=60, matr_samp=150, capacity=256,
                              spawn_cap=200, target_norm=200.0, shift_interval=2)
    step_c, run_c, state, aux_c = frisys.build(
        synth.make_system(8, 4, symm=symm, seed=3), cfg, seed=4)
    step_g, _, _, aux_g = frisys.build(
        synth.make_system(8, 4, symm=symm, seed=3, device=dev), cfg, seed=4)
    args = lambda aux: (aux["num_keys"], aux["num_vals"], aux["den_keys"],
                        aux["den_vals"], aux["ref_key"])
    state, _ = run_c(state, *args(aux_c), 20)
    rng = np.random.default_rng(0)
    for it in range(3):
        rns, rn = rng.random(6), float(rng.random())
        a = state.arena
        g_state = power.PowerState(
            ar.Arena(a.keys.to(dev), a.vals.to(dev), a.n_used.to(dev)),
            state.en_shift.to(dev), state.last_norm.to(dev), state.iterat,
            state.generator)
        state, mc = step_c(state, *args(aux_c), rns=rns, rn_vec=rn)
        g_state, mg = step_g(g_state, *args(aux_g), rns=rns, rn_vec=rn)
        if not torch.equal(g_state.arena.keys.cpu(), state.arena.keys):
            raise AssertionError(f"small step {it}: card and CPU keys differ")
        if not torch.allclose(g_state.arena.vals.cpu(), state.arena.vals,
                              rtol=1e-10, atol=1e-12):
            raise AssertionError(f"small step {it}: card and CPU values differ")
        for k in mc:
            if not np.isclose(float(mg[k]), float(mc[k]), rtol=1e-10, atol=1e-12):
                raise AssertionError(f"small step {it}: metric {k} differs")
    log("small system: 3 steps on the card match the CPU plain path")


def longest_spawn_segment(spawn, state):
    """Longest run of one target key in the sorted spawn stream of a step
    from ``state``: the longest sequential sum of the merge kernel."""
    import torch
    from fries_tpu_torch import dets, rung

    a = state.arena
    rns = torch.rand(6, dtype=torch.float64, device=a.device)
    words, amps, _ = spawn(a.keys, torch.where(a.valid, a.vals[0], 0.0), -rung.EPS, rns)
    keys = torch.sort(dets.pack_key(words[amps != 0])).values
    return int(torch.unique_consecutive(keys, return_counts=True)[1].max())


def phase_main_path(dev):
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import emit, merge

    n_samp = rung.N_SAMP
    t0 = time.perf_counter()
    step, state, args, aux = rung.build(dev)
    torch.cuda.synchronize()
    log(f"main path: 1e6 rung built in {time.perf_counter() - t0:.1f} s "
        f"(28 orbitals, 14 electrons, capacity {rung.CAPACITY}, "
        f"spawn_cap {rung.SPAWN_CAP})")
    for _ in range(N_WARM):
        state, m = step(state, *args)
        if bool(m["overflow"]):
            raise AssertionError("main path: overflow during warm-up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    merge.LAUNCHES = 0
    emit.LAUNCHES = 0
    t0 = time.perf_counter()
    metrics = []
    for _ in range(N_TIMED):
        state, m = step(state, *args)
        metrics.append(m)
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / N_TIMED
    launches = {"merge": merge.LAUNCHES, "emit": emit.LAUNCHES}
    for i, m in enumerate(metrics):
        if bool(m["overflow"]):
            raise AssertionError(f"main path: overflow at timed step {i}")
        num, den = float(m["proj_num"]), float(m["proj_den"])
        if not (torch.isfinite(torch.tensor([num, den])).all() and den != 0):
            raise AssertionError(f"main path: non-finite estimator at step {i}")
    if launches["merge"] < N_TIMED or launches["emit"] < 2 * N_TIMED:
        raise AssertionError(f"main path did not run through the kernels: {launches}")
    last = metrics[-1]
    res = {
        "rung": "1e6", "ms_per_step": 1e3 * s_per_step,
        "sampled_nonzeros_per_s": n_samp / s_per_step,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "n_dets": int(last["n_dets"]),
        "norm": float(last["norm"]),
        "e_corr_est": float(last["proj_num"]) / float(last["proj_den"]),
        "longest_spawn_segment": longest_spawn_segment(aux["spawn"], state),
    }
    log(f"main path: {json.dumps(res)}")
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from fries_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    m = phase_merge(dev)
    e = phase_emit(dev)
    phase_small_step(dev)
    main_res = phase_main_path(dev)

    kernels = [
        {"name": "merge", "route": "cuda", "source": "fries_tpu_torch/csrc/merge.cu",
         "replaces": "fries_tpu/runtime/pallas_merge.py:617",
         "launches": main_res["launches"]["merge"], "max_abs_err": m["max_abs_err"],
         "ms": m["ms"], "plain_ms": m["plain_ms"]},
        {"name": "emit", "route": "cuda", "source": "fries_tpu_torch/csrc/emit.cu",
         "replaces": "fries_tpu/runtime/pallas_emit.py:147",
         "launches": main_res["launches"]["emit"], "max_abs_err": e["max_abs_err"],
         "ms": e["ms"], "plain_ms": e["plain_ms"]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
