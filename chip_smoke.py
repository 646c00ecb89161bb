#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (fries_tpu_torch) once on one NVIDIA GPU.

Phases, in order; any failure exits non-zero.  Around the timed steps of
every frisys path (the rung, ``semistoch``, the unfused rung, ``ne_qz``,
``ne2_qz``, ``rung_real``, ``semistoch_cisd``, the flagship, the anchor and
the sharded step) kernel F's launches are counted and must be R + 3 for
each C+D plan of R fixpoint rounds (``fixpoint.comp_sub`` reads inside
``compress.comp_sub_factored_plan``), one plan a step, none in the unfused
rung; the phases log them per step (``launches_per_step``).

1. require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build and load the hand-written kernels (``fries_tpu_torch/csrc/*.cu``);
   the loader launches kernel #5 (the backend probe's copy) once, with its
   count reset just before; then the probe against its plain version on a
   random tile;
3. kernel A (sorted-merge accumulate) against its plain torch version at the
   1e6 rung's shapes (C = 2^21 arena rows, S = 1,032,768 spawns), both row
   layouts and 200,000 spawns on one key, plus the empty-spawn, empty-arena
   and overflow cases; then a made-up stream in the regime of one chunk of
   the exact-H step (C = 2^18, one-word keys, S = batch x template
   excitations, no keep mask, a non-zero destination row, 40% of the stream
   sentinel keys, every target repeated) and, in phase 9, at the
   semistochastic merge's shapes (S = spawn_cap + the dense block's
   elements, protected bits in the keep mask);
4. kernel B (comp_sub emission) against its plain version at the A+B stage's
   shapes (N = 2^21, K = 28) and level E's (N = 1,032,768, K = 7) over the
   dense row source, and at the C+D stage's (N = 1,032,768 parents, E = 14,
   V = 21, with and without the kill mask) over the factored source, with
   weighted and uniform parents, a few heavy ones among them so that every
   case emits kept subs;
5. kernel C (multi-row merge) against its plain version at the subspace
   path's shapes (C = 2^20 arena rows, R = 2 value rows, S = 600,000
   spawns) and with 200,000 of them on one key, at R = 14, and in the
   empty-spawn, empty-arena and overflow cases;
5b. kernels A and C on 128-bit keys (W = 3 and 4 words) against their
   plain versions: made-up streams at ``ne_qz``'s shapes (kernel A: C =
   2^20, S = 532,768, layouts (2, 0, 1) with a keep mask and (1, 0, 0)) and
   ``ne_qz_subsp``'s (kernel C: C = 2^20, R = 2, S = 600,000), each also
   with 200,000 spawns on one key and with 90% sentinel rows, over keys
   that differ only in the low word or only above the 64-bit boundary; and
   the overflow, empty-arena and empty-spawn cases;
6. kernel #6 (the probe relayout, ``fries_tpu_torch.probe_reshape``)
   against its plain version on a random tile, then its entry point
   (``probe_reshape.main``, the port of ``tools/probe_reshape.py``) with its
   count reset just before;
7. the frisys main path: ``drivers.frisys.build`` on the synthetic
   N2/cc-pVDZ-sized system, first a small system stepped on the card and on
   the CPU from the same state, then the 1e6 rung of
   ``fries_tpu_torch.rung`` (2 warm-up + 5 timed steps) with the kernel
   launch counters reset just before the timed steps; afterwards the longest
   run of equal keys in one step's spawn stream is logged;
8. the subspace path: ``drivers.subspace.build``, first a small system
   stepped on the card and on the CPU from the same state with the same key
   tree across a restart and a norm-factor update, then bench.py's subsp
   configuration (``fries_tpu_torch.rung.subspace_config``: the synthetic
   Ne/aug-cc-pVDZ-sized system, 2 states; 2 warm-up + 5 timed steps, the
   counters reset just before the timed steps);
9. the semistochastic path: a small system with a protected deterministic
   space, and one in the even time-reversal sector, stepped on the card and
   on the CPU from one state; then the ``semistoch`` configuration of
   ``fries_tpu_torch.rung`` (the 1e6 rung plus a deterministic space; 2 + 5
   steps), kernel A's and B's launches read around the timed steps;
10. the exact-H path: small systems stepped chunk by chunk on the card and on
   the CPU, with and without the dedup and in the even sector; then
   bench.py's frifull configuration (``rung.frifull_config``: 48 chunks per
   step; two warm-up blocks of 3 steps, more while the vector holds fewer
   than its 30,000 nonzeros, then 3 timed steps, each step's ``n_dets`` and
   ``nnonz`` logged), 48 kernel A launches per step asserted; one real chunk
   stream (the path's own tensors: the second chunk of the step after the
   timed ones) merged by the kernel and by its plain version into the arena
   that holds the first chunk's sums, which phase 11 also times; and 1 + 2
   steps with ``dedup_cap = 2^19`` from the same state;
11. the FCIQMC path: a small system stepped on the card and on the CPU from
   one state, both drawing from one key tree on the CPU (near-uniform and
   heat-bath, integer and fp walkers): keys, counts and integer values
   exact; then the ``fciqmc`` configuration of ``fries_tpu_torch.rung``
   (bench.py's 5M-walker rung: 12 blocks of 5 warm-up steps, 5 timed, 1
   kernel A launch and 1 kernel G launch per step and no plain attempt
   pass on the card asserted; ms/step, walker-iterations/s, peak memory;
   then 3 steps under a profiler, whose device counter
   ``sampler.fallback`` is logged; then kernel G against the plain attempt
   pass on the next step's 2^23 slots: results compared, device and call
   ms of each, the kernel's bound; alone: ``--fciqmc``) and two real
   steps' merge inputs (the
   post-death one-row arena and the spawn stream, layout (1, 0, 0): the
   first step's, all attempts from HF, and the one after the profiled
   steps) through kernel A and its
   plain version, equal exactly, values included; phase 13 times the
   second;
12. the frimulti path: small systems card against CPU (NU, HB), then the
   ``frimulti`` configuration (2 warm-up + 3 timed steps);
13. the Hubbard-Holstein paths: frifull_hh and frisys_hh on the small
   3-site system and on pure Hubbard (ph_bits 0), card against CPU from one
   state; then bench.py's frifull_hh configuration (``rung.frifull_hh_config``:
   30 warm-up + 10 timed steps, 1 kernel A launch per step asserted,
   candidates/s) and the ``frisys_hh`` configuration (12 sites, two-word
   keys; warm-up until the vector holds its 1e6 nonzeros, at most 40 steps,
   then 5 timed, 2 emissions and 1 kernel A launch per step asserted,
   sampled nonzeros/s); each path's real merge input through kernel A and
   its plain version, and frisys_hh's two real emission plans (level 1: K =
   2 weighted rows; level 2: K = 1 all-uniform rows) through kernel B and
   its plain version;
14. the subspace modes: ``lowmem`` (also in the even sector), ``exact_h`` in
   chunks and ``compress_mode="multi"`` on a small system, card against CPU;
   then the subsp configuration's ``lowmem`` (one step of the stored and the
   lowmem path from one state, h_mat within rtol 1e-10; 2 + 5 steps) and
   ``multi`` (2 + 3 steps), and the ``subspfull`` configuration (exact H on
   the frifull system, warm-up until both vectors hold their budget, 3 timed
   steps, one kernel C launch per chunk asserted; a real chunk through kernel
   C and its plain version);
15. the observable estimators: the Rayleigh and the replica estimator on a
   small system, card against CPU (10 steps each); then the ``observables``
   and ``obs_repl`` configurations (``rung.observables_config``: frifull's
   system at its widths, 6 warm-up and 6 timed steps; ms/step, exact-H
   candidates/s, peak memory, kernel A launches per step and per layout,
   asserted to be (4, 0, 0) and (4, 0, 3), or (4, 0, 0), (4, 1, 1) and
   (4, 1, 3), with the plain merge barred from the card), and one more
   step's merge inputs of each layout through kernel A and its plain
   version;
16. frisys's unfused stages: a small system card against CPU, then the 1e6
   rung with ``fuse_ab=False, fuse_cd=False`` (2 + 3 steps, 5 kernel B and 1
   kernel A launches per step asserted) and a real step's five emission
   plans (levels A to E) through kernel B and its plain version;
17. checkpoint and resume through the command line's entry point on the
   card: frisys_mol, fciqmc_mol and subsp_mol, 6 iterations then 6 more
   with ``--load_dir`` against a straight 12, stream for stream exactly;
17b. the four-word paths: a small four-word frisys step (50 orbitals) and
   subspace step (across a restart), card against CPU from one state; then
   ``ne_qz`` (``rung.ne_qz_config``: the Ne/cc-pVQZ-shaped system, 54
   orbitals, 8 electrons, bench.py's 500k rung; 2 warm-up + 5 timed steps,
   exactly 1 kernel A and 3 kernel B launches per step asserted; ms/step,
   nonzeros/s, peak memory) and a real step's merge input through kernel A
   and its plain version, its unnormalized run (2 + 2 steps, the same
   launches asserted), and ``ne_qz_subsp`` (bench.py's subsp configuration
   on that system; 2 + 5 iterations, 1 kernel C launch per iteration
   asserted) and a real iteration's merge input through kernel C and its
   plain version;
17c. the integral pipeline and bench.py's real molecules: the five
   systems of ``fries_tpu_torch.real_systems`` built on the card (AO
   integrals, RHF, MO transform, each timed), H2O and N2/cc-pVDZ also on
   the CPU and held against the card after the gauge alignment (hcore and
   ERIs within 1e-10, E_HF within 1e-9 Ha, irreps equal), Ne/cc-pVQZ's
   RHF energy against the reference pipeline's -128.54347011764926 Ha
   (within 1e-8) and its irreps against ``rung.NE_QZ_SYMM``; ``ne_qz`` and
   ``ne_qz_subsp`` above run on that real Ne/cc-pVQZ; then ``rung_real``
   (the 1e6 rung on real N2/cc-pVDZ: 2 + 5 steps, 1 kernel A and 3 kernel
   B launches per step asserted, a real step's merge through kernel A and
   its three emission plans through kernel B), ``semistoch_cisd`` (the CISD
   on the card, its 150 largest-|c| determinants as the deterministic
   space; 2 + 5 steps; a real merge with the protected keep bits),
   ``frifull_real`` (real H2O/cc-pVDZ's (10e, 12o): 2 + 5 steps, 48 kernel
   A launches per step; a real dedup'd chunk) and ``fciqmc_real`` (real
   stretched N2: 60 + 5 steps, then bench.py's own capacity and shift
   interval for its 65 iterations, the first overflow logged); each with
   ms/step, its rate, peak memory and launches per step;
17e. the flagship science run (``fries_tpu_torch.flagship``) on
   Ne/aug-cc-pVDZ with its anchor's configuration (150,000 nonzeros, the 50
   largest CISD determinants as the deterministic space, initiator 1.0,
   eps 1e-3, deadbeat + tracking shift control, seed 20): the system and
   its CISD built on the card (seconds), ``flagship.run`` for 200
   iterations in 4 blocks of 50 with the kernels' counts reset just before
   (1 kernel A and 3 kernel B launches per iteration asserted), no
   overflow, finite estimators, five streams of 200 lines and the gate's
   transient diagnosis; then 100 iterations and 100 more resumed from the
   checkpoint, whose streams must equal the straight run's exactly; then
   the state at iteration 200 stepped once more with fixed uniforms: its
   merge input (protected keep bits) through kernel A and its three
   emission plans (A+B, C+D, E) through kernel B, against their plain
   versions; ms/step and the build, CISD and ``frisys.build`` seconds on a
   line of their own;
17f. the last science tools: ``anchor_scale``'s 48,400-determinant anchor
   at its defaults (12 orbitals, 6 electrons, seed 5): the Lanczos at full
   dimension (E0 within 1e-8 Ha of the JAX record -15.340561820, seconds),
   300 iterations in blocks of 25 with the counts reset just before (1
   kernel A and 3 kernel B launches per iteration asserted, no overflow,
   finite estimators, ms/step, peak), then one more step fed fixed
   uniforms: its merge input through kernel A and its three emission plans
   through kernel B against their plain versions; ``make_fcidump water``
   on the card, read back by both readers, and ``frisys_mol`` on that file
   through the command line for 40 iterations (1 kernel A and 3 kernel B
   launches per iteration, the last iteration's launches against their
   plain versions); ``derive_ccpvqz``'s E_HF just below -128.543470 Ha and
   its contractions ``basis.py``'s to 5e-7;
17g. past kernels A and C's bounds: ``python -m fries_tpu_torch.cli``'s
   subsp_mol, subsp_mol_lowmem and subspfull_mol with 33 trial vectors (HF
   and the 32 determinants of its irrep nearest to it) on the small
   system's FCIDUMP (4 iterations, a restart every second), and frisys_hh
   and frifull_hh on a half-filled 86-site chain at ph_bits 4 (516 bits,
   17 words; 6 iterations), each on the card and with ``--device cpu``:
   every stream within rtol 1e-10, atol 1e-12 of the CPU's, at least one
   merge counted in ``merge.plain_on_card`` (``profiling``) on the card, and
   kernel C (subspace) or kernel A (chain) launched no time there;
   ``arena.accumulate_best`` with a keep mask at layout (3, 1, 2) on the
   1e6 rung's shapes (a compaction, then one kernel A launch) against
   ``merge.accumulate_plain`` on the CPU; and, after 17c's frifull_real,
   ``frifull_real`` (dedup 2^19) built and stepped 4 times, twice from one
   seed: every step's metrics and the last arena equal bit for bit.
   ``merge.plain_on_card`` (``profiling``) must be 0 after every phase
   before this one and after the timings;
18. the timings: each kernel's wrapper and its plain version on the inputs of
   its check at the main path's shapes (the same seeds), last, since the
   profiler that reads device times slows every later launch of the process.
   For the two merges also the spawn sort alone (``sort_ms``,
   ``sort_device_ms``: the key pack and ``torch.sort`` that run before the
   kernel entry) and the one-key stress case (``stress_ms``,
   ``stress_device_ms``); ``device_ops`` counts the device operations of one
   call (the kernel entry's are ``device_ops - sort_device_ops``).

17d. hash sharding (:mod:`fries_tpu_torch.parallel`, one process per
   rank): the probe (gloo must take all three collectives the port issues
   on CUDA tensors in a 2-rank world on this card, each checked for its
   values, and so must a 1-rank NCCL world; the phase fails on a refusal); the exchange: a 2-rank world
   on the card over ``rung_real``'s real spawn stream (each rank half of
   it): every live row lands on the rank its hash names, once (counts, key
   checksums and amplitude sums per destination), and the ragged and dense
   paths deliver the same multiset; ``rung_real_sharded`` at full width in a
   1-rank NCCL world and in a 2-rank world on the card (gloo, the card
   shared): its 2 warm-up steps run twice from one seed must give the same
   arena and metrics bit for bit on every rank (every stage's inputs and
   outputs hashed, the first that differs named), with N2/cc-pVDZ built
   twice per rank equal bit for bit; then 2 warm-up steps, then 2 steps fed
   fixed uniforms with the
   kernels and with their plain versions from one state (each captured
   kernel launch of the last step against its plain version at its own
   tolerance; the merged arenas and metrics of the two runs within the
   limits of ``compare_runs``: flags equal, at most 20 keys in one arena
   only, values' relative L1 under 1e-5, float metrics under 1e-6 and the
   counts before the vector compression under 2e-5; kernel B emits on
   rank 1 with a nonzero shard offset, kernel A merges each rank's received
   stream), then 5 timed steps (ms/step, exchange ms, host syncs per step,
   peak memory per rank); ``subsp_sharded`` the same way (2 + 2 + 3
   iterations, kernel C per rank); the reference's identity equivalences
   (frifull, subspace ``exact_h``), 2 ranks against 1, to rtol 1e-9; and,
   with two or more cards, ``rung_real_sharded`` under NCCL on 2 cards (else
   the log says it did not run).  The 2-rank-on-one-card times are two
   processes sharing one card, not a scaling result;
19. ``python -m fries_tpu_torch.profile_step`` in a child process for each
   real configuration (``rung_real``, ``semistoch_cisd``, ``ne_qz``,
   ``ne_qz_unnorm``, ``ne_qz_subsp``, ``frifull_real``, ``fciqmc_real``, and
   the sharded ``rung_real_sharded`` and ``subsp_sharded`` in a 1-rank NCCL
   world, with the exchange's phases):
   device busy ms and idle share per step, host synchronizations, the
   largest phases (a profiler slows every later launch of its process, so
   none runs in this one).

Before it touches the card it checks that neither JAX nor the JAX package is
loaded.  Prints one JSON line of per-kernel results before the last line,
and as the last line ``{"ok": true, "device": {...}}``.  Each kernel's ``bound_ms`` is
the larger of its bytes (each input read once, each output written once, as
this run's data needs them) over 3.35 TB/s and its f32 operations over 67
TFLOP/s (the H100 SXM's published peaks).  ``ms``, ``plain_ms`` and
``library_ms`` are the time between two CUDA events around one call, the
host's work included; ``device_ms`` and ``plain_device_ms`` the device time
of one call, from a profiler trace.  Kernel B's entry sums its three
launches of one frisys step (A+B, C+D, E); its ``shapes`` break that down.
Kernel A's entry is the rung's case; its ``shapes`` add the exact-H chunk
(``frifull_chunk``: phase 10's real stream and arena, with the bound of
those tensors), the semistochastic merge, FCIQMC's merge (``fciqmc``:
phase 11's real input) and the Hubbard-Holstein paths' real merges
(``frifull_hh``, ``frisys_hh``) and the observables' real merges
(``observables (4, 0, 0)``, ``observables (4, 0, 3)``, ``obs_repl (4, 1,
1)``, ``obs_repl (4, 1, 3)``), ``ne_qz``'s real four-word merge
(``ne_qz (W=4)``) and the real molecules' (``rung_real``,
``semistoch_cisd``, ``frifull_real_chunk``, ``fciqmc_real``) and the
flagship's (``flagship``).  Kernel B's
``shapes`` add frisys_hh's two levels (``hh level 1``, ``hh level 2``),
the unfused rung's five (``unfused A`` to ``unfused E``), rung_real's
three (``rung_real A+B``, ``rung_real C+D``, ``rung_real E``) and the
flagship's three (``flagship A+B``, ``flagship C+D``, ``flagship E``), none in
its entry's sums; kernel C's the
subspfull chunk (``subspfull_chunk``) and ``ne_qz_subsp``'s real
four-word merge (``ne_qz_subsp (W=4)``).  ``launches`` sums a kernel's
launches over the timed steps of every path (``launches_by_path`` breaks
them down).
Usage: ``python3 chip_smoke.py``; ``--sharding N`` runs phase 17d alone N
times (its inputs built once) and counts the runs that pass;
``--past_bounds`` runs phase 17g alone (with real H2O/cc-pVDZ built for its
frifull_real).
"""

import contextlib
import gc
import json
import subprocess
import sys
import time

N_WARM, N_TIMED = 2, 5
N_FALLBACK = 3     # profiled fciqmc steps that read the sampler.fallback counter
STRESS_SPAWNS = 200_000
HBM_BYTES_PER_S = 3.35e12    # H100 SXM: device memory rate
F32_OPS_PER_S = 67e12        # H100 SXM: f32 outside the tensor cores
F64_OPS_PER_S = 33.5e12      # H100 SXM: f64 outside the tensor cores


def log(*args):
    print(*args, flush=True)


def counter(name: str) -> int:
    """The running total of a counter of :mod:`fries_tpu_torch.profiling`."""
    from fries_tpu_torch import profiling

    return profiling.total(name)


def reset_counters(*names: str):
    from fries_tpu_torch import profiling

    profiling.reset(*names)


def _launch_counter(mod) -> str:
    """The counter of a kernel wrapper module's launches (``merge``,
    ``emit``, ``merge_multi``, ``probe_reshape``)."""
    return "launch." + mod.__name__.rsplit(".", 1)[-1]


def kernel_launches(mod) -> int:
    return counter(_launch_counter(mod))


def reset_launches(*mods):
    reset_counters(*map(_launch_counter, mods))


@contextlib.contextmanager
def cd_plans():
    """Kernel F's launch count reset, then the C+D rounds' plans
    (``compress.comp_sub_factored_plan`` calls) and their fixpoint rounds
    (the ``fixpoint.comp_sub`` reads made inside them) counted while open;
    yields {"plans": P, "rounds": R} for :func:`check_plan_launches`."""
    from fries_tpu_torch import compress

    seen = {"plans": 0, "rounds": 0}

    def wrap(fn):
        def counted(*args, **kwargs):
            reads = counter("fixpoint.comp_sub")
            out = fn(*args, **kwargs)
            seen["plans"] += 1
            seen["rounds"] += counter("fixpoint.comp_sub") - reads
            return out
        return counted

    reset_counters("launch.plan")
    with patched((compress, "comp_sub_factored_plan", wrap)):
        yield seen


def check_plan_launches(label, seen, n_steps, plans_per_step):
    """Kernel F's launches in :func:`cd_plans`' block: R + 3 for each C+D
    plan of R fixpoint rounds, ``plans_per_step`` plans a step.  Returns
    {"plan": launches, "cd_rounds": R} per step."""
    got = counter("launch.plan")
    want = seen["rounds"] + 3 * seen["plans"]
    if seen["plans"] != plans_per_step * n_steps or got != want:
        raise AssertionError(f"{label}: {got} kernel F launches for {seen['plans']} C+D plans "
                             f"of {seen['rounds']} fixpoint rounds in {n_steps} steps, want "
                             f"{plans_per_step * n_steps} plans and R + 3 launches each")
    return {"plan": got / n_steps, "cd_rounds": seen["rounds"] / n_steps}


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` between two CUDA events over ``reps``
    runs after one warm-up (the host's work in the call included)."""
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


def device_profile(fn, reps=5):
    """(device milliseconds, device operations, {operation name: device ms})
    of one ``fn()``: the union of its kernels', copies' and memsets'
    intervals in a ``torch.profiler`` trace of ``reps`` runs after one
    warm-up, their count, and the time of the 12 longest by name, each
    divided by ``reps`` (the host's work in the call left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fries_tpu_torch import _build, profile_step

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    path = _build.BUILD_DIR / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    busy, _, n_ops, top, _, _ = profile_step.trace_device_activity(path, reps, set())
    return busy, n_ops, top



def check_no_reference_imports():
    """Import the port's modules that the phases use, then raise if JAX or
    the JAX package is among the loaded modules."""
    import importlib

    for name in ("fries_tpu_torch.rung", "fries_tpu_torch.cli", "fries_tpu_torch.profile_step",
                 "fries_tpu_torch.probe_reshape", "fries_tpu_torch.convert",
                 "fries_tpu_torch.stats", "fries_tpu_torch.runtime.checkpoint",
                 "fries_tpu_torch.basis", "fries_tpu_torch.sto3g", "fries_tpu_torch.gto",
                 "fries_tpu_torch.scf", "fries_tpu_torch.cisd", "fries_tpu_torch.linalg",
                 "fries_tpu_torch.real_systems", "fries_tpu_torch.flagship",
                 "fries_tpu_torch.anchor_scale", "fries_tpu_torch.make_fcidump",
                 "fries_tpu_torch.atomic_hf", "fries_tpu_torch.derive_ccpvqz"):
        importlib.import_module(name)
    loaded = sorted(n for n, mod in sys.modules.items() if mod is not None and (
        n in ("jax", "fries_tpu", "tools") or n.startswith(("jax.", "fries_tpu.", "tools."))))
    if loaded:
        raise AssertionError(f"chip_smoke: the reference is loaded: {loaded[:5]}")


def bound(n_bytes, n_ops=0):
    """The least time the card could take: bytes over the memory rate or
    f32 operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# kernel #5: the backend probe
# ---------------------------------------------------------------------------

def probe_copy_tile(dev):
    """A random (16, 128) f32 tile."""
    import torch
    from fries_tpu_torch import _build

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    return torch.randn(_build.PROBE_SHAPE, generator=gen, device=dev)


def phase_probe_copy(dev):
    """Kernel #5's launches by the loader (its path), then the kernel against
    its plain version on a random tile."""
    import torch
    from fries_tpu_torch import _build

    out = {"launches": counter("launch.probe_copy")}
    if out["launches"] < 1:
        raise AssertionError("the loader did not launch the probe copy")
    x = probe_copy_tile(dev)
    got, ref = _build.probe_copy(x), _build.probe_copy_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("probe_copy: kernel and plain version differ")
    out["max_abs_err"] = float((got - ref).abs().max())
    log(f"probe_copy: agrees ({json.dumps(out)})")
    return out


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------

def wide_universe(gen, dev, n, n_words):
    """About ``n`` distinct rows of ``n_words`` > 2 words (the last below
    2^24): random rows and as many copies of them with one word redrawn, so
    that many pairs differ in one word only, the low word, the top word (at
    odd W alone in its 64-bit limb) or one above a 64-bit boundary; past
    four words half the copies instead redraw the two words around a limb
    boundary (2j + 1 and 2j + 2).  In the arena's order."""
    import torch
    from fries_tpu_torch import dets

    half = n // 2
    base = torch.randint(0, 1 << 32, (half, n_words), generator=gen, device=dev)
    base[:, -1] &= (1 << 24) - 1
    variant = base.clone()
    rows = torch.arange(half, device=dev)
    word = torch.randint(0, n_words, (half,), generator=gen, device=dev)
    variant[rows, word] = torch.randint(0, 1 << 24, (half,), generator=gen, device=dev)
    if n_words > 4:
        pair = rows[half // 2:]
        low = 2 * torch.randint(0, (n_words - 1) // 2, (pair.shape[0],), generator=gen,
                                device=dev) + 1
        variant[pair] = base[pair]
        for w in (low, low + 1):
            variant[pair, w] = torch.randint(0, 1 << 24, (pair.shape[0],), generator=gen,
                                             device=dev)
    uni = torch.cat([base, variant])
    uni = uni[dets.sort_dets(uni)]
    first = torch.ones(uni.shape[0], dtype=torch.bool, device=dev)
    first[1:] = (uni[1:] != uni[:-1]).any(-1)
    return uni[first]


def merge_inputs(gen, dev, capacity, n_occ, n_spawn, n_universe, n_words=2,
                 ini_frac=0.6, invalid_frac=0.1, keep_frac=0.05, n_vecs=2):
    import torch
    from fries_tpu_torch import dets
    from fries_tpu_torch.runtime import arena as ar

    if n_words > 2:
        uni = wide_universe(gen, dev, n_universe, n_words)
    else:
        bits = 32 * n_words - 8
        uni = torch.unique(torch.randint(0, 1 << bits, (n_universe,), generator=gen,
                                         device=dev))
        uni = dets.unpack_key(uni ^ dets.INT64_MIN, n_words) if n_words == 2 else \
            (uni & dets.WORD_MASK)[:, None]
    pick = torch.randperm(uni.shape[0], generator=gen, device=dev)[:n_occ]
    occ = uni[torch.sort(pick).values]
    occ = occ[dets.sort_dets(occ)]
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


def compare_merges(label, kernel_out, plain_out, exact=False):
    """Raise unless a merge kernel's (arena, stats) equal its plain version's:
    keys, n_out, overflow and nonini_occ_add exact, values within rtol 1e-12
    (atol 1e-12: per-segment sums in another order), or equal with
    ``exact`` (integer sums); return a summary."""
    import torch

    (got, gs), (ref, rs) = kernel_out, plain_out
    torch.cuda.synchronize()
    if not torch.equal(got.keys, ref.keys):
        raise AssertionError(f"{label}: keys differ")
    for name, x, y in (("n_out", got.n_used, ref.n_used),
                       ("overflow", gs["overflow"], rs["overflow"]),
                       ("nonini_occ_add", gs["nonini_occ_add"], rs["nonini_occ_add"])):
        if int(x.reshape(-1)[0]) != int(y.reshape(-1)[0]):
            raise AssertionError(f"{label}: {name} {int(x)} != {int(y)}")
    if exact and not torch.equal(got.vals, ref.vals):
        raise AssertionError(f"{label}: values not equal")
    if not torch.allclose(got.vals, ref.vals, rtol=1e-12, atol=1e-12):
        raise AssertionError(f"{label}: values differ")
    return {"max_abs_err": float((got.vals - ref.vals).abs().max()),
            "n_out": int(got.n_used[0]), "overflow": bool(gs["overflow"])}


def with_rows(a, n_vecs):
    """``a`` with its value row 0 alone (``n_vecs`` 1) or followed by a zero
    row (2)."""
    import torch
    from fries_tpu_torch.runtime import arena as ar

    vals = (a.vals[:1].contiguous() if n_vecs == 1 else
            torch.stack([a.vals[0], torch.zeros_like(a.vals[0])]))
    return ar.Arena(keys=a.keys, vals=vals, n_used=a.n_used)


def merge_bound(a, spawns, keep=None):
    """A merge's bound: the arena's keys and values up to ``n_used`` (and
    the keep mask's rows there) and the ``spawns`` tensors in, the arena at
    full capacity out."""
    n_used, cap = int(a.n_used[0]), a.keys.shape[0]
    row = a.keys.nbytes // cap + a.vals.nbytes // cap
    return bound(row * (n_used + cap) + sum(t.nbytes for t in spawns)
                 + (0 if keep is None else n_used * keep.element_size()))


def rung_merge_case(gen, dev):
    """Kernel A's case at the 1e6 rung's shapes: (arena, spawn keys, values,
    initiator flags, keep mask)."""
    from fries_tpu_torch import rung

    return merge_inputs(gen, dev, rung.CAPACITY, rung.N_SAMP, rung.SPAWN_CAP,
                        rung.N_SAMP * 8 // 5)


def frifull_chunk_case(gen, dev):
    """A made-up case for kernel A in the regime of one chunk of the exact-H
    step: (arena, spawn keys, values, initiator flags).  Keys of the
    system's width (one word); C = 2^18 with 100,000 rows in use, as many
    as the arena holds a few chunks into a step, among them rows of zero
    origin value that carry a sum (an earlier chunk inserted them); S =
    batch * template excitations, 40% of it the sentinel key, the rest
    drawn from as many targets as the system has determinants, so each
    repeats about ten times; no keep mask.  A check only: the timings
    take the path's own chunk (:func:`phase_frifull`)."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.ops import molecule as mol

    cfg = rung.frifull_config()
    ham = rung.frifull_system()
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    s = cfg.batch * (tmpl.n_doub + tmpl.n_sing)
    a, sk, sv, si, _ = merge_inputs(gen, dev, cfg.capacity, 100_000, s, 140_000,
                                    n_words=ham.n_words, invalid_frac=0.4)
    a = with_rows(a, 2)
    n = int(a.n_used[0])
    carried = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    a.vals[1, :n] = torch.where(torch.rand(n, generator=gen, device=dev) < 0.7, carried, 0.0)
    return a, sk, sv, si


def semistoch_merge_case(gen, dev, n_elements):
    """Kernel A's case at the semistochastic merge's shapes: the rung's arena
    and ``SPAWN_CAP + n_elements`` spawns, the dense block's all initiators;
    150 rows of zero origin value protected by their keep bits."""
    import torch
    from fries_tpu_torch import rung

    a, sk, sv, si, keep = merge_inputs(gen, dev, rung.CAPACITY, rung.N_SAMP,
                                       rung.SPAWN_CAP + n_elements, rung.N_SAMP * 8 // 5)
    si[rung.SPAWN_CAP:] = True
    dead = torch.nonzero(a.vals[0, :int(a.n_used[0])] == 0)[:150, 0]
    keep[dead] = True
    return with_rows(a, 2), sk, sv, si, keep


def one_key_stress(a, sk):
    """``sk`` with its first :data:`STRESS_SPAWNS` spawns on one key, the
    arena row of largest origin value: a run far longer than the main path's
    (~100), as early iterations send to HF."""
    n = int(a.n_used[0])
    sk = sk.clone()
    sk[:STRESS_SPAWNS] = a.keys[int(a.vals[0, :n].abs().argmax())]
    return sk


def check_merge(label, a, sk, sv, si, layout, keep, exact=False):
    """Kernel A against its plain version; ``layout`` None takes the arena's
    value rows as they are, in the power step's (2, 0, 1) layout, or in
    FCIQMC's (1, 0, 0) for a one-row arena."""
    from fries_tpu_torch.runtime import merge

    if layout is None:
        origin, dest = 0, min(1, a.n_vecs - 1)
    else:
        n_vecs, origin, dest = layout
        a = with_rows(a, n_vecs)
    out = compare_merges(f"merge {label}",
                         merge.accumulate(a, sk, sv, si, origin, dest, keep_mask=keep),
                         merge.accumulate_plain(a, sk, sv, si, origin, dest, keep), exact)
    log(f"merge {label}: agrees ({json.dumps(out)})")
    return out


def phase_merge(dev):
    """Kernel A's cases; returns the rung case's check."""
    import torch
    from fries_tpu_torch.runtime import arena as ar

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    a, sk, sv, si, keep = rung_merge_case(gen, dev)
    res = check_merge("rung layout (2,0,1) + keep_mask", a, sk, sv, si, (2, 0, 1), keep)
    check_merge("rung layout (1,0,0)", a, sk, sv, si, (1, 0, 0), None)
    check_merge("rung, 200,000 spawns on one key, (2,0,1) + keep_mask", a,
                one_key_stress(a, sk), sv, si, (2, 0, 1), keep)
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
    gen.manual_seed(7)
    a, sk, sv, si = frifull_chunk_case(gen, dev)
    chunk = check_merge(f"exact-H chunk regime, made-up stream (C={a.capacity}, "
                        f"W={a.n_words}, S={sk.shape[0]}), no keep mask, non-zero dest row",
                        a, sk, sv, si, None, None)
    if chunk["n_out"] <= int(a.n_used[0]):
        raise AssertionError("merge exact-H chunk case inserted no key")
    return {"rung": res, "chunk_regime": chunk}


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------

def multi_inputs(gen, dev, capacity, n_occ, n_spawn, n_universe, n_rows, **kw):
    """merge_inputs' arena and spawns with ``n_rows`` value rows (a quarter
    of the entries zero) and a random destination row per spawn."""
    import torch
    from fries_tpu_torch.runtime import arena as ar

    a, sk, sv, si, _ = merge_inputs(gen, dev, capacity, n_occ, n_spawn, n_universe,
                                    n_vecs=1, **kw)
    vals = torch.randn((n_rows, capacity), generator=gen, device=dev, dtype=torch.float64)
    vals[torch.rand((n_rows, capacity), generator=gen, device=dev) < 0.25] = 0.0
    vals[:, int(a.n_used[0]):] = 0.0
    sr = torch.randint(0, n_rows, (n_spawn,), generator=gen, device=dev, dtype=torch.int32)
    return ar.Arena(keys=a.keys, vals=vals, n_used=a.n_used), sk, sv, sr, si


def subspace_multi_case(gen, dev):
    """Kernel C's case at the subspace path's shapes: (label, arena, spawn
    keys, values, destination rows, initiator flags)."""
    from fries_tpu_torch import rung

    cfg = rung.subspace_config()
    s = cfg.n_trial * cfg.spawn_cap
    return (f"subspace shapes (C={cfg.capacity}, R={cfg.n_trial}, S={s})",
            *multi_inputs(gen, dev, cfg.capacity, 2 * cfg.vec_nonz, s, 4 * cfg.vec_nonz,
                          cfg.n_trial))


def check_merge_multi(label, a, sk, sv, sr, si):
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import merge_multi

    out = compare_merges(f"merge_multi {label}", merge_multi.accumulate(a, sk, sv, sr, si),
                         ar.accumulate_multi(a, sk, sv, sr, si))
    log(f"merge_multi {label}: agrees ({json.dumps(out)})")
    return out


def phase_merge_multi(dev):
    """Kernel C's cases; returns the subspace case's check."""
    import torch
    from fries_tpu_torch.runtime import arena as ar

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    label, ma, msk, msv, msr, msi = subspace_multi_case(gen, dev)
    res = check_merge_multi(label, ma, msk, msv, msr, msi)
    check_merge_multi("subspace shapes, 200,000 spawns on one key", ma,
                      one_key_stress(ma, msk), msv, msr, msi)
    check_merge_multi("R=14 (C=2^16, S=100,000)",
                      *multi_inputs(gen, dev, 1 << 16, 20000, 100000, 40000, 14))
    for w in (1, 2):
        check_merge_multi(f"small W={w} R=3",
                          *multi_inputs(gen, dev, 1024, 400, 700, 800, 3, n_words=w))
    check_merge_multi("empty spawns",
                      *multi_inputs(gen, dev, 128, 40, 32, 64, 2, invalid_frac=1.0))
    e = ar.make(128, 2, 2, device=dev)
    check_merge_multi("empty arena", e,
                      torch.randint(0, 1 << 16, (64, 2), generator=gen, device=dev),
                      torch.randn(64, generator=gen, device=dev, dtype=torch.float64),
                      torch.randint(0, 2, (64,), generator=gen, device=dev, dtype=torch.int32),
                      torch.ones(64, dtype=torch.bool, device=dev))
    o = check_merge_multi("overflow", *multi_inputs(gen, dev, 64, 60, 200, 400, 3,
                                                    ini_frac=1.0, invalid_frac=0.0))
    if not o["overflow"]:
        raise AssertionError("merge_multi overflow case did not overflow")
    return res


# ---------------------------------------------------------------------------
# kernels A and C on 128-bit keys (W = 3, 4)
# ---------------------------------------------------------------------------

def ne_qz_merge_case(gen, dev, n_words=4, invalid_frac=0.1):
    """Kernel A's made-up case at ne_qz's shapes (C = 2^20, S = 532,768):
    (arena, spawn keys, values, initiator flags, keep mask)."""
    from fries_tpu_torch import rung

    return merge_inputs(gen, dev, rung.NE_QZ_CAPACITY, rung.NE_QZ_SAMP, rung.NE_QZ_SPAWN_CAP,
                        rung.NE_QZ_SAMP * 8 // 5, n_words=n_words, invalid_frac=invalid_frac)


def ne_qz_subsp_multi_case(gen, dev, n_words=4, invalid_frac=0.1):
    """Kernel C's made-up case at ne_qz_subsp's shapes (C = 2^20, R = 2,
    S = 600,000): (arena, spawn keys, values, destination rows, flags)."""
    from fries_tpu_torch import rung

    cfg = rung.subspace_config()
    return multi_inputs(gen, dev, cfg.capacity, 2 * cfg.vec_nonz, cfg.n_trial * cfg.spawn_cap,
                        4 * cfg.vec_nonz, cfg.n_trial, n_words=n_words,
                        invalid_frac=invalid_frac)


def check_merges_at_width(gen, dev, w, res):
    """Kernels A and C at ``w`` words against their plain versions: made-up
    streams at ne_qz's shapes (kernel A, layouts (2, 0, 1) with a keep mask
    and (1, 0, 0)) and ne_qz_subsp's (kernel C), each also with 200,000
    spawns on one key and with 90% of the stream sentinel rows; and the
    overflow, empty-arena and empty-spawn cases.  Adds the checks at the
    main paths' shapes to ``res``."""
    import torch
    from fries_tpu_torch.runtime import arena as ar

    a, sk, sv, si, keep = ne_qz_merge_case(gen, dev, w)
    shapes = f"W={w}, ne_qz shapes (C={a.capacity}, S={sk.shape[0]})"
    res[f"merge W={w}"] = check_merge(f"{shapes} (2,0,1) + keep_mask", a, sk, sv, si,
                                      (2, 0, 1), keep)
    check_merge(f"{shapes} (1,0,0)", a, sk, sv, si, (1, 0, 0), None)
    check_merge(f"{shapes}, 200,000 spawns on one key", a, one_key_stress(a, sk), sv, si,
                (2, 0, 1), keep)
    check_merge(f"{shapes}, 90% sentinel spawns",
                *ne_qz_merge_case(gen, dev, w, invalid_frac=0.9)[:4], (2, 0, 1), None)
    a, sk, sv, si, keep = merge_inputs(gen, dev, 128, 40, 32, 64, n_words=w,
                                       invalid_frac=1.0)
    check_merge(f"W={w} empty spawns", a, sk, sv, si, (2, 0, 1), keep)
    a, sk, sv, si, _ = merge_inputs(gen, dev, 128, 40, 64, 128, n_words=w)
    check_merge(f"W={w} empty arena", ar.make(128, w, 1, device=dev), sk, sv,
                torch.ones_like(si), (1, 0, 0), None)
    a, sk, sv, si, keep = merge_inputs(gen, dev, 64, 60, 200, 400, n_words=w,
                                       ini_frac=1.0, invalid_frac=0.0)
    if not check_merge(f"W={w} overflow", a, sk, sv, si, (2, 0, 1), keep)["overflow"]:
        raise AssertionError(f"merge W={w} overflow case did not overflow")

    ma, msk, msv, msr, msi = ne_qz_subsp_multi_case(gen, dev, w)
    shapes = f"W={w}, ne_qz_subsp shapes (C={ma.capacity}, R=2, S={msk.shape[0]})"
    res[f"merge_multi W={w}"] = check_merge_multi(shapes, ma, msk, msv, msr, msi)
    check_merge_multi(f"{shapes}, 200,000 spawns on one key", ma, one_key_stress(ma, msk),
                      msv, msr, msi)
    check_merge_multi(f"{shapes}, 90% sentinel spawns",
                      *ne_qz_subsp_multi_case(gen, dev, w, invalid_frac=0.9))
    check_merge_multi(f"W={w} empty spawns",
                      *multi_inputs(gen, dev, 128, 40, 32, 64, 2, n_words=w,
                                    invalid_frac=1.0))
    _, esk, esv, esr, esi = multi_inputs(gen, dev, 128, 40, 64, 128, 2, n_words=w)
    check_merge_multi(f"W={w} empty arena", ar.make(128, w, 2, device=dev), esk, esv, esr,
                      torch.ones_like(esi))
    o = check_merge_multi(f"W={w} overflow",
                          *multi_inputs(gen, dev, 64, 60, 200, 400, 3, n_words=w,
                                        ini_frac=1.0, invalid_frac=0.0))
    if not o["overflow"]:
        raise AssertionError(f"merge_multi W={w} overflow case did not overflow")


def phase_merge_wide(dev):
    """Kernels A and C on 128-bit keys, W = 3 and 4, against their plain
    versions (:func:`check_merges_at_width`; keys differing only in the low
    word or only above the 64-bit boundary, :func:`wide_universe`).  Kernel
    A's first case also runs at W = 2, the width it is timed against
    (:func:`phase_timings`, the same seeds).  Returns the checks at the
    main paths' shapes."""
    import torch

    gen = torch.Generator(device=dev)
    res = {}
    gen.manual_seed(92)
    a, sk, sv, si, keep = ne_qz_merge_case(gen, dev, 2)
    res["merge W=2"] = check_merge(f"W=2, ne_qz shapes (C={a.capacity}, S={sk.shape[0]}) "
                                   "(2,0,1) + keep_mask", a, sk, sv, si, (2, 0, 1), keep)
    for w in (3, 4):
        gen.manual_seed(90 + w)
        check_merges_at_width(gen, dev, w, res)
    return res


WIDER_WORDS = (5, 6, 7, 8, 16)
WIDER_MULTI_TIMED = (7, 16)


def phase_merge_wider(dev):
    """Kernels A and C on 64-bit limb keys, W = 5, 6, 7, 8 and 16 (L = 3, 3,
    4, 4 and 8 limbs), against their plain versions
    (:func:`check_merges_at_width`; keys differing only in the low word,
    only in the top word, alone in its limb at odd W, or only in the two
    words around a limb boundary).  Returns the checks at the main paths'
    shapes."""
    import torch

    gen = torch.Generator(device=dev)
    res = {}
    for w in WIDER_WORDS:
        gen.manual_seed(90 + w)
        check_merges_at_width(gen, dev, w, res)
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


def factored_plan(gen, dev, n, e_k, v_k, n_samp, out_size, uniform_frac, kill,
                  heavy_frac=1e-3, heavy=1000.0):
    """comp_sub_factored's plan over random parents (heavy ones among them,
    as in :func:`emission_plan`) and f32 factor rows, chunked over rows as
    the frisys driver chunks it."""
    import torch
    from fries_tpu_torch import compress

    r = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=torch.float64)
    values = torch.where(r(n) < 0.8, -torch.log(r(n)), 0.0)
    values = torch.where(r(n) < heavy_frac, heavy * values, values)
    fa = r(n, e_k) * (r(n, e_k) < 0.8) + 1e-6
    fb = r(n, v_k) + 1e-3
    ndiv = torch.where(r(n) < uniform_frac,
                       torch.randint(1, 17, (n,), generator=gen, device=dev), 0)
    plan, _ = compress.comp_sub_factored_plan(
        values, ndiv, (fa / fa.sum(1, keepdim=True)).float(),
        (fb / fb.sum(1, keepdim=True)).float(), n_samp, float(r(())), out_size,
        kill_b0=(r(n, e_k) < 0.4) if kill else None, row_chunk=1 << 18)
    return plan


def emit_bound(plan, parent, sub):
    """Kernel B's bound on this run's data (``parent`` and ``sub``: its
    output): offsets for every parent; for each parent with a slot its other
    scalars (25 B weighted: kept_counts, g_start, uniform, cum_parent; 49 B
    uniform, with ndiv, parent_rem and u_val); for each weighted one the
    columns its walk reaches, up to its last emitted sub (dense: one value
    each; factored: the fa, fb and kill entries of those columns); 24 B per
    output slot.  Ops: per column walked, the keep test and the prefix add
    (and the factored product)."""
    import torch

    n = plan["offsets"].shape[0]
    live = parent >= 0
    last = torch.full((n,), -1, dtype=torch.int64, device=parent.device)
    last.scatter_reduce_(0, parent[live], sub[live], "amax")
    has, uni = last >= 0, plan["uniform"]
    cols = (last + 1)[has & ~uni]
    if "fa" in plan:
        v_k, elem = plan["fb"].shape[1], plan["fa"].element_size()
        n_fa = int(((cols - 1) // v_k + 1).sum())
        row = elem * (n_fa + int(cols.clamp_max(v_k).sum())) + (
            0 if plan["kill_b0"] is None else n_fa)
        ops_per_col = 3
    else:
        row = plan["w_sub"].element_size() * int(cols.sum())
        ops_per_col = 2
    n_bytes = (8 * n + 25 * int((has & ~uni).sum()) + 49 * int((has & uni).sum())
               + row + 24 * plan["out_size"])
    return bound(n_bytes, ops_per_col * int(cols.sum()))


def emit_pair(plan):
    """Kernel B's wrapper and its plain version for ``plan``'s row source."""
    from fries_tpu_torch.runtime import emit

    return ((emit.emit_factored, emit.emit_factored_plain) if "fa" in plan
            else (emit.emit, emit.emit_plain))


def check_emit(label, plan, need_kept=True):
    import torch

    kernel, plain = emit_pair(plan)
    gv, gp, gs = kernel(**plan)
    rv, rp, rs = plain(**plan)
    torch.cuda.synchronize()
    if not torch.equal(gp, rp):
        raise AssertionError(f"emit {label}: parents differ")
    live = rp >= 0
    r = torch.arange(rp.shape[0], device=rp.device) - plan["offsets"][rp.clamp_min(0)]
    kept = live & (r < plan["kept_counts"][rp.clamp_min(0)])
    if need_kept and not bool(kept.any()):
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
    log(f"emit {label}: agrees ({json.dumps(out)})")
    return out


def step_emissions(dev):
    """The three emissions of one frisys step at the rung's shapes, as
    {name: (label, plan)}: A+B weighted, E mixed, C+D without the kill mask
    as the rung runs it.  Each draws from a generator of its own seed."""
    import torch
    from fries_tpu_torch import rung

    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    n, cap, m = rung.N_SAMP, rung.CAPACITY, rung.SPAWN_CAP
    return {
        "A+B": ("A+B shapes (N=2^21, K=28), weighted",
                emission_plan(gen(2), dev, cap, 28, n, m, 0.0)),
        "E": ("level E shapes (N=1,032,768, K=7), mixed",
              emission_plan(gen(4), dev, m, 7, n, m, 0.5)),
        "C+D": ("C+D shapes (N=1,032,768, E=14, V=21), factored, 30% uniform",
                factored_plan(gen(5), dev, m, 14, 21, n, m, 0.3, False)),
    }


def phase_emit(dev):
    """Kernel B's cases; returns the check of each of the three shapes of one
    frisys step (:func:`step_emissions`)."""
    import torch
    from fries_tpu_torch import rung

    res = {name: check_emit(label, plan)
           for name, (label, plan) in step_emissions(dev).items()}
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    n, cap, m = rung.N_SAMP, rung.CAPACITY, rung.SPAWN_CAP
    check_emit("A+B shapes, 30% uniform parents",
               emission_plan(gen(3), dev, cap, 28, n, m, 0.3))
    check_emit("C+D shapes, factored with kill_b0",
               factored_plan(gen(6), dev, m, 14, 21, n, m, 0.3, True))
    return res


# ---------------------------------------------------------------------------
# kernel F: the factored C+D plan's reductions
# ---------------------------------------------------------------------------

PLAN_SHAPES = {   # name: (N, E, V, n_samp), the benchmark cells' C+D rounds
    "n2_ccpvdz_synth.fri_1m": (1_032_768, 10, 21, 1_000_000),
    "ne_ccpvqz_synth.fri_500k": (532_768, 8, 50, 500_000),
}


def plan_inputs(gen, dev, n, e_k, v_k, uniform_frac=0.1, heavy_frac=1e-3, heavy=1000.0):
    """comp_sub_factored's inputs over random parents (heavy ones among them)
    and f32 factor rows: (values, ndiv, fac_a, fac_b)."""
    import torch

    r = lambda *s: torch.rand(*s, generator=gen, device=dev, dtype=torch.float64)
    values = torch.where(r(n) < 0.8, -torch.log(r(n)), 0.0)
    values = torch.where(r(n) < heavy_frac, heavy * values, values)
    fa = r(n, e_k) * (r(n, e_k) < 0.8) + 1e-6
    fb = r(n, v_k) + 1e-3
    ndiv = torch.where(r(n) < uniform_frac,
                       torch.randint(1, 17, (n,), generator=gen, device=dev), 0)
    return (values, ndiv, (fa / fa.sum(1, keepdim=True)).float(),
            (fb / fb.sum(1, keepdim=True)).float())


def plain_plan_targets():
    """Kernel F's dispatchers replaced by the plain version, which runs on
    card tensors as they are (for the comparison only)."""
    from fries_tpu_torch.runtime import plan

    return [(plan, name, lambda _, f=getattr(plan, name + "_plain"): f)
            for name in ("total", "seed", "counts", "parents")]


def plain_plan():
    return patched(*plain_plan_targets())


def phase_plan(dev):
    """Kernel F at the benchmark cells' C+D shapes (f32 stage, no kill bits,
    as their rounds run): every mode against its plain version on the card
    (at the frisys driver's row chunk), call and device times of both and
    the bound; then the whole plan, ``comp_sub_factored_plan``, with the
    kernel and with the plain version (R + 3 launches for R fixpoint rounds
    asserted)."""
    import torch
    from fries_tpu_torch import compress, profiling
    from fries_tpu_torch.runtime import plan

    res = {}
    for name, (n, e_k, v_k, n_samp) in PLAN_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(20)
        values, ndiv, fac_a, fac_b = plan_inputs(gen, dev, n, e_k, v_k)
        chunk = (256_000_000 // (e_k * v_k * 4)) // 8192 * 8192   # drivers/frisys.py
        out_size = n_samp + 32_768
        whole = lambda: compress.comp_sub_factored_plan(values, ndiv, fac_a, fac_b, n_samp, 0.37,
                                                        out_size, row_chunk=chunk)
        launches, reads = profiling.total("launch.plan"), profiling.total("fixpoint.comp_sub")
        p, _ = whole()
        torch.cuda.synchronize()
        rounds = profiling.total("fixpoint.comp_sub") - reads
        if profiling.total("launch.plan") - launches != rounds + 3:
            raise AssertionError(f"plan {name}: {profiling.total('launch.plan') - launches} "
                                 f"launches for {rounds} rounds")
        with plain_plan():
            q, _ = whole()
        # the two plans' f64 sums differ in their order, so their thresholds
        # may differ in the last bits: reported, each mode checked below at
        # one threshold
        out = {"rounds": rounds, "total": int(p["total"]), "kept": int(p["kept_counts"].sum()),
               "thr_rel_to_plain": abs(float(p["thr"]) / float(q["thr"]) - 1.0),
               "kept_counts_equal_plain": torch.equal(p["kept_counts"], q["kept_counts"]),
               "total_equal_plain": torch.equal(p["total"], q["total"])}
        fa, fb, thr = p["fa"], p["fb"], p["thr"]
        w_floor = p["w_floor"].float()
        w_uni = torch.where(p["uniform"], values, 0.0)
        uni = (w_uni / ndiv.clamp_min(1).to(torch.float64), w_uni, ndiv)
        edges = compress._seed_edges(plan.total_plain(fa, fb, None, chunk), n_samp)
        modes = {
            "total": ((plan.TOTAL, {}), lambda: (plan.total_plain(fa, fb, None, chunk),)),
            "seed": ((plan.SEED, {"uni": uni, "edges": edges}),
                     lambda: plan.seed_plain(fa, fb, None, uni, edges, chunk)),
            "counts": ((plan.COUNTS, {"uni": uni, "w_floor": w_floor, "thr": thr}),
                       lambda: plan.counts_plain(fa, fb, None, uni, w_floor, thr, chunk)),
            "parents": ((plan.PARENTS, {"w_floor": w_floor, "thr": thr}),
                        lambda: plan.parents_plain(fa, fb, None, w_floor, thr, chunk)),
        }
        factor_bytes = n * (e_k + v_k) * fa.element_size()
        for mode_name, ((mode, kw), plain_fn) in modes.items():
            kernel_fn = lambda m=mode, k=kw: plan.launch(m, fa, fb, None, **k)
            got = kernel_fn()
            got = got if isinstance(got, tuple) else (got,)
            errs = []
            for i, (g, r) in enumerate(zip(got, plain_fn())):
                if g.dtype == torch.int64 or (mode == plan.SEED and i == 1):
                    if not torch.equal(g, r.to(g.dtype)):
                        raise AssertionError(f"plan {name} {mode_name}: counts differ")
                else:
                    rel = float(((g - r).abs() / r.abs().clamp_min(1e-300)).max())
                    if rel > (1e-6 if mode == plan.SEED else 1e-12):
                        raise AssertionError(f"plan {name} {mode_name}: sums differ ({rel})")
                    errs.append(rel)
            ops = n * e_k * v_k * (1 + compress._SEED_EDGES if mode == plan.SEED else 1)
            row_bytes = {plan.SEED: 24, plan.COUNTS: 24, plan.PARENTS: 16}.get(mode, 0)
            out[mode_name] = {"max_rel_err": max(errs, default=0.0), "ms": cuda_ms(kernel_fn),
                              "plain_ms": cuda_ms(plain_fn),
                              **bound(factor_bytes + row_bytes * n, ops)}
        out["plan_ms"] = cuda_ms(whole)
        with plain_plan():
            out["plan_plain_ms"] = cuda_ms(whole)
        for mode_name, ((mode, kw), plain_fn) in modes.items():
            ms, ops, _ = device_profile(lambda m=mode, k=kw: plan.launch(m, fa, fb, None, **k))
            out[mode_name].update(device_ms=ms, device_ops=ops,
                                  plain_device_ms=device_profile(plain_fn)[0])
        out["plan_device_ms"], out["plan_device_ops"], _ = device_profile(whole)
        with plain_plan():
            out["plan_plain_device_ms"], out["plan_plain_device_ops"], _ = device_profile(whole)
        log(f"plan {name} (N={n}, E={e_k}, V={v_k}): {json.dumps(out)}")
        res[name] = out
        del values, ndiv, fac_a, fac_b, p, q, fa, fb, uni, w_uni
        gc.collect()
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# kernel #6: the probe relayout
# ---------------------------------------------------------------------------

def probe_tile(dev):
    """A random (8, 128) int32 tile."""
    import torch
    from fries_tpu_torch import probe_reshape as probe_mod

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    return torch.randint(-2**31, 2**31 - 1, (probe_mod.RB, probe_mod.LANES), generator=gen,
                         dtype=torch.int32, device=dev)


def phase_probe(dev):
    """Kernel #6 on a random tile, then its entry point with the count reset
    just before it (the launches it reports)."""
    import torch
    from fries_tpu_torch import probe_reshape as probe_mod

    x = probe_tile(dev)
    got, ref = probe_mod.reshape(x), probe_mod.reshape_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("probe_reshape: kernel and plain version differ")
    out = {"max_abs_err": float((got.long() - ref.long()).abs().max())}
    reset_launches(probe_mod)
    if probe_mod.main([]) != 0:
        raise AssertionError("probe_reshape: the probe's column is wrong")
    out["launches"] = kernel_launches(probe_mod)
    if out["launches"] < 1:
        raise AssertionError("probe_reshape: the entry point did not launch the kernel")
    log(f"probe_reshape: agrees ({json.dumps(out)})")
    return out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

SMALL_SYMM = (0, 1, 0, 1, 0, 1, 2, 3)


def small_system(device=None):
    """The small molecular system of the card-against-CPU checks (8
    orbitals, 4 electrons)."""
    import numpy as np
    from fries_tpu_torch import synth

    return synth.make_system(8, 4, symm=np.array(SMALL_SYMM), seed=3, device=device)


def small_steps_match(label, dev, build, n_warm, n_steps, kernel_counts, protected=False):
    """A small system stepped on the card and on the CPU (plain versions)
    from the same state with the same uniforms: keys exact, values and
    metrics within rtol 1e-10.  ``build(device)`` gives a power iteration's
    (step, run_steps, state, aux) on ``device``; ``kernel_counts`` maps a
    wrapper module to the launches it must count per step."""
    import numpy as np
    import torch
    from fries_tpu_torch.drivers import power
    from fries_tpu_torch.runtime import arena as ar

    step_c, run_c, state, aux_c = build(torch.device("cpu"))
    step_g, _, _, aux_g = build(dev)
    args = lambda aux: (aux["num_keys"], aux["num_vals"], aux["den_keys"],
                        aux["den_vals"], aux["ref_key"])
    kw = lambda aux: {"protected_keys": aux["protected_keys"]} if protected else {}
    state, _ = run_c(state, *args(aux_c), n_warm, **kw(aux_c))
    rng = np.random.default_rng(0)
    before = {mod: kernel_launches(mod) for mod in kernel_counts}
    for it in range(n_steps):
        rns, rn = rng.random(6), float(rng.random())
        a = state.arena
        g_state = power.PowerState(
            ar.Arena(a.keys.to(dev), a.vals.to(dev), a.n_used.to(dev)),
            state.en_shift.to(dev), state.last_norm.to(dev), state.iterat,
            state.generator)
        state, mc = step_c(state, *args(aux_c), rns=rns, rn_vec=rn, **kw(aux_c))
        g_state, mg = step_g(g_state, *args(aux_g), rns=rns, rn_vec=rn, **kw(aux_g))
        if not torch.equal(g_state.arena.keys.cpu(), state.arena.keys):
            raise AssertionError(f"{label} step {it}: card and CPU keys differ")
        if not torch.allclose(g_state.arena.vals.cpu(), state.arena.vals,
                              rtol=1e-10, atol=1e-12):
            raise AssertionError(f"{label} step {it}: card and CPU values differ")
        for k in mc:
            if not np.isclose(float(mg[k]), float(mc[k]), rtol=1e-10, atol=1e-12):
                raise AssertionError(f"{label} step {it}: metric {k} differs")
        if bool(mc["overflow"]):
            raise AssertionError(f"{label} step {it}: overflow")
    for mod, per_step in kernel_counts.items():
        if kernel_launches(mod) - before[mod] != per_step * n_steps:
            raise AssertionError(f"{label}: {mod.__name__} counted "
                                 f"{kernel_launches(mod) - before[mod]} launches in "
                                 f"{n_steps} steps")
    log(f"{label}: {n_steps} steps on the card match the CPU plain path "
        f"(n_dets {int(mc['n_dets'])}, shift {float(mc['shift']):.4f})")


def phase_small_step(dev):
    """The frisys step at a small size, card against CPU."""
    from fries_tpu_torch.drivers import frisys
    from fries_tpu_torch.runtime import emit, merge

    cfg = frisys.FrisysConfig(eps=0.02, vec_nonz=60, matr_samp=150, capacity=256,
                              spawn_cap=200, target_norm=200.0, shift_interval=2)
    small_steps_match("small system", dev, lambda d: frisys.build(small_system(d), cfg, seed=4),
                      20, 3, {merge: 1, emit: 3})


def phase_small_options(dev):
    """The semistochastic step (a protected deterministic space of 8) and the
    even-sector step at a small size, card against CPU."""
    import dataclasses

    from fries_tpu_torch import rung
    from fries_tpu_torch.drivers import frisys
    from fries_tpu_torch.runtime import emit, merge

    cfg = frisys.FrisysConfig(eps=0.02, vec_nonz=60, matr_samp=700, capacity=256,
                              spawn_cap=400, target_norm=110.0, shift_interval=2)
    space = rung.determ_space(small_system(), 8)
    small_steps_match("small semistochastic system", dev,
                      lambda d: frisys.build(small_system(d), cfg, seed=4, determ_keys=space),
                      20, 4, {merge: 1, emit: 3}, protected=True)
    tr_cfg = dataclasses.replace(cfg, spin_parity=1)
    small_steps_match("small system, even time-reversal sector", dev,
                      lambda d: frisys.build(small_system(d), tr_cfg, seed=4), 20, 4,
                      {merge: 1, emit: 3})


def phase_small_frifull(dev):
    """The chunked exact-H step at a small size (8 chunks of 32 rows), card
    against CPU: without and with the dedup, and in the even sector."""
    from fries_tpu_torch.drivers import frifull, power
    from fries_tpu_torch.runtime import merge

    for label, dedup_cap, parity in (("chunked", 0, 0), ("chunked, dedup", 4096, 0),
                                     ("chunked, dedup, even sector", 4096, 1)):
        cfg = power.PowerConfig(eps=0.02, target_nonz=60, capacity=512, target_norm=110.0,
                                shift_interval=2, init_thresh=1.0, batch=32, spawn_rows=256,
                                dedup_cap=dedup_cap)
        small_steps_match(f"small exact-H system ({label})", dev,
                          lambda d: frifull.build(small_system(d), cfg, seed=4,
                                                  spin_parity=parity),
                          12, 4, {merge: 8})


def longest_spawn_segment(spawn, state):
    """Longest run of one target key in the sorted spawn stream of a step
    from ``state``."""
    import torch
    from fries_tpu_torch import dets, rung

    a = state.arena
    rns = torch.rand(6, dtype=torch.float64, device=a.device)
    words, amps, _ = spawn(a.keys, torch.where(a.valid, a.vals[0], 0.0), -rung.EPS, rns)
    (keys,), _, _ = dets.order_keys(words[amps != 0])
    keys = torch.sort(keys).values
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
    reset_launches(merge)
    reset_launches(emit)
    t0 = time.perf_counter()
    metrics = []
    with cd_plans() as seen:
        for _ in range(N_TIMED):
            state, m = step(state, *args)
            metrics.append(m)
        torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / N_TIMED
    launches = {"merge": kernel_launches(merge), "emit": kernel_launches(emit)}
    per_step = check_plan_launches("main path", seen, N_TIMED, 1)
    for i, m in enumerate(metrics):
        if bool(m["overflow"]):
            raise AssertionError(f"main path: overflow at timed step {i}")
        num, den = float(m["proj_num"]), float(m["proj_den"])
        if not (torch.isfinite(torch.tensor([num, den])).all() and den != 0):
            raise AssertionError(f"main path: non-finite estimator at step {i}")
    if launches["merge"] < N_TIMED or launches["emit"] < 3 * N_TIMED:
        raise AssertionError(f"main path did not run through the kernels: {launches}")
    last = metrics[-1]
    res = {
        "rung": "1e6", "ms_per_step": 1e3 * s_per_step,
        "sampled_nonzeros_per_s": n_samp / s_per_step,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": per_step, "n_dets": int(last["n_dets"]),
        "norm": float(last["norm"]),
        "e_corr_est": float(last["proj_num"]) / float(last["proj_den"]),
        "longest_spawn_segment": longest_spawn_segment(aux["spawn"], state),
    }
    log(f"main path: {json.dumps(res)}")
    return res


def subspace_steps_match(label, dev, cfg, n_warm=4, n_steps=4, system=None):
    """A small subspace system (``system(device)``, by default
    :func:`small_system`; HF and its single 1 -> 5 as trial vectors) stepped
    on the card and on the CPU from the same state with the same key tree:
    keys and counts exact, values and h / d within rtol 1e-10; one kernel C
    launch per iteration, or one per chunk (``n_merges``) with
    ``exact_h``."""
    import numpy as np
    import torch
    from fries_tpu_torch import dets, rng
    from fries_tpu_torch.drivers import subspace
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import merge_multi

    system = system or small_system
    ham = system()
    hf = dets.hf_det(ham.n_orb, ham.n_elec)
    d1, _ = dets.single_parity(hf[None], torch.tensor([1]), torch.tensor([5]))
    tk, tv = torch.stack([hf[None], d1]).numpy(), np.ones((2, 1))
    step_c, run_c, state, _ = subspace.build(ham, cfg, tk, tv, seed=4)
    step_g, _, _, _ = subspace.build(system(dev), cfg, tk, tv, seed=4)
    state, _ = run_c(state, n_warm)
    c0, merges = kernel_launches(merge_multi), 0
    for it in range(n_steps):
        a = state.arena
        g_state = subspace.SubspaceState(
            ar.Arena(a.keys.to(dev), a.vals.to(dev), a.n_used.to(dev)),
            state.norm_factors.to(dev), state.last_norms.to(dev), rng.KeyTree(4, dev),
            state.iterat)
        state, mc = step_c(state)
        g_state, mg = step_g(g_state)
        if not torch.equal(g_state.arena.keys.cpu(), state.arena.keys):
            raise AssertionError(f"{label} step {it}: card and CPU keys differ")
        if not torch.allclose(g_state.arena.vals.cpu(), state.arena.vals,
                              rtol=1e-10, atol=1e-12):
            raise AssertionError(f"{label} step {it}: card and CPU values differ")
        for k in mc:
            x, y = mg[k].cpu(), mc[k]
            same = (torch.allclose(x, y, rtol=1e-10, atol=1e-12) if y.is_floating_point()
                    else torch.equal(x, y))
            if not same:
                raise AssertionError(f"{label} step {it}: metric {k} differs")
        if bool(mc["overflow"]):
            raise AssertionError(f"{label} step {it}: overflow")
        merges += int(mc.get("n_merges", 1))
    if kernel_launches(merge_multi) - c0 != merges:
        raise AssertionError(f"{label}: {kernel_launches(merge_multi) - c0} kernel C launches, "
                             f"{merges} merges in {n_steps} iterations")
    log(f"{label}: {n_steps} steps on the card match the CPU plain path (n_dets "
        f"{int(mc['n_dets'][0])}), {merges} kernel C launches")
    return merges


def phase_subspace_small(dev):
    """The subspace step at a small size, card against CPU, across a restart
    and a norm-factor update (both at iterat 5), in the whole space and in
    the even time-reversal sector (``spin_parity = +1``: folded trial
    vectors, H * trial, diagonal and spawner)."""
    import torch
    from fries_tpu_torch import rng
    from fries_tpu_torch.drivers import subspace

    u_card = rng.KeyTree(11, dev).fold(3).uniform((1000,)).cpu()
    if not torch.equal(u_card, rng.KeyTree(11).fold(3).uniform((1000,))):
        raise AssertionError("key tree: card and CPU uniforms differ")
    for spin_parity in (0, 1):
        cfg = subspace.SubspaceConfig(eps=0.02, n_trial=2, vec_nonz=60, matr_samp=150,
                                      capacity=256, spawn_cap=200, restart_int=3,
                                      shift_interval=3, spin_parity=spin_parity)
        subspace_steps_match(f"subspace small (spin_parity {spin_parity})", dev, cfg)


def phase_subspace_modes_small(dev):
    """The subspace modes at a small size, card against CPU: ``lowmem``
    (also in the even sector), ``exact_h`` in chunks of 16 rows (at least 3
    kernel C launches per iteration) and ``compress_mode="multi"``."""
    from fries_tpu_torch.drivers import subspace

    base = dict(eps=0.02, n_trial=2, vec_nonz=60, matr_samp=150, capacity=512,
                spawn_cap=200, restart_int=3, shift_interval=3)
    for label, modes in (("lowmem", dict(lowmem=True)),
                         ("lowmem, even sector", dict(lowmem=True, spin_parity=1)),
                         ("exact_h, 16-row chunks", dict(exact_h=True, batch=16)),
                         ("multi", dict(compress_mode="multi"))):
        merges = subspace_steps_match(f"subspace small ({label})", dev,
                                      subspace.SubspaceConfig(**base, **modes))
        if modes.get("exact_h") and merges < 3 * 4:
            raise AssertionError(f"subspace small ({label}): {merges} merges in 4 steps")


def phase_subspace(dev):
    import torch
    from fries_tpu_torch import linalg, rung

    cfg = rung.subspace_config()
    t0 = time.perf_counter()
    step, state, aux = rung.build_subspace(dev)
    torch.cuda.synchronize()
    log(f"subspace: built in {time.perf_counter() - t0:.1f} s (23 orbitals, 10 "
        f"electrons, {cfg.n_trial} states, capacity {cfg.capacity}, spawn_cap "
        f"{cfg.spawn_cap} per state)")
    _, r = subspace_run("subspace", step, state, N_WARM, N_TIMED)
    last = r.pop("metrics")[-1]
    evals, _ = linalg.gen_eig(last["h_mat"].cpu().numpy(), last["d_mat"].cpu().numpy())
    res = {"config": "bench.py subsp",
           "sampled_nonzeros_per_s": cfg.n_trial * cfg.matr_samp / r.pop("s_per_step"), **r,
           "norms": last["norms"].tolist(),
           "eigenvalues_last_step": sorted(float(x) for x in evals.real), "e_ref": aux["e_ref"]}
    log(f"subspace: {json.dumps(res)}")
    return res


def wide_small_system(device=None):
    """The small four-word system of the card-against-CPU checks (50
    orbitals, 4 electrons, four irreps)."""
    import numpy as np
    from fries_tpu_torch import synth

    return synth.make_system(50, 4, symm=np.arange(50) % 4, seed=3, scale_two=0.1,
                             device=device)


def phase_small_wide(dev):
    """A small four-word frisys step and subspace step (across a restart),
    card against CPU from one state: the W = 4 merges, lookups and
    estimators."""
    from fries_tpu_torch.drivers import frisys, subspace
    from fries_tpu_torch.runtime import emit, merge

    cfg = frisys.FrisysConfig(eps=0.01, vec_nonz=400, matr_samp=2000, capacity=8192,
                              spawn_cap=2600, target_norm=2000.0, shift_interval=2)
    small_steps_match("small four-word system", dev,
                      lambda d: frisys.build(wide_small_system(d), cfg, seed=4), 3, 3,
                      {merge: 1, emit: 3})
    scfg = subspace.SubspaceConfig(eps=0.02, n_trial=2, vec_nonz=300, matr_samp=1500,
                                   capacity=8192, spawn_cap=2000, restart_int=3,
                                   shift_interval=3)
    subspace_steps_match("subspace small four-word system", dev, scfg, n_warm=1, n_steps=3,
                         system=wide_small_system)


def frisys_real_run(name, dev, built, cfg, n_timed, system, words):
    """``built`` = (step, state, est, aux) of a frisys configuration on a
    real system: 2 warm-up and ``n_timed`` timed steps with exactly 1 kernel
    A and 3 kernel B launches per step asserted (counts reset just before
    the timed steps); then a real step's merge input through kernel A and
    its plain version.  Returns the results and that input."""
    import torch
    from fries_tpu_torch.runtime import emit, merge

    step, state, args, aux = built
    state, _, _ = timed_block(step, state, args, N_WARM, f"{name} warm-up")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge, emit)
    with cd_plans() as seen:
        state, metrics, s_per_step = timed_block(step, state, args, n_timed, name)
    launches = {"merge": kernel_launches(merge), "emit": kernel_launches(emit)}
    if launches != {"merge": n_timed, "emit": 3 * n_timed}:
        raise AssertionError(f"{name}: launches {launches} in {n_timed} steps, not 1 "
                             "kernel A and 3 kernel B per step")
    per_step = check_plan_launches(name, seen, n_timed, 1)
    last = metrics[-1]
    r = {"config": name, "ms_per_step": 1e3 * s_per_step,
         "sampled_nonzeros_per_s": cfg.matr_samp / s_per_step,
         "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
         "launches_per_step": per_step,
         "n_dets_timed_steps": [int(m["n_dets"]) for m in metrics],
         "arena_rows": int(state.arena.n_used[0]), "norm": float(last["norm"]),
         "e_corr_est": float(last["proj_num"]) / float(last["proj_den"])}
    log(f"{name}: {json.dumps(r)}")
    rns = torch.rand(6, dtype=torch.float64, generator=state.generator).to(dev)
    case = power_merge_input(state, aux, cfg.eps, rns)
    r["real_step"] = {**merge_stream_stats(case[0], case[1]),
                      **check_merge(f"{name}, a real step's stream (W={words}, {system}), "
                                    "(2,0,1) + keep_mask", *case[:4], None, case[4])}
    log(f"{name} real step: {json.dumps(r['real_step'])}")
    return r, case


def phase_ne_qz(dev, ham):
    """The ``ne_qz`` configuration on real Ne/cc-pVQZ (``ham``, built on the
    card; 54 orbitals, four-word keys): 2 warm-up and 5 timed steps
    (:func:`frisys_real_run`) and its real merge checked; then the
    unnormalized run, 2 + 2 steps.  Returns the results and the merge
    input."""
    import torch
    from fries_tpu_torch import rung

    cfg = rung.ne_qz_config()
    res = {}
    for unnorm, n_timed in ((False, N_TIMED), (True, 2)):
        name = "ne_qz unnorm" if unnorm else "ne_qz"
        t0 = time.perf_counter()
        built = rung.build_ne_qz(dev, unnorm=unnorm, ham=ham)
        torch.cuda.synchronize()
        log(f"{name}: built in {time.perf_counter() - t0:.1f} s (real Ne/cc-pVQZ, 54 orbitals, "
            f"8 electrons, {built[3]['ref_key'].shape[0]} words, capacity {cfg.capacity}, "
            f"spawn_cap {cfg.spawn_cap})")
        res[name], c = frisys_real_run(name, dev, built, cfg, n_timed, "real Ne/cc-pVQZ", 4)
        if not unnorm:
            case = c
        del built, c
    return res, case


def subsp_real_run(name, dev, built, ham, words, system):
    """``built`` = (step, state, aux) of bench.py's subsp configuration on a
    real system (``ham``): 2 warm-up and 5 timed iterations, one kernel C
    launch per iteration asserted; then a real iteration's merge input
    through kernel C and its plain version.  Returns the results and that
    input."""
    from fries_tpu_torch import linalg, rung
    from fries_tpu_torch.runtime import arena as ar

    cfg = rung.subspace_config()
    step, state, aux = built
    state, r = subspace_run(name, step, state, N_WARM, N_TIMED)
    if r["launches"]["merge_multi"] != N_TIMED:
        raise AssertionError(f"{name}: {r['launches']} in {N_TIMED} iterations")
    last = r.pop("metrics")[-1]
    evals, _ = linalg.gen_eig(last["h_mat"].cpu().numpy(), last["d_mat"].cpu().numpy())
    r.update(config=name,
             sampled_nonzeros_per_s=cfg.n_trial * cfg.matr_samp / r.pop("s_per_step"),
             eigenvalues_last_step=sorted(float(x) for x in evals.real), e_ref=aux["e_ref"],
             single=list(rung.ne_qz_single(ham)))
    log(f"{name}: {json.dumps(r)}")
    captured, orig = [], ar.accumulate_multi_best

    def recording(*args):
        captured.append(args)
        return orig(*args)

    ar.accumulate_multi_best = recording
    try:
        step(state)
    finally:
        ar.accumulate_multi_best = orig
    case = captured[0]
    r["real_step"] = {**merge_stream_stats(case[0], case[1]),
                      **check_merge_multi(f"{name}, a real iteration's T streams (W={words}, "
                                          f"{system})", *case)}
    log(f"{name} real step: {json.dumps(r['real_step'])}")
    return r, case


def phase_ne_qz_subsp(dev, ham):
    """The ``ne_qz_subsp`` configuration on real Ne/cc-pVQZ (``ham``)
    (:func:`subsp_real_run`).  Returns the results and its real merge
    input."""
    import torch
    from fries_tpu_torch import rung

    cfg = rung.subspace_config()
    t0 = time.perf_counter()
    built = rung.build_ne_qz_subsp(dev, ham=ham)
    torch.cuda.synchronize()
    log(f"ne_qz_subsp: built in {time.perf_counter() - t0:.1f} s (real Ne/cc-pVQZ, 54 "
        f"orbitals, 8 electrons, trial vectors HF and the single {rung.ne_qz_single(ham)}, "
        f"capacity {cfg.capacity}, spawn_cap {cfg.spawn_cap} per state)")
    return subsp_real_run("ne_qz_subsp", dev, built, ham, 4, "real Ne/cc-pVQZ")


NE2_E_HF_REPEAT = 1e-9     # Ha: two builds on the card
NE2_MO_ENERGY_REPEAT = 1e-8
NE2_E_HF_DIMER = 1e-3      # Ha: |E_HF(Ne2) - 2 E_HF(Ne)| at 5.84 a0


def phase_ne2_qz(dev, e_ne):
    """Ne2/cc-pVQZ at full width (108 orbitals, 16 electrons, seven-word
    keys): built on the card twice, each stage timed with
    :class:`fries_tpu_torch.profiling.Timer` and the build's own seconds
    (one-electron, ERIs, SCF, MO transform), and the heat-bath setup (host
    numpy) timed inside each configuration's build.  The repeat against
    the first build: E_HF within 1e-9 Ha, orbital energies within 1e-8,
    irreps equal, and the MO integrals' rotation invariants (the Frobenius
    norms of hcore and of the ERIs over all orbitals) within rtol 1e-12;
    the integrals themselves after the gauge alignment are logged, not
    held: at 5.84 a0 the two atoms' d, f and g shells leave same-irrep
    orbitals 1e-7-1e-5 Ha apart, whose mixing the SCF's convergence fixes
    only to ~1e-7.  E_HF within 1e-3 Ha of twice Ne's ``e_ne``.  Then
    ``ne2_qz`` (:func:`frisys_real_run`, 2 + 5 steps) and ``ne2_qz_subsp``
    (:func:`subsp_real_run`, 2 + 5 iterations), each with its real W = 7
    merge through kernel A or C and its plain version.  Returns (results,
    ne2_qz's merge input, ne2_qz_subsp's)."""
    import torch
    from fries_tpu_torch import profiling, rung, scf
    from fries_tpu_torch.ops import heat_bath

    timer = profiling.Timer()
    builds = []
    for i in range(2):
        with timer.block(f"build {i}", sync=torch.zeros(1, device=dev)):
            builds.append(rung.ne2_qz_molecule(dev))
    (ham, info), (ham2, info2) = builds
    if ham.n_words != 7 or (ham.n_orb, ham.n_elec) != (108, 16):
        raise AssertionError(f"ne2_qz: {ham.n_orb} orbitals, {ham.n_elec} electrons, "
                             f"{ham.n_words} words")
    rel = lambda x, y: abs(float(torch.linalg.norm(x) / torch.linalg.norm(y)) - 1.0)
    repeat = {"e_hf": abs(info2["e_hf_total"] - info["e_hf_total"]),
              "mo_energy": float((info2["mo_energy"] - info["mo_energy"]).abs().max()),
              "irreps_equal": bool((info2["irreps"] == info["irreps"]).all()),
              "hcore_norm": rel(ham2.hcore, ham.hcore), "eris_norm": rel(ham2.eris, ham.eris)}
    o, repeat["aligned_off_block"] = scf.gauge_alignment(
        info2["C"], info["C"], info["S"], info["mo_energy"], info["irreps"])
    hcore, eris = scf.rotate_mo_integrals(ham2.hcore, ham2.eris, o)
    repeat["aligned_hcore"] = float((hcore - ham.hcore).abs().max())
    repeat["aligned_eris"] = float((eris - ham.eris).abs().max())
    del builds, ham2, info2, hcore, eris
    e_dimer = info["e_hf_total"] - 2 * e_ne
    if not (repeat["e_hf"] < NE2_E_HF_REPEAT and repeat["mo_energy"] < NE2_MO_ENERGY_REPEAT
            and repeat["irreps_equal"] and repeat["hcore_norm"] < 1e-12
            and repeat["eris_norm"] < 1e-12 and abs(e_dimer) < NE2_E_HF_DIMER
            and torch.isfinite(ham.eris).all()):
        raise AssertionError(f"ne2_qz: repeat {repeat}; E_HF - 2 E_HF(Ne) = {e_dimer}")
    hb_orig = heat_bath.setup

    def timed_setup(h):
        with timer.block("heat-bath setup"):
            return hb_orig(h)

    res = {"system": {
        "n_ao": int(info["C"].shape[0]), "n_orb": ham.n_orb, "n_elec": ham.n_elec,
        "n_words": ham.n_words, "e_hf_total": info["e_hf_total"],
        "e_hf_minus_twice_ne": e_dimer, "repeat": repeat,
        "seconds": dict(info["seconds"])}}
    heat_bath.setup = timed_setup
    try:
        cfg = rung.ne_qz_config()
        t0 = time.perf_counter()
        built = rung.build_ne2_qz(dev, ham=ham)
        torch.cuda.synchronize()
        log(f"ne2_qz: built in {time.perf_counter() - t0:.1f} s (Ne2/cc-pVQZ, 108 orbitals, "
            f"16 electrons, 7 words, capacity {cfg.capacity}, spawn_cap {cfg.spawn_cap})")
        res["ne2_qz"], case = frisys_real_run("ne2_qz", dev, built, cfg, N_TIMED,
                                              "Ne2/cc-pVQZ", 7)
        del built
        t0 = time.perf_counter()
        built = rung.build_ne2_qz_subsp(dev, ham=ham)
        torch.cuda.synchronize()
        log(f"ne2_qz_subsp: built in {time.perf_counter() - t0:.1f} s (trial vectors HF and "
            f"the single {rung.ne_qz_single(ham)})")
        res["ne2_qz_subsp"], sub_case = subsp_real_run("ne2_qz_subsp", dev, built, ham, 7,
                                                       "Ne2/cc-pVQZ")
        del built
    finally:
        heat_bath.setup = hb_orig
    res["system"]["timer"] = {k: {"s": timer.totals[k], "calls": timer.counts[k]}
                              for k in timer.totals}
    log(f"ne2_qz system: {json.dumps(res['system'])}")
    log("ne2_qz timer:\n" + timer.report())
    return res, case, sub_case


def check_power_metrics(label, metrics):
    import torch

    for i, m in enumerate(metrics):
        if bool(m["overflow"]):
            raise AssertionError(f"{label}: overflow at step {i}")
        num, den = float(m["proj_num"]), float(m["proj_den"])
        if not (torch.isfinite(torch.tensor([num, den])).all() and den != 0):
            raise AssertionError(f"{label}: non-finite estimator at step {i}")


def phase_semistoch(dev):
    """The ``semistoch`` configuration, then kernel A at its merge's shapes."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import emit, merge

    t0 = time.perf_counter()
    step, state, args, aux = rung.build_semistoch(dev)
    prot = aux["protected_keys"]
    torch.cuda.synchronize()
    n_el, n_det = aux["n_elements"], prot.shape[0]
    log(f"semistoch: built in {time.perf_counter() - t0:.1f} s (the 1e6 rung plus "
        f"{n_det} deterministic determinants of at most {rung.N_DETERM}, {n_el} dense "
        f"elements, sampling budget {rung.N_SAMP - n_el}, merge S = {rung.SPAWN_CAP + n_el})")
    if not 0 < n_el < rung.DETERM_MAX_SHARE * rung.N_SAMP:
        raise AssertionError(f"semistoch: dense block of {n_el} elements")
    for _ in range(N_WARM):
        state, m = step(state, *args, protected_keys=prot)
        check_power_metrics("semistoch warm-up", [m])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge)
    reset_launches(emit)
    t0 = time.perf_counter()
    metrics = []
    with cd_plans() as seen:
        for _ in range(N_TIMED):
            state, m = step(state, *args, protected_keys=prot)
            metrics.append(m)
        torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / N_TIMED
    launches = {"merge": kernel_launches(merge), "emit": kernel_launches(emit)}
    per_step = check_plan_launches("semistoch", seen, N_TIMED, 1)
    check_power_metrics("semistoch", metrics)
    if launches != {"merge": N_TIMED, "emit": 3 * N_TIMED}:
        raise AssertionError(f"semistoch did not run through the kernels: {launches}")
    if not bool(ar.lookup(state.arena, prot)[1].all()):
        raise AssertionError("semistoch: a protected determinant left the arena")
    last = metrics[-1]
    res = {
        "config": "semistoch", "n_determ": n_det, "n_elements": n_el,
        "ms_per_step": 1e3 * s_per_step,
        "sampled_nonzeros_per_s": (rung.N_SAMP - n_el) / s_per_step,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
        "launches_per_step": per_step,
        "n_dets": int(last["n_dets"]), "norm": float(last["norm"]),
        "e_corr_est": float(last["proj_num"]) / float(last["proj_den"]),
    }
    log(f"semistoch: {json.dumps(res)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    a, sk, sv, si, keep = semistoch_merge_case(gen, dev, n_el)
    res["merge_check"] = check_merge(
        f"semistoch shapes (C={a.capacity}, S={sk.shape[0]}), protected keep bits",
        a, sk, sv, si, None, keep)
    return res


def phase_frifull(dev):
    """bench.py's frifull configuration, one real chunk stream through the
    kernel and its plain version, and the dedup variant; returns the results
    and that chunk's (arena, spawn keys, values, initiator flags)."""
    import torch
    from fries_tpu_torch import dets, rung
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import merge

    cfg = rung.frifull_config()
    n_chunks = -(-cfg.spawn_rows // cfg.batch)
    t0 = time.perf_counter()
    step, state, args, aux = rung.build_frifull(dev)
    torch.cuda.synchronize()
    s_chunk = cfg.batch * aux["n_excitations"]
    log(f"frifull: built in {time.perf_counter() - t0:.1f} s (14 orbitals, 6 electrons, "
        f"capacity {cfg.capacity}, {n_chunks} chunks of {cfg.batch} rows, "
        f"{aux['n_excitations']} template excitations, S = {s_chunk} per chunk)")

    n_warm = nnonz = 0
    while n_warm < 6 or (nnonz < cfg.target_nonz and n_warm < 50):
        state, ms, _ = timed_block(step, state, args, 3, "frifull warm-up")
        n_warm += 3
        nnonz = int(ms[-1]["nnonz"])
        log("frifull warm-up: n_dets / nnonz per step "
            + ", ".join(f"{int(m['n_dets'])} / {int(m['nnonz'])}" for m in ms))
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge)
    state, metrics, s_per_step = timed_block(step, state, args, 3, "frifull")
    launches = kernel_launches(merge)
    if launches != 3 * n_chunks:
        raise AssertionError(f"frifull: {launches} kernel A launches in 3 steps, "
                             f"expected {3 * n_chunks}")
    last = metrics[-1]
    res = {
        "config": "bench.py frifull_mol (synthetic)", "ms_per_step": 1e3 * s_per_step,
        "warm_up_steps": n_warm, "merge_launches_per_step": launches // 3,
        "spawns_per_chunk": s_chunk, "candidates_per_s": n_chunks * s_chunk / s_per_step,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "n_dets_nnonz_timed_steps": [[int(m["n_dets"]), int(m["nnonz"])] for m in metrics],
        "norm": float(last["norm"]), "shift": float(last["shift"]),
        "e_corr_est": float(last["proj_num"]) / float(last["proj_den"]),
    }
    log(f"frifull: {json.dumps(res)}")

    # one real stream: chunk 1 merged into the arena that holds chunk 0's sums
    a = state.arena
    vals0 = torch.where(a.valid, a.vals[0], 0.0)
    sentinel = dets.invalid_det(a.n_words, dev)
    streams = []
    for i in range(2):
        rows = slice(i * cfg.batch, (i + 1) * cfg.batch)
        w, amp, ini = aux["spawn"](a.keys[rows], vals0[rows], -cfg.eps, None)
        streams.append((torch.where((amp != 0)[:, None], w, sentinel), amp, ini))
    mid, _ = merge.accumulate(a, *streams[0], 0, 1)
    skey = dets.pack_key(streams[1][0])
    valid = skey != dets.sentinel_key(a.n_words)
    runs = torch.unique_consecutive(torch.sort(skey[valid]).values, return_counts=True)[1]
    res["real_chunk"] = {
        "sentinel_share": 1.0 - float(valid.double().mean()),
        "longest_run": int(runs.max()), "unique_targets": int(runs.shape[0]),
        "arena_rows": int(mid.n_used[0]),
        "rows_with_sum_and_zero_origin": int(((mid.vals[0] == 0) & (mid.vals[1] != 0)).sum()),
        **check_merge("frifull, a real chunk's stream into the arena after chunk 0",
                      mid, *streams[1], None, None)}
    log(f"frifull real chunk: {json.dumps(res['real_chunk'])}")

    dedup_cap = 1 << 19
    step_d, _, _, _ = rung.build_frifull(dev, dedup_cap)
    state_d, _, _ = timed_block(step_d, state, args, 1, "frifull dedup warm-up")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge)
    state_d, metrics_d, s_dedup = timed_block(step_d, state_d, args, 2, "frifull dedup")
    res["dedup"] = {"dedup_cap": dedup_cap, "ms_per_step": 1e3 * s_dedup,
                    "merge_launches_per_step": kernel_launches(merge) // 2,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    "n_dets": int(metrics_d[-1]["n_dets"])}
    if kernel_launches(merge) != 2 * n_chunks:
        raise AssertionError(f"frifull dedup: {kernel_launches(merge)} kernel A launches "
                             "in 2 steps")
    log(f"frifull dedup: {json.dumps(res['dedup'])}")
    res["launches"] = {"merge": launches + kernel_launches(merge)}
    return res, (mid, *streams[1])


def fciqmc_steps_match(label, dev, cfg, n_warm, n_steps):
    """FCIQMC on a small system (8 orbitals, 4 electrons) stepped on the card
    and on the CPU from one state, both drawing from one key tree on the CPU
    (the card's draws moved there): keys, counts, flags, walker counts and
    integer values exact, fp values and the float metrics within rtol 1e-12;
    one kernel A launch per step."""
    import numpy as np
    import torch
    from fries_tpu_torch import rung, synth
    from fries_tpu_torch.drivers import fciqmc
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import merge

    symm = np.array(SMALL_SYMM)
    step_c, run_c, state, aux_c = fciqmc.build(synth.make_system(8, 4, symm=symm, seed=3),
                                               cfg, seed=4, init_walkers=300)
    step_g, _, _, aux_g = fciqmc.build(synth.make_system(8, 4, symm=symm, seed=3, device=dev),
                                       cfg, seed=4, init_walkers=300)
    args_c, args_g = rung.estimator_args(aux_c), rung.estimator_args(aux_g)
    state, _ = run_c(state, *args_c, n_warm)
    c0 = kernel_launches(merge)
    for it in range(n_steps):
        a = state.arena
        g_state = fciqmc.FciqmcState(
            ar.Arena(a.keys.to(dev), a.vals.to(dev), a.n_used.to(dev)),
            state.en_shift.to(dev), state.last_norm.to(dev), state.key, state.iterat)
        state, mc = step_c(state, *args_c)
        g_state, mg = step_g(g_state, *args_g)
        if not (torch.equal(g_state.arena.keys.cpu(), state.arena.keys)
                and torch.equal(g_state.arena.n_used.cpu(), state.arena.n_used)):
            raise AssertionError(f"{label} step {it}: card and CPU keys differ")
        gv = g_state.arena.vals.cpu()
        same = (torch.equal(gv, state.arena.vals) if cfg.integer_walkers
                else torch.allclose(gv, state.arena.vals, rtol=1e-12, atol=0))
        if not same:
            raise AssertionError(f"{label} step {it}: card and CPU values differ")
        for k in mc:
            x, y = float(mg[k]), float(mc[k])
            exact = k not in ("proj_num", "proj_den", "shift") and (
                cfg.integer_walkers or k != "norm")
            if (x != y) if exact else not np.isclose(x, y, rtol=1e-12, atol=0):
                raise AssertionError(f"{label} step {it}: metric {k} {x} != {y}")
        if bool(mc["overflow"]):
            raise AssertionError(f"{label} step {it}: overflow")
    if kernel_launches(merge) - c0 != n_steps:
        raise AssertionError(f"{label}: {kernel_launches(merge) - c0} kernel A launches in "
                             f"{n_steps} steps")
    log(f"{label}: {n_steps} steps on the card equal the CPU's (n_dets "
        f"{int(mc['n_dets'])}, norm {float(mc['norm'])}), 1 kernel A launch per step")


def phase_small_fciqmc(dev):
    """The FCIQMC step at a small size, card against CPU: near-uniform and
    heat-bath, integer and fp walkers, one with a spawn buffer."""
    from fries_tpu_torch.drivers import fciqmc

    for dist, integer, spawn_cap in (("NU", True, 0), ("NU", False, 0), ("HB", True, 1024),
                                     ("HB", False, 0)):
        cfg = fciqmc.FciqmcConfig(eps=0.02, target_walkers=600.0, capacity=256,
                                  attempt_cap=4096, init_thresh=2.0, distribution=dist,
                                  integer_walkers=integer, shift_damping=0.25,
                                  shift_interval=4, spawn_cap=spawn_cap)
        label = (f"small fciqmc ({dist}, {'integer' if integer else 'fp'} walkers"
                 + (f", spawn_cap {spawn_cap})" if spawn_cap else ")"))
        fciqmc_steps_match(label, dev, cfg, 20, 4)


def phase_small_frimulti(dev):
    """The frimulti step at a small size, card against CPU from one state
    with one key tree on the CPU: keys exact, values and metrics within
    rtol 1e-10, one kernel A launch per step."""
    import numpy as np
    import torch
    from fries_tpu_torch import synth
    from fries_tpu_torch.drivers import frimulti, power
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import merge

    symm = np.array(SMALL_SYMM)
    args = lambda aux: (aux["num_keys"], aux["num_vals"], aux["den_keys"], aux["den_vals"],
                        aux["ref_key"])
    for dist in ("NU", "HB"):
        label = f"small frimulti ({dist})"
        cfg = frimulti.FrimultiConfig(eps=0.02, vec_nonz=40, matr_samp=120, capacity=256,
                                      spawn_cap=200, init_thresh=0.5, target_norm=50.0,
                                      shift_interval=3, distribution=dist)
        step_c, run_c, state, aux_c = frimulti.build(
            synth.make_system(8, 4, symm=symm, seed=3), cfg, seed=4, init_val=30.0)
        step_g, _, _, aux_g = frimulti.build(
            synth.make_system(8, 4, symm=symm, seed=3, device=dev), cfg, seed=4, init_val=30.0)
        state, _ = run_c(state, *args(aux_c), 10)
        c0 = kernel_launches(merge)
        for it in range(4):
            a = state.arena
            g_state = power.PowerState(
                ar.Arena(a.keys.to(dev), a.vals.to(dev), a.n_used.to(dev)),
                state.en_shift.to(dev), state.last_norm.to(dev), state.iterat,
                state.generator, state.key)
            state, mc = step_c(state, *args(aux_c))
            g_state, mg = step_g(g_state, *args(aux_g))
            if not torch.equal(g_state.arena.keys.cpu(), state.arena.keys):
                raise AssertionError(f"{label} step {it}: card and CPU keys differ")
            if not torch.allclose(g_state.arena.vals.cpu(), state.arena.vals,
                                  rtol=1e-10, atol=1e-12):
                raise AssertionError(f"{label} step {it}: card and CPU values differ")
            for k in mc:
                if not np.isclose(float(mg[k]), float(mc[k]), rtol=1e-10, atol=1e-12):
                    raise AssertionError(f"{label} step {it}: metric {k} differs")
        if kernel_launches(merge) - c0 != 4:
            raise AssertionError(f"{label}: {kernel_launches(merge) - c0} kernel A launches "
                                 "in 4 steps")
        log(f"{label}: 4 steps on the card match the CPU plain path (n_dets "
            f"{int(mc['n_dets'])}), 1 kernel A launch per step")


def merge_stream_stats(a, sk):
    """Arena rows, live spawns, unique targets and the longest run of one
    key of a merge's input."""
    import torch
    from fries_tpu_torch import dets

    (skey,), sent, _ = dets.order_keys(sk)
    live = skey != sent
    runs = torch.unique_consecutive(torch.sort(skey[live]).values, return_counts=True)[1]
    return {"arena_rows": int(a.n_used[0]), "spawns": sk.shape[0],
            "live_spawns": int(live.sum()), "unique_targets": int(runs.shape[0]),
            "longest_run": int(runs.max()) if runs.numel() else 0}


def attempt_times(ham, cfg, aux, state):
    """Kernel G (``runtime/attempt.launch``) against the plain attempt pass
    (``fciqmc._attempt_pass_plain``) on the next step's slots from
    ``state``: both results compared (spawns within 1e-13, keys where the
    spawn is not 0, initiator flags; the largest relative difference of the
    spawns), device and call milliseconds of each,
    and the kernel's bound: the bytes of the slots' inputs and outputs and
    of each parent row read once, or its f64 operations estimated from the
    shapes (the four categorical rows' three passes, norm_weight's sums over
    the orbitals, a single's element), whichever takes longer."""
    import torch
    from fries_tpu_torch.drivers import fciqmc
    from fries_tpu_torch.runtime import attempt

    t = fciqmc.spawn_tables(ham, cfg, aux["p_doub"])
    args = aux["attempt_args"](state)
    keys, occ, n_walk, walk_sign, parent, valid, k_split, kd, ks = args
    nodes = attempt.node_keys(k_split, kd, ks)
    kernel = lambda: attempt.launch(t.kernel, keys, occ, n_walk, walk_sign, parent, valid, nodes)
    plain = lambda: fciqmc._attempt_pass_plain(t, *args)
    g_words, g_vals, g_ini = kernel()
    p_words, p_vals, p_ini = plain()
    live = p_vals != 0
    if not (torch.equal(g_ini, p_ini) and torch.equal(g_vals != 0, live)
            and torch.equal(g_words[live], p_words[live])
            and torch.allclose(g_vals, p_vals, rtol=1e-13, atol=0)):
        raise AssertionError("kernel G differs from the plain attempt pass")
    max_rel_err = float(((g_vals - p_vals)[live].abs() / p_vals[live].abs()).max()) \
        if bool(live.any()) else 0.0
    del g_words, g_vals, g_ini, p_words, p_vals, p_ini
    n_slots = parent.shape[0]
    n_valid = int(valid.sum())
    n_doub = int((k_split.uniform((n_slots,)).to(valid.device) < aux["p_doub"])[valid].sum())
    n_parents = int(torch.unique_consecutive(parent[valid]).shape[0])
    w, e, n = ham.n_words, ham.n_elec, ham.n_orb
    n_bytes = n_slots * (8 + 1 + 8 * w + 8 + 1) + n_parents * (8 * w + 8 * e + 16)
    rows = 2 * e + (n - e // 2) + t.kernel.max_count
    n_ops = n_doub * (6 * rows + 14 * n + 60) + (n_valid - n_doub) * (4 * e + 20)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F64_OPS_PER_S
    k_dev, k_n, k_top = device_profile(kernel)
    p_dev, p_n, p_top = device_profile(plain, reps=2)
    return {"slots": n_slots, "valid": n_valid, "doubles": n_doub, "parents": n_parents,
            "live": int(live.sum()), "max_rel_err": max_rel_err,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "f64 operations",
            "bytes": n_bytes, "f64_ops": n_ops,
            "kernel": {"device_ms": k_dev, "call_ms": cuda_ms(kernel), "operations": k_n,
                       "top": k_top},
            "plain": {"device_ms": p_dev, "call_ms": cuda_ms(plain, reps=2), "operations": p_n,
                      "top": p_top}}


def phase_fciqmc(dev):
    """bench.py's fciqmc configuration as bench.py runs it (12 blocks of 5
    warm-up steps, then 5 timed), then 3 steps under a profiler that read
    the device counter ``sampler.fallback``, then one real step's merge
    input through kernel A and its plain version; returns the results and
    that input."""
    import torch
    from fries_tpu_torch import profiling, rung
    from fries_tpu_torch.runtime import merge

    cfg = rung.fciqmc_config()
    t0 = time.perf_counter()
    step, state, args, aux = rung.build_fciqmc(dev)
    torch.cuda.synchronize()
    log(f"fciqmc: built in {time.perf_counter() - t0:.1f} s (28 orbitals, 14 electrons, "
        f"capacity {cfg.capacity}, attempt_cap {cfg.attempt_cap}, spawn_cap {cfg.spawn_cap}, "
        f"{rung.FCIQMC_INIT_WALKERS:.0f} walkers on HF)")
    # the first step's merge: every attempt comes from HF, so the stream
    # holds long runs of HF's connections
    case = aux["merge_input"](state)
    first = {**merge_stream_stats(case[0], case[1]),
             **check_merge("fciqmc, the first step's stream (all attempts from HF), (1,0,0) "
                           "no keep mask, exact", *case, None, None, exact=True)}
    del case
    log(f"fciqmc first step: {json.dumps(first)}")
    t0 = time.perf_counter()
    for b in range(12):
        ms = []
        for _ in range(5):
            state, m = step(state, *args)
            ms.append(m)
        check_power_metrics(f"fciqmc warm-up block {b}", ms)
        log(f"fciqmc warm-up block {b}: norm / n_dets per step "
            + ", ".join(f"{float(m['norm']):.0f} / {int(m['n_dets'])}" for m in ms))
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge)
    reset_counters("launch.attempt", "attempt.plain_on_card")
    t0 = time.perf_counter()
    metrics = []
    for _ in range(N_TIMED):
        state, m = step(state, *args)
        metrics.append(m)
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / N_TIMED
    launches = kernel_launches(merge)
    attempt_counts = {"launch.attempt": counter("launch.attempt"),
                      "attempt.plain_on_card": counter("attempt.plain_on_card")}
    check_power_metrics("fciqmc", metrics)
    if launches != N_TIMED:
        raise AssertionError(f"fciqmc: {launches} kernel A launches in {N_TIMED} steps")
    if attempt_counts != {"launch.attempt": N_TIMED, "attempt.plain_on_card": 0}:
        raise AssertionError(f"fciqmc: {attempt_counts} in {N_TIMED} steps, want one kernel G "
                             "launch a step and no plain attempt pass")
    # the heat-bath draws past every f32 prefix that took the last column of
    # positive weight: a device counter, added to only while a profiler records
    profiling.reset("sampler.fallback")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(N_FALLBACK):
            state, m = step(state, *args)
    check_power_metrics("fciqmc, profiled", [m])
    fallback = profiling.device_total("sampler.fallback")
    if not 0 <= fallback <= N_FALLBACK * 4 * cfg.attempt_cap:   # 4 draws a double
        raise AssertionError(f"fciqmc: sampler.fallback {fallback} in {N_FALLBACK} steps")
    last = metrics[-1]
    norm = float(last["norm"])
    res = {
        "config": "bench.py fciqmc_mol (synthetic)", "ms_per_step": 1e3 * s_per_step,
        "warm_up_ms_per_step": 1e3 * warm_s / 60,
        "walker_iterations_per_s": norm / s_per_step,
        "ns_per_walker_iteration": 1e9 * s_per_step / norm,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": {"merge": launches, **attempt_counts},
        "merge_launches_per_step": launches // N_TIMED,
        "norm_timed_steps": [float(m["norm"]) for m in metrics],
        "n_dets": int(last["n_dets"]), "nnonz": int(last["nnonz"]), "norm": norm,
        "shift": float(last["shift"]), "overflow": any(bool(m["overflow"]) for m in metrics),
        "e_corr_est": float(last["proj_num"]) / float(last["proj_den"]),
        "sampler_fallback": {"profiled_steps": N_FALLBACK, "draws": fallback},
    }
    log(f"fciqmc: {json.dumps(res)}")
    res["kernel_g"] = attempt_times(rung.fciqmc_system(dev), cfg, aux, state)
    log(f"fciqmc, kernel G: {json.dumps(res['kernel_g'])}")
    case = aux["merge_input"](state)
    res["first_step"] = first
    res["real_step"] = {**merge_stream_stats(case[0], case[1]),
                        **check_merge("fciqmc, a real step's post-death arena and spawn "
                                      "stream, (1,0,0) no keep mask, exact", *case, None, None,
                                      exact=True)}
    log(f"fciqmc real step: {json.dumps(res['real_step'])}")
    return res, case


def phase_frimulti(dev):
    """The ``frimulti`` configuration: 2 warm-up and 3 timed steps."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import merge

    cfg = rung.frimulti_config()
    t0 = time.perf_counter()
    step, state, args, _ = rung.build_frimulti(dev)
    torch.cuda.synchronize()
    log(f"frimulti: built in {time.perf_counter() - t0:.1f} s (28 orbitals, 14 electrons, "
        f"capacity {cfg.capacity}, {cfg.spawn_cap} sample slots, HB)")
    for i in range(2):
        state, m = step(state, *args)
        check_power_metrics(f"frimulti warm-up step {i}", [m])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge)
    t0 = time.perf_counter()
    metrics = []
    for _ in range(3):
        state, m = step(state, *args)
        metrics.append(m)
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / 3
    launches = kernel_launches(merge)
    check_power_metrics("frimulti", metrics)
    if launches != 3:
        raise AssertionError(f"frimulti: {launches} kernel A launches in 3 steps")
    last = metrics[-1]
    res = {"config": "frimulti (1e6 rung system, HB)", "ms_per_step": 1e3 * s_per_step,
           "sampled_nonzeros_per_s": cfg.matr_samp / s_per_step,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": {"merge": launches},
           "n_dets": int(last["n_dets"]), "norm": float(last["norm"]),
           "e_corr_est": float(last["proj_num"]) / float(last["proj_den"])}
    log(f"frimulti: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# the Hubbard-Holstein paths
# ---------------------------------------------------------------------------

def small_hh(g=0.4, ph_bits=2):
    """tests/test_hubbard.py's small system (3 sites, 2 electrons), or pure
    Hubbard with g = 0 and no phonon bits."""
    from fries_tpu_torch.ops import hubbard

    return hubbard.HubbardHolstein(n_sites=3, n_elec=2, ph_bits=ph_bits, u=1.5, omega=0.7,
                                   g=g, t=1.0)


def phase_small_hh(dev):
    """frifull_hh and frisys_hh on the small systems, card against CPU from
    one state with the same uniforms: one kernel A launch per step, and two
    emissions per frisys_hh step."""
    from fries_tpu_torch.drivers import frifull_hh, frisys_hh, power
    from fries_tpu_torch.runtime import emit, merge

    for label, ham in (("Hubbard-Holstein", small_hh()),
                       ("pure Hubbard, ph_bits 0", small_hh(0.0, 0))):
        fcfg = power.PowerConfig(eps=0.02, target_nonz=20, capacity=256, target_norm=150.0,
                                 shift_interval=2)
        small_steps_match(f"small frifull_hh ({label})", dev,
                          lambda d: frifull_hh.build(ham, 0.1, fcfg, seed=3, device=d),
                          12, 4, {merge: 1})
        scfg = frisys_hh.FrisysHHConfig(eps=0.02, vec_nonz=20, matr_samp=40, capacity=128,
                                        spawn_cap=64, target_norm=150.0, shift_interval=2)
        small_steps_match(f"small frisys_hh ({label})", dev,
                          lambda d: frisys_hh.build(ham, 0.1, scfg, seed=3, device=d),
                          12, 4, {merge: 1, emit: 2})


def power_merge_input(state, aux, eps, rns):
    """The merge input of the next power step from ``state``: (arena, spawn
    keys, values, initiator flags, keep mask), as the step builds it."""
    import torch
    from fries_tpu_torch import dets

    a = state.arena
    w, amp, ini = aux["spawn"](a.keys, torch.where(a.valid, a.vals[0], 0.0), -eps, rns)
    w = torch.where((amp != 0)[:, None], w, dets.invalid_det(a.n_words, a.device))
    return a, w, amp, ini, dets.det_eq(a.keys, aux["ref_key"][None, :])


def timed_block(step, state, args, n, label):
    """``n`` steps; returns (state, metrics, seconds per step)."""
    import torch

    t0 = time.perf_counter()
    metrics = []
    for _ in range(n):
        state, m = step(state, *args)
        metrics.append(m)
    torch.cuda.synchronize()
    check_power_metrics(label, metrics)
    return state, metrics, (time.perf_counter() - t0) / n


def phase_frifull_hh(dev):
    """bench.py's frifull_hh configuration as bench.py times it (its
    ``_time_steady``: 3 warm-up blocks of 10 steps, then 10 timed steps),
    one kernel A launch per step asserted, then a real step's merge input
    through kernel A and its plain version; returns the results and that
    input."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.ops import hubbard
    from fries_tpu_torch.runtime import merge

    cfg, ham = rung.frifull_hh_config(), rung.frifull_hh_system()
    n_cand = cfg.capacity * hubbard.n_candidates(ham)
    t0 = time.perf_counter()
    step, state, args, aux = rung.build_frifull_hh(dev)
    torch.cuda.synchronize()
    log(f"frifull_hh: built in {time.perf_counter() - t0:.1f} s (4 sites, ph_bits 3, "
        f"{ham.n_bits} bits, capacity {cfg.capacity}, {n_cand} candidates per step)")
    state, warm, _ = timed_block(step, state, args, 30, "frifull_hh warm-up")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge)
    state, metrics, s_per_step = timed_block(step, state, args, 10, "frifull_hh")
    launches = kernel_launches(merge)
    if launches != 10:
        raise AssertionError(f"frifull_hh: {launches} kernel A launches in 10 steps")
    last = metrics[-1]
    res = {"config": "bench.py frifull_hh", "ms_per_step": 1e3 * s_per_step,
           "candidates_per_s": n_cand / s_per_step,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": {"merge": launches},
           "n_dets_nnonz_per_step": [[int(m["n_dets"]), int(m["nnonz"])] for m in warm + metrics],
           "norm": float(last["norm"]), "shift": float(last["shift"]),
           "e_est": float(last["proj_num"]) / float(last["proj_den"])}
    log(f"frifull_hh: {json.dumps(res)}")
    case = power_merge_input(state, aux, cfg.eps, None)
    res["real_step"] = {
        **merge_stream_stats(case[0], case[1]),
        **check_merge("frifull_hh, a real step's stream (one word, phonon bits), (2,0,1) "
                      "+ keep mask", *case[:4], None, case[4])}
    log(f"frifull_hh real step: {json.dumps(res['real_step'])}")
    return res, case


def capture_emissions(spawn, *args):
    """Run ``spawn(*args)`` and return its result and the plans of the
    emissions it launched (the keyword arguments of each call), dense
    (``emit.emit``) and factored (``emit.emit_factored``), in launch
    order."""
    from fries_tpu_torch.runtime import emit

    plans, orig = [], (emit.emit, emit.emit_factored)

    def recording(fn):
        def run(**plan):
            plans.append(plan)
            return fn(**plan)
        return run

    emit.emit, emit.emit_factored = recording(orig[0]), recording(orig[1])
    try:
        out = spawn(*args)
    finally:
        emit.emit, emit.emit_factored = orig
    return out, plans


def phase_frisys_hh(dev):
    """The ``frisys_hh`` configuration (:func:`frisys_hh_run`, 12 sites,
    two-word keys); returns the results, the merge input and the plans."""
    from fries_tpu_torch import rung

    return frisys_hh_run(dev, "frisys_hh", rung.frisys_hh_system(), rung.build_frisys_hh,
                         "hh")


def frisys_hh_run(dev, name, ham, build, plan_prefix):
    """A frisys_hh configuration (``build(dev)`` gives its step on ``ham``,
    with :func:`rung.frisys_hh_config`): warm-up until the vector holds its
    budget (at most 40 steps, each logged), 5 timed steps with 2 emissions
    and 1 kernel A launch per step asserted, then a real step's two
    emission plans through kernel B and its merge input through kernel A,
    each against its plain version; returns the results, the merge input
    and the plans (``plan_prefix level 1`` and ``level 2``)."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import emit, merge

    cfg = rung.frisys_hh_config()
    t0 = time.perf_counter()
    step, state, args, aux = build(dev)
    torch.cuda.synchronize()
    log(f"{name}: built in {time.perf_counter() - t0:.1f} s ({ham.n_sites} sites, "
        f"ph_bits {ham.ph_bits}, {ham.n_bits} bits in {ham.n_words} words, capacity "
        f"{cfg.capacity}, matr_samp {cfg.matr_samp}, spawn_cap {cfg.spawn_cap})")
    n_warm, nnonz, warm = 0, 0, []
    while nnonz < cfg.vec_nonz and n_warm < 40:
        state, ms, _ = timed_block(step, state, args, 1, f"{name} warm-up")
        n_warm += 1
        nnonz = int(ms[0]["nnonz"])
        warm.append([int(ms[0]["n_dets"]), nnonz])
    log(f"{name} warm-up: {n_warm} steps, n_dets / nnonz per step {warm}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge)
    reset_launches(emit)
    state, metrics, s_per_step = timed_block(step, state, args, N_TIMED, name)
    launches = {"merge": kernel_launches(merge), "emit": kernel_launches(emit)}
    if launches != {"merge": N_TIMED, "emit": 2 * N_TIMED}:
        raise AssertionError(f"{name}: launches {launches} in {N_TIMED} steps")
    last = metrics[-1]
    res = {"config": f"{name} ({ham.n_sites} sites, ph_bits {ham.ph_bits}, "
                     f"{ham.n_bits} bits, W={ham.n_words})",
           "ms_per_step": 1e3 * s_per_step,
           "sampled_nonzeros_per_s": cfg.matr_samp / s_per_step,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
           "warm_up_steps": n_warm, "n_dets_nnonz_warm_up": warm,
           "n_dets_nnonz_timed_steps": [[int(m["n_dets"]), int(m["nnonz"])] for m in metrics],
           "norm": float(last["norm"]),
           "e_est": float(last["proj_num"]) / float(last["proj_den"])}
    log(f"{name}: {json.dumps(res)}")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(12)
    rns = torch.rand(2, dtype=torch.float64, generator=gen).to(dev)
    case, plans = capture_emissions(power_merge_input, state, aux, cfg.eps, rns)
    if len(plans) != 2:
        raise AssertionError(f"{name}: {len(plans)} emissions in one spawn")
    levels = (f"{plan_prefix} level 1", f"{plan_prefix} level 2")
    res["emit_checks"] = {
        level: check_emit(f"{name} {level} (N={plan['offsets'].shape[0]}, "
                          f"K={plan['w_sub'].shape[1]}), a real step's plan", plan,
                          need_kept=False)
        for level, plan in zip(levels, plans)}
    res["real_step"] = {
        **merge_stream_stats(case[0], case[1]),
        **check_merge(f"{name}, a real step's stream (W={ham.n_words}, phonon bits), (2,0,1) "
                      "+ keep mask", *case[:4], None, case[4])}
    log(f"{name} real step: {json.dumps(res['real_step'])}")
    return res, case, dict(zip(levels, plans))


def phase_frisys_hh_wide(dev):
    """Hubbard-Holstein rows past 64 bits: a small 65-bit frisys_hh system
    (13 sites, ph_bits 3, three words) stepped on the card and on the CPU
    from one state, then the ``frisys_hh_wide`` configuration (16 sites, 80
    bits: kernel A on 128-bit phonon keys, kernel B at K = 2 and 1;
    :func:`frisys_hh_run`).  Returns the results, the merge input and the
    plans."""
    from fries_tpu_torch import rung
    from fries_tpu_torch.drivers import frisys_hh
    from fries_tpu_torch.ops import hubbard
    from fries_tpu_torch.runtime import emit, merge

    ham = hubbard.HubbardHolstein(n_sites=13, n_elec=13, ph_bits=3, u=1.5, omega=0.7, g=0.4)
    cfg = frisys_hh.FrisysHHConfig(eps=0.02, vec_nonz=60, matr_samp=200, capacity=1024,
                                   spawn_cap=320, target_norm=400.0, shift_interval=2)
    small_steps_match(f"small frisys_hh, {ham.n_bits} bits", dev,
                      lambda d: frisys_hh.build(ham, 0.1, cfg, seed=3, device=d), 6, 4,
                      {merge: 1, emit: 2})
    return frisys_hh_run(dev, "frisys_hh_wide", rung.frisys_hh_wide_system(),
                         rung.build_frisys_hh_wide, "hh_wide")


def subspace_run(label, step, state, n_warm, n_timed):
    """``n_warm`` + ``n_timed`` subspace iterations with kernel C's count
    reset before the timed ones; returns (state, results)."""
    import torch
    from fries_tpu_torch.runtime import merge_multi

    for i in range(n_warm):
        state, m = step(state)
        if bool(m["overflow"]):
            raise AssertionError(f"{label}: overflow at warm-up step {i}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge_multi)
    t0 = time.perf_counter()
    metrics = []
    for _ in range(n_timed):
        state, m = step(state)
        metrics.append(m)
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / n_timed
    merges = sum(int(m.get("n_merges", 1)) for m in metrics)
    for i, m in enumerate(metrics):
        if bool(m["overflow"]):
            raise AssertionError(f"{label}: overflow at timed step {i}")
        if not (torch.isfinite(m["h_mat"]).all() and torch.isfinite(m["d_mat"]).all()):
            raise AssertionError(f"{label}: non-finite h_mat / d_mat at timed step {i}")
    if kernel_launches(merge_multi) != merges:
        raise AssertionError(f"{label}: {kernel_launches(merge_multi)} kernel C launches, {merges} "
                             f"merges in {n_timed} steps")
    return state, {"ms_per_step": 1e3 * s_per_step, "s_per_step": s_per_step,
                   "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                   "launches": {"merge_multi": kernel_launches(merge_multi)}, "metrics": metrics,
                   "n_dets_timed_steps": [int(m["n_dets"][0]) for m in metrics],
                   "n_nonzero_per_row": (state.arena.vals != 0).sum(1).tolist()}


def phase_subspace_modes(dev):
    """The subsp configuration's ``lowmem`` mode: first one step of the
    stored and the lowmem path from one state (their h_mat equal within
    rtol 1e-10), then 2 warm-up and 5 timed steps; then
    ``compress_mode="multi"``, 2 + 3 steps."""
    import torch
    from fries_tpu_torch import rung

    cfg = rung.subspace_config()
    res = {}
    step_s, state, _ = rung.build_subspace(dev)
    step_l, state_l, _ = rung.build_subspace(dev, lowmem=True)
    for _ in range(N_WARM):
        state, _ = step_s(state)
    _, ms = step_s(state)
    _, ml = step_l(state)
    if not torch.allclose(ml["h_mat"], ms["h_mat"], rtol=1e-10, atol=0):
        raise AssertionError(f"subsp_lowmem: h_mat {ml['h_mat'].tolist()} != stored "
                             f"{ms['h_mat'].tolist()}")
    rel = float((ml["h_mat"] - ms["h_mat"]).abs().max() / ms["h_mat"].abs().max())
    log(f"subsp_lowmem: one step from one state, h_mat agrees with the stored path "
        f"(largest difference {rel:.3e} of the largest element)")
    for name, step, state, n_timed in (("subsp_lowmem", step_l, state_l, N_TIMED),
                                       ("subsp_multi", None, None, 3)):
        if step is None:
            step, state, _ = rung.build_subspace(dev, compress_mode="multi")
        _, r = subspace_run(name, step, state, N_WARM, n_timed)
        r["sampled_nonzeros_per_s"] = cfg.n_trial * cfg.matr_samp / r.pop("s_per_step")
        r.pop("metrics")
        res[name] = r
        log(f"{name}: {json.dumps(r)}")
    res["subsp_lowmem"]["h_mat_rel_diff_vs_stored"] = rel
    return res


def phase_subspfull(dev):
    """The ``subspfull`` configuration: warm-up until both vectors hold
    their budget (at most 40 steps), 3 timed steps with one kernel C launch
    per chunk asserted; then a real chunk (the second of the step after the
    timed ones, merged into the arena that holds the first chunk's sums)
    through kernel C and its plain version; returns the results and that
    chunk."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import arena as ar

    cfg = rung.subspfull_config()
    t0 = time.perf_counter()
    step, state, aux = rung.build_subspfull(dev)
    torch.cuda.synchronize()
    nc = aux["n_excitations"]
    log(f"subspfull: built in {time.perf_counter() - t0:.1f} s (the frifull system, "
        f"T = {cfg.n_trial}, capacity {cfg.capacity}, {cfg.batch} rows per chunk, "
        f"{nc} template excitations, S = {cfg.n_trial * cfg.batch * nc} per chunk)")
    n_warm, warm = 0, []
    while n_warm < 40:
        state, m = step(state)
        n_warm += 1
        if bool(m["overflow"]):
            raise AssertionError(f"subspfull: overflow at warm-up step {n_warm}")
        per_row = (state.arena.vals != 0).sum(1)
        warm.append([int(m["n_dets"][0]), *per_row.tolist()])
        if bool((per_row >= cfg.vec_nonz).all()):
            break
    log(f"subspfull warm-up: {n_warm} steps, n_dets / nonzeros per row {warm}")
    state, r = subspace_run("subspfull", step, state, 0, 3)
    metrics = r.pop("metrics")
    rows = sum(int(m["spawn_rows"]) for m in metrics)
    r.update(config="subspfull (exact H, frifull system, T = 2)", warm_up_steps=n_warm,
             candidates_per_s=cfg.n_trial * nc * rows / 3 / r.pop("s_per_step"),
             merges_per_step=[int(m["n_merges"]) for m in metrics],
             spawn_rows_per_step=[int(m["spawn_rows"]) for m in metrics])
    log(f"subspfull: {json.dumps(r)}")
    captured, orig = [], ar.accumulate_multi_best

    def recording(*args):
        if len(captured) == 1:
            captured.append(args)
        elif not captured:
            captured.append(None)
        return orig(*args)

    ar.accumulate_multi_best = recording
    try:
        step(state)
    finally:
        ar.accumulate_multi_best = orig
    case = captured[1]
    r["real_chunk"] = {**merge_stream_stats(case[0], case[1]),
                       **check_merge_multi("subspfull, a real chunk's T streams into the arena "
                                           "after chunk 0", *case)}
    log(f"subspfull real chunk: {json.dumps(r['real_chunk'])}")
    return r, case


# ---------------------------------------------------------------------------
# timings
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the observable estimators, frisys's unfused stages, checkpoints and resume
# ---------------------------------------------------------------------------

OBS_LAYOUTS = {False: {(4, 0, 0), (4, 0, 3)}, True: {(4, 0, 0), (4, 1, 1), (4, 1, 3)}}


def phase_small_observables(dev):
    """The Rayleigh and the replica estimator at a small size (10 steps each,
    16-row chunks, O = the symmetry-allowed excitation 1 -> 3), card against
    CPU from one state and one key tree (the same bits on both devices):
    keys exact, values and estimators within rtol 1e-10, one kernel A launch
    per merge."""
    import numpy as np
    import torch
    from fries_tpu_torch.drivers import observables
    from fries_tpu_torch.runtime import merge

    for replica in (False, True):
        label = f"small observables ({'replica' if replica else 'Rayleigh'})"
        cfg = observables.ObservablesConfig(eps=0.05, target_nonz=30, capacity=1024,
                                            obs_des=1, obs_cre=3, burn_in=2, n_obs=2,
                                            btw_obs=2, replica=replica, batch=16)
        step_c, _, state_c, _ = observables.build(small_system(), cfg, seed=4)
        step_g, _, state_g, _ = observables.build(small_system(dev), cfg, seed=4)
        m0, merges = kernel_launches(merge), 0
        for it in range(10):
            state_c, mc = step_c(state_c)
            state_g, mg = step_g(state_g)
            if not torch.equal(state_g.arena.keys.cpu(), state_c.arena.keys):
                raise AssertionError(f"{label} step {it}: card and CPU keys differ")
            if not torch.allclose(state_g.arena.vals.cpu(), state_c.arena.vals,
                                  rtol=1e-10, atol=1e-13):
                raise AssertionError(f"{label} step {it}: card and CPU values differ")
            for k in mc:
                if not np.isclose(float(mg[k]), float(mc[k]), rtol=1e-10, atol=1e-13):
                    raise AssertionError(f"{label} step {it}: metric {k} differs")
            if bool(mc["overflow"]):
                raise AssertionError(f"{label} step {it}: overflow")
            merges += int(mc["n_merges"])
        if kernel_launches(merge) - m0 != merges or float(mc["obs_num"]) == 0.0:
            raise AssertionError(f"{label}: {kernel_launches(merge) - m0} kernel A launches for "
                                 f"{merges} merges, obs_num {float(mc['obs_num'])}")
        log(f"{label}: 10 steps on the card match the CPU plain path ({merges} kernel A "
            f"launches, obs_num / obs_den {float(mc['obs_num']) / float(mc['obs_den']):.6f})")


def recording_merges(capture):
    """Install a recorder around ``arena.accumulate_best`` that counts each
    (n_vecs, origin, dest) layout of the merges on the card (and with
    ``capture`` keeps a copy of the first input of each), and a guard that
    raises if the plain merge runs on card tensors.  Returns (counts,
    captured, restore)."""
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import merge

    counts, captured = {}, {}
    orig_best, orig_plain = ar.accumulate_best, merge.accumulate_plain

    def best(a, sk, sv, si, origin_row=0, dest_row=0, keep_mask=None):
        layout = (a.n_vecs, origin_row, dest_row)
        counts[layout] = counts.get(layout, 0) + 1
        if capture and layout not in captured:
            captured[layout] = (ar.Arena(a.keys.clone(), a.vals.clone(), a.n_used.clone()),
                                sk.clone(), sv.clone(), si.clone())
        return orig_best(a, sk, sv, si, origin_row, dest_row, keep_mask=keep_mask)

    def plain(a, *args, **kwargs):
        if a.keys.is_cuda:
            raise AssertionError("the plain merge ran on card tensors")
        return orig_plain(a, *args, **kwargs)

    def restore():
        ar.accumulate_best, merge.accumulate_plain = orig_best, orig_plain

    ar.accumulate_best, merge.accumulate_plain = best, plain
    return counts, captured, restore


def phase_observables(dev, replica):
    """The ``observables`` (Rayleigh) or ``obs_repl`` configuration: 6
    warm-up steps (the burn-in), 6 timed steps (a period start, two more
    weighted steps, three free ones) with kernel A's launches per layout
    counted and the plain merge barred from the card, then one more step
    whose first merge input of each layout goes through kernel A and its
    plain version; returns the results and those inputs by layout."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import merge

    name = "obs_repl" if replica else "observables"
    cfg = rung.observables_config(replica)
    t0 = time.perf_counter()
    step, state, aux = rung.build_observables(dev, replica)
    torch.cuda.synchronize()
    log(f"{name}: built in {time.perf_counter() - t0:.1f} s (14 orbitals, 6 electrons, "
        f"capacity {cfg.capacity}, {cfg.batch}-row chunks of {aux['n_excitations']} "
        f"candidates each, O = {cfg.obs_des} -> {cfg.obs_cre})")

    def check(label, ms):
        """No overflow, finite estimators, a nonzero denominator wherever
        the estimator is read (every replica step, the Rayleigh periods)."""
        for i, m in enumerate(ms):
            if bool(m["overflow"]):
                raise AssertionError(f"{label}: overflow at step {i}")
            num, den = float(m["obs_num"]), float(m["obs_den"])
            if not (torch.isfinite(torch.tensor([num, den, float(m["norm"])])).all()
                    and (den != 0 or not (replica or bool(m["in_obs"])))):
                raise AssertionError(f"{label}: non-finite estimator at step {i}")

    warm = []
    for _ in range(cfg.burn_in):
        state, m = step(state)
        warm.append(m)
    check(f"{name} warm-up", warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, _, restore = recording_merges(False)
    reset_launches(merge)
    try:
        t0 = time.perf_counter()
        metrics = []
        for _ in range(6):
            state, m = step(state)
            metrics.append(m)
        torch.cuda.synchronize()
        s_per_step = (time.perf_counter() - t0) / 6
    finally:
        restore()
    check(name, metrics)
    launches = kernel_launches(merge)
    n_merges = sum(int(m["n_merges"]) for m in metrics)
    if launches != n_merges or launches != sum(counts.values()):
        raise AssertionError(f"{name}: {launches} kernel A launches, {n_merges} merges, "
                             f"recorded {counts}")
    if set(counts) != OBS_LAYOUTS[replica]:
        raise AssertionError(f"{name}: merges at layouts {sorted(counts)}")
    in_obs = [bool(m["in_obs"]) for m in metrics]
    if in_obs != [True] * 3 + [False] * 3:
        raise AssertionError(f"{name}: observable periods {in_obs}")
    rows = [int(m["spawn_rows"]) for m in metrics]
    last = metrics[-1]
    res = {"config": name, "ms_per_step": 1e3 * s_per_step,
           "candidates_per_s": sum(rows) * aux["n_excitations"] / (6 * s_per_step),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "merge_launches_per_step": launches / 6,
           "launches_by_layout": {str(k): v for k, v in sorted(counts.items())},
           "launches": {"merge": launches},
           "n_merges_per_step": [int(m["n_merges"]) for m in metrics],
           "spawn_rows_per_step": rows,
           "n_dets_per_step": [int(m["n_dets"]) for m in warm + metrics],
           "in_obs": in_obs, "obs_num": float(last["obs_num"]),
           "obs_den": float(last["obs_den"]),
           "obs_estimate": float(last["obs_num"]) / float(last["obs_den"])}
    log(f"{name}: {json.dumps(res)}")

    _, captured, restore = recording_merges(True)
    try:
        state, m = step(state)
    finally:
        restore()
    check(f"{name} capture step", [m])
    res["real_merges"] = {}
    for layout, (a, sk, sv, si) in sorted(captured.items()):
        _, origin, dest = layout
        out = compare_merges(f"merge {name} {layout}",
                             merge.accumulate(a, sk, sv, si, origin, dest),
                             merge.accumulate_plain(a, sk, sv, si, origin, dest))
        res["real_merges"][str(layout)] = {**merge_stream_stats(a, sk), **out}
        log(f"merge {name}, a real step's merge at {layout}: agrees "
            f"({json.dumps(res['real_merges'][str(layout)])})")
    return res, captured


def phase_small_unfused(dev):
    """frisys with both stages unfused at a small size, card against CPU:
    five kernel B launches and one kernel A launch per step."""
    from fries_tpu_torch.drivers import frisys
    from fries_tpu_torch.runtime import emit, merge

    cfg = frisys.FrisysConfig(eps=0.02, vec_nonz=60, matr_samp=150, capacity=256,
                              spawn_cap=200, target_norm=200.0, shift_interval=2,
                              fuse_ab=False, fuse_cd=False)
    small_steps_match("small system, unfused stages", dev,
                      lambda d: frisys.build(small_system(d), cfg, seed=4), 20, 3,
                      {merge: 1, emit: 5})


UNFUSED_LEVELS = ("unfused A", "unfused B", "unfused C", "unfused D", "unfused E")


def phase_unfused(dev):
    """The 1e6 rung with ``fuse_ab=False, fuse_cd=False``: 2 warm-up and 3
    timed steps with 5 kernel B and 1 kernel A launches per step asserted,
    then a real step's five emission plans through kernel B and its plain
    version; returns the results and the plans by level."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import emit, merge

    t0 = time.perf_counter()
    step, state, args, aux = rung.build(dev, fuse_ab=False, fuse_cd=False)
    torch.cuda.synchronize()
    log(f"unfused rung: built in {time.perf_counter() - t0:.1f} s")
    state, _, _ = timed_block(step, state, args, N_WARM, "unfused rung warm-up")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(merge)
    reset_launches(emit)
    with cd_plans() as seen:
        state, metrics, s_per_step = timed_block(step, state, args, 3, "unfused rung")
    launches = {"merge": kernel_launches(merge), "emit": kernel_launches(emit)}
    if launches != {"merge": 3, "emit": 15}:
        raise AssertionError(f"unfused rung: launches {launches} in 3 steps")
    check_plan_launches("unfused rung", seen, 3, 0)
    last = metrics[-1]
    res = {"config": "1e6 rung, fuse_ab=False, fuse_cd=False",
           "ms_per_step": 1e3 * s_per_step,
           "sampled_nonzeros_per_s": rung.N_SAMP / s_per_step,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
           "n_dets": int(last["n_dets"]), "norm": float(last["norm"]),
           "e_corr_est": float(last["proj_num"]) / float(last["proj_den"])}
    log(f"unfused rung: {json.dumps(res)}")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(13)
    rns = torch.rand(6, dtype=torch.float64, generator=gen).to(dev)
    _, plans = capture_emissions(power_merge_input, state, aux, rung.EPS, rns)
    if len(plans) != 5:
        raise AssertionError(f"unfused rung: {len(plans)} emissions in one spawn")
    res["emit_checks"] = {
        name: check_emit(f"{name} (N={plan['offsets'].shape[0]}, K={plan['w_sub'].shape[1]}), "
                         "a real step's plan", plan, need_kept=False)
        for name, plan in zip(UNFUSED_LEVELS, plans)}
    return res, dict(zip(UNFUSED_LEVELS, plans))


CLI_RESUME = {
    "frisys_mol": ["--epsilon", "0.02", "--vec_nonz", "60", "--mat_nonz", "150",
                   "--max_dets", "512", "--target", "200"],
    "fciqmc_mol": ["--max_dets", "512", "--target", "600", "--attempt_cap", "4096",
                   "--initiator", "2", "--epsilon", "0.02", "--distribution", "HB"],
    "subsp_mol": ["--epsilon", "0.02", "--vec_nonz", "60", "--mat_nonz", "150",
                  "--max_dets", "512", "--num_trial", "2", "--restart_int", "4"],
}


def phase_cli_resume(dev):
    """Checkpoint and resume through the command line's entry point
    (``fries_tpu_torch.cli.main``, what ``python -m fries_tpu_torch.cli``
    runs) on the card, its default device: for frisys_mol, fciqmc_mol (its
    key tree) and subsp_mol on the small system's FCIDUMP, 6 iterations with
    ``--save_interval 3`` and then 6 more with ``--load_dir`` must write
    exactly the streams of a straight run of 12."""
    import contextlib
    import io as pyio
    import os
    import tempfile

    import torch
    from fries_tpu_torch import cli, dets
    from fries_tpu_torch import io as tio

    res = {}
    reads = dict(tio.READS)
    with tempfile.TemporaryDirectory() as tmp:
        tio.write_fcidump(small_system(), os.path.join(tmp, "FCIDUMP"), point_group="D2h")
        hf = dets.hf_det(8, 4)
        single, _ = dets.single_parity(hf[None], torch.tensor([1]), torch.tensor([5]))
        tio.save_vec_txt(os.path.join(tmp, "trial00"), hf[None].numpy(), [1.0], 16)
        tio.save_vec_txt(os.path.join(tmp, "trial01"), single.numpy(), [1.0], 16)
        for cmd, extra in CLI_RESUME.items():
            base = [cmd, "--fcidump_path", os.path.join(tmp, "FCIDUMP"), "--point_group",
                    "D2h", "--save_interval", "3", "--seed", "3"] + extra
            if cmd == "subsp_mol":
                base += ["--trial_vecs", os.path.join(tmp, "trial")]
            straight, resumed = os.path.join(tmp, cmd, "straight"), os.path.join(tmp, cmd, "resumed")
            with contextlib.redirect_stdout(pyio.StringIO()):
                cli.main(base + ["--max_iter", "12", "--result_dir", straight])
                cli.main(base + ["--max_iter", "6", "--result_dir", resumed])
                cli.main(base + ["--max_iter", "6", "--result_dir", resumed,
                                 "--load_dir", resumed])
            names = sorted(n for n in os.listdir(straight) if n.endswith(".txt")
                           and n not in ("params.txt", "arena_occ.txt"))
            for n in names:
                with open(os.path.join(straight, n)) as f1, open(os.path.join(resumed, n)) as f2:
                    a, b = f1.read(), f2.read()
                if a != b:
                    raise AssertionError(f"cli resume {cmd}: {n} differs from the straight run")
            lines = sum(1 for line in open(os.path.join(straight, names[0])) if line.strip())
            res[cmd] = {"streams": names, "lines": lines}
            log(f"cli resume {cmd}: 6 + 6 iterations on the card equal 12 straight ones "
                f"exactly ({len(names)} streams)")
    read = {k: tio.READS[k] - reads[k] for k in reads}
    if read["python"] or not read["native"]:
        raise AssertionError(f"cli resume: the command line's reads went {read}, not all "
                             "through the native reader")
    res["reads"] = read
    return res


PAST_BOUNDS_SUBSP = ["--point_group", "D2h", "--epsilon", "0.02", "--vec_nonz", "40",
                     "--mat_nonz", "80", "--max_dets", "512", "--num_trial", "33",
                     "--restart_int", "2", "--max_iter", "4", "--seed", "3"]
PAST_BOUNDS_HH = {   # frifull_hh applies H to every capacity row: a small arena
    "frisys_hh": ["--vec_nonz", "30", "--mat_nonz", "80", "--max_dets", "1024",
                  "--max_iter", "6"],
    "frifull_hh": ["--vec_nonz", "4", "--max_dets", "4096", "--max_iter", "3"]}
HH_CHAIN = 86       # sites of the half-filled chain: 2 x 86 + 4 x 86 = 516 bits, 17 words


def trial_33_masks():
    """The small system's HF and the 32 determinants of its irrep nearest to
    it (fewest excitations, then the lowest mask): 33 trial vectors, one
    value row more than kernel C takes."""
    n_orb = 8
    hf = 0b11 | (0b11 << n_orb)

    def irrep(m):
        out = 0
        for i in range(2 * n_orb):
            if m >> i & 1:
                out ^= SMALL_SYMM[i % n_orb]
        return out

    near = sorted((bin(m ^ hf).count("1"), m) for m in range(1 << (2 * n_orb))
                  if m != hf and bin(m & 0xFF).count("1") == bin(m >> n_orb).count("1") == 2
                  and irrep(m) == 0)
    return [hf] + [m for _, m in near[:32]]


def cli_card_against_cpu(label, argv, tmp):
    """``fries_tpu_torch.cli.main(argv)`` on the card, then with ``--device
    cpu``: every stream (each ``.txt`` but params.txt) the same shape and
    within rtol 1e-10, atol 1e-12 of the CPU's; on the card at least one
    merge taken off the kernels (``profiling``'s ``merge.plain_on_card``).  Returns the card
    run's counts and seconds."""
    import contextlib
    import io as pyio
    import os

    import numpy as np
    import torch
    from fries_tpu_torch import cli
    from fries_tpu_torch.runtime import arena as ar, emit, merge, merge_multi

    mods = {"merge": merge, "emit": emit, "merge_multi": merge_multi}
    dirs = {d: os.path.join(tmp, label.replace(" ", "_"), d) for d in ("cuda", "cpu")}
    res, last = {}, {}

    def keep_last(name):     # the last plain merge's inputs on the card
        def wrap(fn):
            def call(*args, **kw):
                if args[0].keys.is_cuda:
                    last[name] = args
                return fn(*args, **kw)
            return call
        return wrap

    for device, path in dirs.items():
        if device == "cuda":
            reset_counters("merge.plain_on_card")
            before = {k: kernel_launches(mod) for k, mod in mods.items()}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(pyio.StringIO()), patched(
                (ar, "accumulate", keep_last("accumulate_best")),
                (ar, "accumulate_multi", keep_last("accumulate_multi_best"))):
            cli.main(argv + ["--device", device, "--result_dir", path])
        res[f"{device}_s"] = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.synchronize()
            res["plain_on_card"] = counter("merge.plain_on_card")
            res["launches"] = {k: kernel_launches(mod) - before[k] for k, mod in mods.items()}
    if not res["plain_on_card"]:
        raise AssertionError(f"{label}: no merge left the kernels on the card")
    for name, args in last.items():     # call ms through the dispatcher, on the path's tensors
        a = args[0]
        res[f"{name} plain merge"] = {"ms": cuda_ms(lambda: getattr(ar, name)(*args)),
                                      "capacity": a.capacity, "rows": a.n_vecs,
                                      "words": a.n_words, "spawns": args[1].shape[0]}
    names = sorted(n for n in os.listdir(dirs["cpu"]) if n.endswith(".txt") and n != "params.txt")
    worst = 0.0
    for n in names:
        text = [open(os.path.join(dirs[d], n)).read() for d in ("cuda", "cpu")]
        if not text[1].strip():     # a stream this run is too short to write
            if text[0].strip():
                raise AssertionError(f"{label}: {n} written on the card only")
            continue
        x, y = (np.loadtxt(pyio.StringIO(t), delimiter=",", ndmin=2) for t in text)
        if x.shape != y.shape or not np.allclose(x, y, rtol=1e-10, atol=1e-12):
            raise AssertionError(f"{label}: {n} on the card differs from the CPU's")
        worst = max(worst, float(np.abs(x - y).max()) if x.size else 0.0)
    lines = sum(1 for line in open(os.path.join(dirs["cpu"], names[0])) if line.strip())
    res.update(streams=names, lines=lines, max_abs_err=worst)
    log(f"{label}: the card equals the CPU ({json.dumps(res)})")
    return res


def phase_past_bounds(dev):
    """The regimes past kernels A and C's bounds, through the command line on
    the card against ``--device cpu``: subsp_mol, subsp_mol_lowmem and
    subspfull_mol with 33 trial vectors on the small system's FCIDUMP;
    frisys_hh and frifull_hh on a half-filled 86-site chain at ph_bits 4
    (keys of 17 words); then ``arena.accumulate_best`` with a keep mask at
    layout (3, 1, 2) on the 1e6 rung's shapes (a compaction, then kernel A)
    against ``merge.accumulate_plain`` on the CPU.  Every run counts its
    card routes; on the CLI runs kernels A and C launch no time."""
    import os
    import tempfile

    import torch
    from fries_tpu_torch import dets
    from fries_tpu_torch import io as tio
    from fries_tpu_torch.runtime import arena as ar, merge

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        fcidump, trial = os.path.join(tmp, "FCIDUMP"), os.path.join(tmp, "trial")
        tio.write_fcidump(small_system(), fcidump, point_group="D2h")
        for j, m in enumerate(trial_33_masks()):
            tio.save_vec_txt(f"{trial}{j:02d}", [[m & dets.WORD_MASK]], [1.0], 16)
        for cmd in ("subsp_mol", "subsp_mol_lowmem", "subspfull_mol"):
            r = cli_card_against_cpu(f"{cmd} T=33", [cmd, "--fcidump_path", fcidump,
                                                     "--trial_vecs", trial] + PAST_BOUNDS_SUBSP,
                                     tmp)
            if r["launches"]["merge_multi"]:
                raise AssertionError(f"{cmd} T=33: kernel C launched at 33 rows")
            res[f"{cmd} T=33"] = r
        params = os.path.join(tmp, "chain.txt")
        with open(params, "w") as f:
            f.write(f"n_elec\n{HH_CHAIN}\nlat_len\n{HH_CHAIN}\nn_dim\n1\neps\n0.02\nU\n1.5\n"
                    "omega\n0.7\ng\n0.4\ngs_energy\n0.0\n")
        for cmd, extra in PAST_BOUNDS_HH.items():
            r = cli_card_against_cpu(f"{cmd} W=17", [cmd, "--params_path", params, "--ph_bits",
                                                     "4", "--target", "200", "--seed", "3"] + extra,
                                     tmp)
            if r["launches"]["merge"]:
                raise AssertionError(f"{cmd} W=17: kernel A launched on 17-word keys")
            res[f"{cmd} W=17"] = r
    gen = torch.Generator(device=dev).manual_seed(31)
    a, sk, sv, si, keep = rung_merge_case(gen, dev)
    a = ar.Arena(keys=a.keys, vals=torch.stack([torch.zeros_like(a.vals[0]), a.vals[0],
                                                a.vals[0].flip(0)]), n_used=a.n_used)
    reset_counters("merge.plain_on_card")
    launches = kernel_launches(merge)
    got = ar.accumulate_best(a, sk, sv, si, 1, 2, keep_mask=keep)
    torch.cuda.synchronize()
    routes, launches = counter("merge.plain_on_card"), kernel_launches(merge) - launches
    if (routes, launches) != (1, 1):
        raise AssertionError(f"keep mask at (3, 1, 2): {routes} card routes, {launches} "
                             "kernel A launches, want 1 and 1")
    cpu = lambda t: t.cpu()
    ref = merge.accumulate_plain(ar.Arena(cpu(a.keys), cpu(a.vals), cpu(a.n_used)), cpu(sk),
                                 cpu(sv), cpu(si), 1, 2, cpu(keep))
    out = compare_merges("keep mask at (3, 1, 2)", (got[0], got[1]),
                         (ar.Arena(ref[0].keys.to(dev), ref[0].vals.to(dev),
                                   ref[0].n_used.to(dev)),
                          {k: v.to(dev) for k, v in ref[1].items()}))
    res["keep mask (3, 1, 2)"] = {**out, "plain_on_card": routes, "merge_launches": launches}
    log(f"keep mask at (3, 1, 2), the 1e6 rung's shapes: a compaction then kernel A, equal "
        f"to the plain merge on the CPU ({json.dumps(res['keep mask (3, 1, 2)'])})")
    return res


def frifull_real_repeats(dev, full, n_steps=4):
    """``frifull_real`` (dedup 2^19) built and stepped twice from one seed:
    every step's metrics and the last arena equal bit for bit."""
    import torch
    from fries_tpu_torch import rung

    ham = rung.frifull_real_system(dev, full=full)
    bits = lambda t: t.view(torch.int64) if t.is_floating_point() else t
    runs = []
    for _ in range(2):
        step, state, args, _ = rung.build_frifull_real(dev, ham=ham)
        metrics = []
        for _ in range(n_steps):
            state, m = step(state, *args)
            metrics.append({k: bits(v.detach().clone().reshape(-1)) for k, v in m.items()})
        a = state.arena
        runs.append((metrics, [a.keys.clone(), bits(a.vals.clone()), a.n_used.clone()]))
        del step, state, args
    (m1, a1), (m2, a2) = runs
    for i, (x, y) in enumerate(zip(m1, m2)):
        for k in x:
            if not torch.equal(x[k], y[k]):
                raise AssertionError(f"frifull_real twice from one seed: step {i} metric {k} "
                                     "differs")
    if not all(torch.equal(x, y) for x, y in zip(a1, a2)):
        raise AssertionError("frifull_real twice from one seed: the arenas differ")
    res = {"steps": n_steps, "n_used": int(a1[2][0]), "equal_bits": True}
    log(f"frifull_real twice from one seed, dedup 2^19: {json.dumps(res)}")
    return res


def phase_native_reader(ham):
    """The native FCIDUMP and vector-file reader (built with g++ from
    ``fries_tpu_torch/native/fries_io.cpp``; ``native=True`` throughout, so a
    failed build fails the run) against the Python path on the same files,
    equal bit for bit, each read timed (median of 3 on the host's clock):
    ``ham``'s FCIDUMP (real Ne/cc-pVQZ, 54 orbitals), a file of 200,000
    two-word determinant masks and its values."""
    import os
    import tempfile

    import numpy as np
    import torch
    from fries_tpu_torch import io as tio
    from fries_tpu_torch import native

    def median_s(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return out, sorted(times)[1]

    t0 = time.perf_counter()
    native.lib.cache_clear()
    so, why = native.lib()
    if so is None:
        raise AssertionError(f"native reader: not built ({why})")
    res = {"build_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "FCIDUMP")
        t0 = time.perf_counter()
        tio.write_fcidump(ham, path, point_group="D2h", core_energy=-1.5)
        res["fcidump_bytes"], res["write_s"] = os.path.getsize(path), time.perf_counter() - t0
        (hn, cn), res["fcidump_native_s"] = median_s(
            lambda: tio.parse_fcidump(path, "D2h", native=True))
        (hp, cp), res["fcidump_python_s"] = median_s(
            lambda: tio.parse_fcidump(path, "D2h", native=False))
        for k in ("hcore", "eris", "symm"):
            if not torch.equal(getattr(hn, k), getattr(hp, k)):
                raise AssertionError(f"native reader: FCIDUMP {k} differs from the Python path")
        if cn != cp or (hn.n_orb, hn.n_elec) != (hp.n_orb, hp.n_elec):
            raise AssertionError("native reader: FCIDUMP header or core energy differs")
        gen = np.random.default_rng(5)
        keys = gen.integers(0, 2**32, size=(200_000, 2), dtype=np.uint64).astype(np.uint32)
        keys[:, 1] &= np.uint32((1 << 20) - 1)
        vals = gen.standard_normal(200_000)
        prefix = os.path.join(tmp, "vec")
        tio.save_vec_txt(prefix, keys, vals, 52)
        (kn, vn), res["vector_native_s"] = median_s(
            lambda: tio.load_vec_txt(prefix, 52, native=True))
        (kp, vp), res["vector_python_s"] = median_s(
            lambda: tio.load_vec_txt(prefix, 52, native=False))
        if not (np.array_equal(kn, kp) and np.array_equal(kn, keys)
                and np.array_equal(vn.view(np.int64), vp.view(np.int64))
                and np.array_equal(vn, vals)):
            raise AssertionError("native reader: vector files differ from the Python path")
    res["fcidump_speedup"] = res["fcidump_python_s"] / res["fcidump_native_s"]
    res["vector_speedup"] = res["vector_python_s"] / res["vector_native_s"]
    log(f"native reader: equal to the Python path bit for bit ({json.dumps(res)})")
    return res


def phase_trace(dev):
    """``fries_tpu_torch.profiling.trace`` and ``span`` around three
    steps of the 65-bit frisys_hh system on the card (last: a profiler slows
    its process's later launches): the Chrome trace names the region and
    holds kernel A's and B's device work."""
    import torch
    from fries_tpu_torch import _build, profiling
    from fries_tpu_torch.drivers import frisys_hh
    from fries_tpu_torch.ops import hubbard

    ham = hubbard.HubbardHolstein(n_sites=13, n_elec=13, ph_bits=3, u=1.5, omega=0.7, g=0.4)
    cfg = frisys_hh.FrisysHHConfig(eps=0.02, vec_nonz=60, matr_samp=200, capacity=1024,
                                   spawn_cap=320, target_norm=400.0, shift_interval=2)
    step, run_steps, state, aux = frisys_hh.build(ham, 0.1, cfg, seed=3, device=dev)
    args = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    logdir = _build.BUILD_DIR / "profiling_trace"
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        with profiling.span("frisys_hh 65 bits"):
            state, _ = run_steps(state, *args, 3)
            torch.cuda.synchronize()
    path = logdir / profiling.TRACE_NAME
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    kernels = {n for e, n in zip(events, names) if e.get("cat") == "kernel"}
    res = {"seconds": time.perf_counter() - t0, "trace_bytes": path.stat().st_size,
           "events": len(events),
           "merge_kernels": sorted(n for n in kernels if "merge_tiles" in n)[:2],
           "emit_kernels": sorted(n for n in kernels if "emit" in n)[:2]}
    if "frisys_hh 65 bits" not in names or not res["merge_kernels"] or not res["emit_kernels"]:
        raise AssertionError(f"profiling trace: region or kernels missing ({res})")
    log(f"profiling trace: {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# the integral pipeline and bench.py's real molecules
# ---------------------------------------------------------------------------

REAL_SYSTEMS = ("h2o_ccpvdz", "n2_ccpvdz", "n2_stretched", "ne_augccpvdz", "ne_ccpvqz")
CARD_VS_CPU = ("h2o_ccpvdz", "n2_ccpvdz")
E_NE_QZ = -128.54347011764926   # the JAX package's pipeline on a CPU


def phase_integrals(dev):
    """Build the five real systems on the card (AO integrals, RHF, MO
    transform; the seconds of each), H2O and N2 also on the CPU: card
    against CPU after the gauge alignment (hcore and ERIs within atol
    1e-10, E_HF within 1e-9 Ha, irreps equal); Ne/cc-pVQZ's total RHF
    energy against the reference pipeline's, within 1e-8 Ha, and its irreps
    against ``rung.NE_QZ_SYMM``.  Returns (results, {name: Hamiltonian on
    the card})."""
    import torch
    from fries_tpu_torch import real_systems, rung, scf

    res, hams = {}, {}
    for name in REAL_SYSTEMS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ham, info = real_systems.build(name, dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        if ham.hcore.device.type != "cuda" or ham.eris.device.type != "cuda":
            raise AssertionError(f"integrals {name}: not built on the card")
        t = ham.tot_orb
        if ham.hcore.shape != (t, t) or ham.eris.shape != (t,) * 4:
            raise AssertionError(f"integrals {name}: shapes {ham.hcore.shape} {ham.eris.shape}")
        if not (torch.isfinite(ham.hcore).all() and torch.isfinite(ham.eris).all()):
            raise AssertionError(f"integrals {name}: non-finite integrals")
        r = {"n_ao": int(info["C"].shape[0]), "n_orb": ham.n_orb, "n_elec": ham.n_elec,
             "n_frozen": ham.n_frozen, "e_hf_total": info["e_hf_total"],
             "seconds": {"one_electron": info["seconds"]["one_electron"],
                         "eri": info["seconds"]["eri"], "scf": info["seconds"]["scf"],
                         "mo_transform": info["seconds"]["mo_transform"], "total": total}}
        if name in CARD_VS_CPU:
            t0 = time.perf_counter()
            cham, cinfo = real_systems.build(name, "cpu")
            r["cpu_seconds"] = time.perf_counter() - t0
            de = abs(info["e_hf_total"] - cinfo["e_hf_total"])
            if not de < 1e-9:
                raise AssertionError(f"integrals {name}: E_HF card - CPU = {de}")
            if not (info["irreps"] == cinfo["irreps"]).all():
                raise AssertionError(f"integrals {name}: irreps differ")
            o, off = scf.gauge_alignment(info["C"].cpu(), cinfo["C"], cinfo["S"],
                                         cinfo["mo_energy"], cinfo["irreps"])
            hcore, eris = scf.rotate_mo_integrals(ham.hcore.cpu(), ham.eris.cpu(), o)
            dh = float((hcore - cham.hcore).abs().max())
            de2 = float((eris - cham.eris).abs().max())
            if not (off < 1e-8 and dh <= 1e-10 and de2 <= 1e-10):
                raise AssertionError(f"integrals {name}: card against CPU: off-block {off}, "
                                     f"hcore {dh}, eris {de2}")
            r["card_vs_cpu"] = {"e_hf": de, "off_block": off, "hcore": dh, "eris": de2}
        if name == "ne_ccpvqz":
            de = abs(info["e_hf_total"] - E_NE_QZ)
            if not de < 1e-8:
                raise AssertionError(f"integrals ne_ccpvqz: E_HF {info['e_hf_total']!r} is "
                                     f"{de} from the reference's {E_NE_QZ!r}")
            if tuple(ham.symm.tolist()) != rung.NE_QZ_SYMM:
                raise AssertionError(f"integrals ne_ccpvqz: irreps {ham.symm.tolist()} are not "
                                     "rung.NE_QZ_SYMM")
            r["e_hf_minus_reference"] = info["e_hf_total"] - E_NE_QZ
        res[name] = r
        hams[name] = ham
        log(f"integrals {name}: {json.dumps(r)}")
    return res, hams


def power_timed(label, step, state, args, n_warm, n_timed, per_step, cd_per_step=0,
                **step_kw):
    """``n_warm`` + ``n_timed`` steps of a power-method workload with the
    kernels' counts reset just before the timed ones, and the launches per
    step asserted to be ``per_step`` ({module name: launches}) and
    ``cd_per_step`` C+D plans of R + 3 kernel F launches each
    (:func:`check_plan_launches`); every step's overflow flag and
    estimator read.  Returns (state, results)."""
    import torch
    from fries_tpu_torch.runtime import emit, merge, merge_multi

    mods = {"merge": merge, "emit": emit, "merge_multi": merge_multi}
    for i in range(n_warm):
        state, m = step(state, *args, **step_kw)
        check_power_metrics(f"{label} warm-up", [m])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        reset_launches(mod)
    t0 = time.perf_counter()
    metrics = []
    with cd_plans() as seen:
        for _ in range(n_timed):
            state, m = step(state, *args, **step_kw)
            metrics.append(m)
        torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / n_timed
    launches = {k: kernel_launches(mod) for k, mod in mods.items()
                if kernel_launches(mod) or k in per_step}
    check_power_metrics(label, metrics)
    want = {k: v * n_timed for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} in {n_timed} steps, want {want}")
    plan_per_step = check_plan_launches(label, seen, n_timed, cd_per_step)
    last = metrics[-1]
    return state, {
        "ms_per_step": 1e3 * s_per_step, "s_per_step": s_per_step,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
        "launches_per_step": {**per_step, **plan_per_step}, "warm_up_steps": n_warm,
        "timed_steps": n_timed,
        "overflow": any(bool(m["overflow"]) for m in metrics),
        "n_dets_timed_steps": [int(m["n_dets"]) for m in metrics],
        "norm": float(last["norm"]), "shift": float(last["shift"]),
        "e_corr_est": float(last["proj_num"]) / float(last["proj_den"])}


def phase_rung_real(dev, ham):
    """``rung_real``: the 1e6 rung on real N2/cc-pVDZ, 2 warm-up + 5 timed
    steps (1 kernel A and 3 kernel B launches per step asserted), then a
    real step's merge input through kernel A and the three emission plans
    of that step (A+B, C+D factored, E) through kernel B, each against its
    plain version.  Returns (results, merge case, {round: plan})."""
    import torch
    from fries_tpu_torch import rung

    t0 = time.perf_counter()
    step, state, args, aux = rung.build_real(dev, ham=ham)
    torch.cuda.synchronize()
    log(f"rung_real: built in {time.perf_counter() - t0:.1f} s (real N2/cc-pVDZ, "
        f"{ham.n_orb} orbitals, {ham.n_elec} electrons, {ham.n_frozen} frozen, capacity "
        f"{rung.CAPACITY}, spawn_cap {rung.SPAWN_CAP})")
    state, r = power_timed("rung_real", step, state, args, N_WARM, N_TIMED,
                           {"merge": 1, "emit": 3}, cd_per_step=1)
    r.update(config="rung_real", sampled_nonzeros_per_s=rung.N_SAMP / r.pop("s_per_step"))
    log(f"rung_real: {json.dumps(r)}")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(21)
    rns = torch.rand(6, dtype=torch.float64, generator=gen).to(dev)
    case, plans = capture_emissions(power_merge_input, state, aux, rung.EPS, rns)
    if len(plans) != 3:
        raise AssertionError(f"rung_real: {len(plans)} emissions in one spawn")
    plans = dict(zip(("rung_real A+B", "rung_real C+D", "rung_real E"), plans))
    r["emit_checks"] = {
        name: check_emit(f"{name}, a real step's plan (N={plan['offsets'].shape[0]})", plan,
                         need_kept=False) for name, plan in plans.items()}
    r["real_step"] = {**merge_stream_stats(case[0], case[1]),
                      **check_merge("rung_real, a real step's stream, (2,0,1) + keep_mask",
                                    *case[:4], None, case[4])}
    log(f"rung_real real step: {json.dumps(r['real_step'])}")
    return r, case, plans


def with_protected(a, keep, prot):
    """``keep`` (the reference's row) with the rows of the protected keys
    ``prot`` set: the semistochastic step's keep mask."""
    import torch
    from fries_tpu_torch.runtime import arena as ar

    pos, found = ar.lookup(a, prot)
    mask = torch.zeros(a.capacity + 1, dtype=torch.bool, device=a.keys.device)
    mask.index_fill_(0, torch.where(found, pos, a.capacity), True)
    return keep | mask[:a.capacity]


def phase_semistoch_cisd(dev, ham):
    """``semistoch_cisd``: the CISD on the card (its seconds), the 150
    largest-|c| determinants as the deterministic space, 2 warm-up + 5
    timed steps with the protected keep bits (1 kernel A and 3 kernel B
    launches per step asserted), then a real step's merge input through
    kernel A and its plain version.  Returns (results, merge case)."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import arena as ar

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, state, args, aux = rung.build_semistoch_cisd(dev, ham=ham)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prot = aux["protected_keys"]
    n_el = aux["n_elements"]
    log(f"semistoch_cisd: CISD and build in {build_s:.1f} s (E_CISD - E_HF "
        f"{aux['e_cisd']:.10f}, {prot.shape[0]} deterministic determinants, {n_el} dense "
        f"elements, sampling budget {rung.N_SAMP - n_el}, merge S = {rung.SPAWN_CAP + n_el})")
    if prot.shape[0] != rung.N_DETERM or not 0 < n_el < rung.DETERM_MAX_SHARE * rung.N_SAMP:
        raise AssertionError(f"semistoch_cisd: {prot.shape[0]} determinants, {n_el} elements")
    state, r = power_timed("semistoch_cisd", step, state, args, N_WARM, N_TIMED,
                           {"merge": 1, "emit": 3}, cd_per_step=1, protected_keys=prot)
    if not bool(ar.lookup(state.arena, prot)[1].all()):
        raise AssertionError("semistoch_cisd: a protected determinant left the arena")
    r.update(config="semistoch_cisd", n_determ=prot.shape[0], n_elements=n_el,
             e_cisd=aux["e_cisd"], cisd_and_build_s=build_s,
             sampled_nonzeros_per_s=(rung.N_SAMP - n_el) / r.pop("s_per_step"))
    log(f"semistoch_cisd: {json.dumps(r)}")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(22)
    rns = torch.rand(6, dtype=torch.float64, generator=gen).to(dev)
    a, w, amp, ini, keep = power_merge_input(state, aux, rung.EPS, rns)
    case = (a, w, amp, ini, with_protected(a, keep, prot))
    r["real_step"] = {**merge_stream_stats(a, w),
                      **check_merge("semistoch_cisd, a real step's stream, (2,0,1) + protected "
                                    "keep bits", a, w, amp, ini, None, keep)}
    log(f"semistoch_cisd real step: {json.dumps(r['real_step'])}")
    return r, case


FLAGSHIP_FLAGS = ("--system", "ne", "--budget", "150000", "--determ", "50", "--initiator",
                  "1.0", "--burn", "4000", "--seed", "20", "--scan", "25", "--block", "50",
                  "--save_interval", "100")
FLAGSHIP_ITERS = 200


def read_streams(path):
    """{stream name: its lines} of a flagship result directory."""
    from fries_tpu_torch import flagship

    return {name: (path / f"{name}.txt").read_text().splitlines()
            for name in flagship.STREAMS}


def phase_flagship(dev):
    """The flagship run on Ne/aug-cc-pVDZ (phase 17e).  Returns (results,
    the merge case of a real step, its emission plans by name)."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    from fries_tpu_torch import flagship
    from fries_tpu_torch.drivers import frisys
    from fries_tpu_torch.runtime import checkpoint, emit, merge, merge_multi

    tmp = Path(tempfile.mkdtemp(prefix="flagship_"))
    meta = flagship.SYSTEMS["ne"]
    args = lambda name, *extra: flagship.parser().parse_args(
        [*FLAGSHIP_FLAGS, "--result_dir", str(tmp / name), *extra])
    try:
        torch.cuda.synchronize()
        ham, words, vals, e_cisd, info = flagship.build_system("ne", dev)
        lines = []
        runs = {}
        mods = {"merge": merge, "emit": emit, "merge_multi": merge_multi}
        for mod in mods.values():
            reset_launches(mod)
        try:
            with cd_plans() as seen:
                runs["straight"] = flagship.run(ham, (words, vals),
                                                args("straight", "--iters", str(FLAGSHIP_ITERS)),
                                                meta, e_cisd=e_cisd, log=lines.append)
            launches = {k: kernel_launches(mod) for k, mod in mods.items()}
            plan_per_step = check_plan_launches("flagship", seen, FLAGSHIP_ITERS, 1)
            half = str(FLAGSHIP_ITERS // 2)
            flagship.run(ham, (words, vals), args("resumed", "--iters", half), meta,
                         e_cisd=e_cisd, log=lines.append)
            runs["resumed"] = flagship.run(
                ham, (words, vals), args("resumed", "--iters", str(FLAGSHIP_ITERS),
                                         "--load_dir", str(tmp / "resumed")),
                meta, e_cisd=e_cisd, log=lines.append)
        except SystemExit as err:
            raise AssertionError(f"flagship: {err}") from None
        want = {"merge": FLAGSHIP_ITERS, "emit": 3 * FLAGSHIP_ITERS, "merge_multi": 0}
        if launches != want:
            raise AssertionError(f"flagship: launches {launches} in {FLAGSHIP_ITERS} "
                                 f"iterations, want {want}")
        straight, resumed = read_streams(tmp / "straight"), read_streams(tmp / "resumed")
        for name, got in straight.items():
            x = torch.tensor([float(v) for v in got], dtype=torch.float64)
            if len(got) != FLAGSHIP_ITERS or not bool(torch.isfinite(x).all()):
                raise AssertionError(f"flagship: {name}.txt holds {len(got)} lines, finite "
                                     f"{bool(torch.isfinite(x).all())}")
            if resumed[name] != got:
                raise AssertionError(f"flagship: the resumed {name}.txt differs from the "
                                     "straight run's")
        r = runs["straight"]
        if "diagnosis" not in r or r["n_independent_samples"] >= flagship.MIN_INDEPENDENT:
            raise AssertionError(f"flagship: the gate passed {FLAGSHIP_ITERS} iterations "
                                 f"({r['n_independent_samples']} independent samples)")
        if runs["resumed"]["unconverged_estimate_mEh"] != r["unconverged_estimate_mEh"]:
            raise AssertionError("flagship: the resumed run's statistics differ")
        res = {"config": r["config"], "iterations": FLAGSHIP_ITERS,
               "ms_per_step": 1e3 * r["sec_per_iter"], "peak_mem_bytes": r["peak_mem_bytes"],
               "launches": {k: v for k, v in launches.items() if v},
               "launches_per_step": {"merge": 1, "emit": 3, **plan_per_step},
               "build_s": info["build_s"], "cisd_s": info["cisd_s"],
               "frisys_build_s": r["build_s"], "n_cisd": info["n_cisd"],
               "e_hf_total": info["e_hf_total"], "e_cisd_corr": e_cisd,
               "n_dets_final": r["n_dets_final"], "norm_final": r["norm_final"],
               "norm_max_over_target": r["norm_max_over_target"],
               "iat": r["iat"], "unconverged_estimate_mEh": r["unconverged_estimate_mEh"],
               "diagnosis": r["diagnosis"],
               "resumed_ms_per_step": 1e3 * runs["resumed"]["sec_per_iter"]}
        log(f"flagship: {json.dumps({k: v for k, v in res.items() if k != 'diagnosis'})}")
        log(f"flagship seconds: build {info['build_s']:.3f}, CISD {info['cisd_s']:.3f} "
            f"({info['n_cisd']} determinants), frisys.build {r['build_s']:.3f}; "
            f"{res['ms_per_step']:.2f} ms/step over {FLAGSHIP_ITERS} iterations")
        log("flagship progress:\n" + "\n".join(x for x in lines if x.startswith("# blk")))

        # the path's own tensors: iteration 200's state, one more step's inputs
        run_args = args("straight")
        cfg, trial, init_vec, determ = flagship.prepare(words, vals, run_args, meta)
        _, _, state, aux = frisys.build(ham, cfg, seed=run_args.seed, trial=trial,
                                        init_vec=init_vec, determ_keys=determ)
        state = checkpoint.restore(str(tmp / "straight" / "checkpoint.npz"), state)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(23)
    rns = torch.rand(6, dtype=torch.float64, generator=gen).to(dev)
    case, plans = capture_emissions(power_merge_input, state, aux, cfg.eps, rns)
    if len(plans) != 3:
        raise AssertionError(f"flagship: {len(plans)} emissions in one spawn")
    plans = dict(zip(("flagship A+B", "flagship C+D", "flagship E"), plans))
    res["emit_checks"] = {
        name: check_emit(f"{name}, a real step's plan (N={plan['offsets'].shape[0]})", plan,
                         need_kept=False) for name, plan in plans.items()}
    a, w, amp, ini, keep = case
    case = (a, w, amp, ini, with_protected(a, keep, aux["protected_keys"]))
    res["real_step"] = {**merge_stream_stats(a, w),
                        **check_merge("flagship, a real step's stream, (2,0,1) + protected "
                                      "keep bits", *case[:4], None, case[4])}
    log(f"flagship real step: {json.dumps(res['real_step'])}")
    return res, case, plans


ANCHOR_E0 = -15.340561820     # the JAX package's Lanczos record (PARITY.md:124-133)
ANCHOR_DIM = 48_400
ANCHOR_ITERS, ANCHOR_BLOCK = 300, 25
FCIDUMP_FLAGS = ["--epsilon", "0.02", "--vec_nonz", "200", "--mat_nonz", "1000",
                 "--max_dets", "16384", "--target", "400", "--seed", "3"]
FCIDUMP_ITERS = 40


def phase_anchor(dev):
    """The 48,400-determinant anchor (phase 17f, ``fries_tpu_torch.
    anchor_scale`` at its defaults): the Lanczos at full dimension (E0
    against the JAX record within 1e-8 Ha, seconds), 300 iterations in
    blocks of 25 with the kernels' counts reset just before (1 kernel A and
    3 kernel B launches per iteration asserted, no overflow, finite
    estimators, ms/step), then the state stepped once more with fixed
    uniforms: its merge input through kernel A and its three emission plans
    through kernel B, against their plain versions.  Returns (results, the
    merge case, {round: plan})."""
    import torch
    from fries_tpu_torch import anchor_scale, synth
    from fries_tpu_torch.drivers import frisys
    from fries_tpu_torch.runtime import emit, merge, merge_multi

    args = anchor_scale.parser().parse_args([])
    ham = synth.make_system(args.n_orb, args.n_elec, seed=args.seed, scale_two=0.1,
                            device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    half = args.n_elec // 2
    e0, ritz, basis = anchor_scale.exact_energy(ham, half, args.n_elec - half,
                                                m=args.lanczos_m)
    torch.cuda.synchronize()
    lanczos_s = time.perf_counter() - t0
    if basis.shape[0] != ANCHOR_DIM or abs(e0 - ANCHOR_E0) > 1e-8:
        raise AssertionError(f"anchor: Lanczos E0 {e0!r} over {basis.shape[0]} determinants, "
                             f"want {ANCHOR_E0} over {ANCHOR_DIM}")
    cfg = anchor_scale.anchor_config(args)
    _, run_steps, state, aux = frisys.build(
        ham, cfg, seed=args.seed + 1, trial=anchor_scale.ritz_trial(basis, ritz, args.trial_k))
    est = [aux[k] for k in ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")]
    mods = {"merge": merge, "emit": emit, "merge_multi": merge_multi}
    for mod in mods.values():
        reset_launches(mod)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trajs = []
    with cd_plans() as seen:
        for _ in range(ANCHOR_ITERS // ANCHOR_BLOCK):
            state, traj = run_steps(state, *est, ANCHOR_BLOCK)
            trajs.append(traj)
        torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / ANCHOR_ITERS
    launches = {k: kernel_launches(mod) for k, mod in mods.items()}
    want = {"merge": ANCHOR_ITERS, "emit": 3 * ANCHOR_ITERS, "merge_multi": 0}
    if launches != want:
        raise AssertionError(f"anchor: launches {launches}, want {want}")
    plan_per_step = check_plan_launches("anchor", seen, ANCHOR_ITERS, 1)
    traj = {k: torch.cat([t[k].reshape(-1) for t in trajs]) for k in trajs[0]}
    if bool(traj["overflow"].any()):
        raise AssertionError("anchor: arena overflow")
    for k in ("proj_num", "proj_den", "norm", "shift"):
        if not bool(torch.isfinite(traj[k]).all()):
            raise AssertionError(f"anchor: non-finite {k}")
    num, den = traj["proj_num"][-100:].double(), traj["proj_den"][-100:].double()
    res = {"dimension": int(basis.shape[0]), "lanczos_e0": e0, "lanczos_s": lanczos_s,
           "e0_minus_jax_record": e0 - ANCHOR_E0, "iterations": ANCHOR_ITERS,
           "ms_per_step": 1e3 * s_per_step, "s_per_step": s_per_step,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "launches": {k: v for k, v in launches.items() if v},
           "launches_per_step": {"merge": 1, "emit": 3, **plan_per_step},
           "n_dets_final": int(traj["n_dets"][-1]), "norm_final": float(traj["norm"][-1]),
           "e_corr_last_100": float(num.sum() / den.sum()),
           "exact_corr": e0 - float(aux["e_ref"])}
    log(f"anchor: {json.dumps(res)}")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(29)
    rns = torch.rand(6, dtype=torch.float64, generator=gen).to(dev)
    case, plans = capture_emissions(power_merge_input, state, aux, cfg.eps, rns)
    if len(plans) != 3:
        raise AssertionError(f"anchor: {len(plans)} emissions in one spawn")
    plans = dict(zip(("anchor A+B", "anchor C+D", "anchor E"), plans))
    res["emit_checks"] = {
        name: check_emit(f"{name}, a real step's plan (N={plan['offsets'].shape[0]})", plan,
                         need_kept=False) for name, plan in plans.items()}
    res["real_step"] = {**merge_stream_stats(case[0], case[1]),
                        **check_merge("anchor, a real step's stream, (2,0,1) + keep_mask",
                                      *case[:4], None, case[4])}
    log(f"anchor real step: {json.dumps(res['real_step'])}")
    return res, case, plans


def phase_fcidump_tools(dev):
    """``make_fcidump`` and ``derive_ccpvqz`` on the card (phase 17f):
    water's FCIDUMP written from integrals built on the card, read back by
    both readers (equal bit for bit, and to the card's integrals within
    1e-12), then ``frisys_mol`` on it through the command line for 40
    iterations (1 kernel A and 3 kernel B launches per iteration, no
    overflow, finite estimators; the last iteration's merge and emissions
    through the kernels and their plain versions); the Ne cc-pVQZ
    derivation's E_HF just below the literature -128.543470 Ha and its rows
    ``basis.py``'s to 5e-7."""
    import contextlib
    import io as pyio
    import os
    import tempfile

    import numpy as np
    import torch
    from fries_tpu_torch import basis, cli, derive_ccpvqz, gto, make_fcidump
    from fries_tpu_torch import io as tio
    from fries_tpu_torch.runtime import emit, merge

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "FCIDUMP_h2o")
        out = pyio.StringIO()
        with contextlib.redirect_stdout(out):
            make_fcidump.main(["water", "--out", path])
        ham, core = gto.water(device=dev)
        (hn, cn), (hp, cp) = (tio.parse_fcidump(path, native=n) for n in (True, False))
        if not (torch.equal(hn.hcore, hp.hcore) and torch.equal(hn.eris, hp.eris) and cn == cp):
            raise AssertionError("make_fcidump: the two readers differ")
        err = max(float((hp.hcore - ham.hcore.cpu()).abs().max()),
                  float((hp.eris - ham.eris.cpu()).abs().max()), abs(cp - core))
        if err > 1e-12:
            raise AssertionError(f"make_fcidump: the file is {err} from the card's integrals")
        res["make_fcidump"] = {"line": out.getvalue().strip(), "max_abs_err": err}
        store = {}
        reset_launches(merge, emit)
        run_dir = os.path.join(tmp, "run")
        with capture_kernel_inputs(store), contextlib.redirect_stdout(pyio.StringIO()):
            cli.main(["frisys_mol", "--fcidump_path", path, *FCIDUMP_FLAGS, "--max_iter",
                      str(FCIDUMP_ITERS), "--result_dir", run_dir])
        launches = {"merge": kernel_launches(merge), "emit": kernel_launches(emit)}
        if launches != {"merge": FCIDUMP_ITERS, "emit": 3 * FCIDUMP_ITERS}:
            raise AssertionError(f"frisys_mol on the FCIDUMP: launches {launches}")
        num = np.loadtxt(os.path.join(run_dir, "projnum.txt"))
        den = np.loadtxt(os.path.join(run_dir, "projden.txt"))
        if num.shape != (FCIDUMP_ITERS,) or not (np.isfinite(num).all()
                                                 and np.isfinite(den).all()):
            raise AssertionError(f"frisys_mol on the FCIDUMP: streams {num.shape}")
    store = {"merge": store["merge"][-1:], "emit": store["emit"][-3:]}
    res["frisys_mol"] = {"iterations": FCIDUMP_ITERS, "launches": launches,
                         "e_corr_last_20": float(num[-20:].sum() / den[-20:].sum()),
                         "kernel_vs_plain_max_abs_err": check_captured(
                             "frisys_mol on water's FCIDUMP, the last iteration's", store)}
    e, rows = derive_ccpvqz.contractions(basis._NE_QZ_S_EXP, basis._NE_QZ_P_EXP, dev)
    diff = {k: float(np.abs(rows[k] - v).max()) for k, v in derive_ccpvqz.BASIS_ROWS.items()}
    if not -128.5435 < e < derive_ccpvqz.E_HF_LITERATURE or max(diff.values()) > 5e-7:
        raise AssertionError(f"derive_ccpvqz: E_HF {e!r}, rows against basis.py {diff}")
    res["derive_ccpvqz"] = {"e_hf": e, "max_abs_diff_from_basis_py": diff}
    log(f"science tools: {json.dumps(res)}")
    return res


def phase_frifull_real(dev, full):
    """``frifull_real``: real H2O/cc-pVDZ sliced to (10e, 12o), 2 warm-up +
    5 timed steps (48 kernel A launches per step asserted), then one real
    chunk's stream (the second chunk of the next step, dedup'd as the step
    does) merged by kernel A and its plain version into the arena holding
    the first chunk's sums.  Returns (results, that chunk's case)."""
    import torch
    from fries_tpu_torch import dets, rung
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import merge

    cfg = rung.frifull_real_config()
    n_chunks = -(-cfg.spawn_rows // cfg.batch)
    ham = rung.frifull_real_system(dev, full=full)
    t0 = time.perf_counter()
    step, state, args, aux = rung.build_frifull_real(dev, ham=ham)
    torch.cuda.synchronize()
    s_chunk = cfg.batch * aux["n_excitations"]
    log(f"frifull_real: built in {time.perf_counter() - t0:.1f} s (real H2O/cc-pVDZ, "
        f"({ham.n_elec}e, {ham.n_orb}o), capacity {cfg.capacity}, {n_chunks} chunks of "
        f"{cfg.batch} rows, {aux['n_excitations']} template excitations, S = {s_chunk} per "
        f"chunk, dedup_cap {cfg.dedup_cap})")
    state, r = power_timed("frifull_real", step, state, args, N_WARM, N_TIMED,
                           {"merge": n_chunks})
    s_per_step = r.pop("s_per_step")
    r.update(config="frifull_real", merge_launches_per_step=n_chunks, spawns_per_chunk=s_chunk,
             candidates_per_s=n_chunks * s_chunk / s_per_step)
    log(f"frifull_real: {json.dumps(r)}")
    a = state.arena
    vals0 = torch.where(a.valid, a.vals[0], 0.0)
    sentinel = dets.invalid_det(a.n_words, dev)
    streams = []
    for i in range(2):
        rows = slice(i * cfg.batch, (i + 1) * cfg.batch)
        w, amp, ini = aux["spawn"](a.keys[rows], vals0[rows], -cfg.eps, None)
        w = torch.where((amp != 0)[:, None], w, sentinel)
        w, amp, ini, _ = ar.dedup_spawns(w, amp, ini, cfg.dedup_cap)
        streams.append((w, amp, ini))
    mid, _ = merge.accumulate(a, *streams[0], 0, 1)
    r["real_chunk"] = {**merge_stream_stats(mid, streams[1][0]),
                       **check_merge("frifull_real, a real chunk's dedup'd stream into the "
                                     "arena after chunk 0", mid, *streams[1], None, None)}
    log(f"frifull_real real chunk: {json.dumps(r['real_chunk'])}")
    return r, (mid, *streams[1], None)


def phase_fciqmc_real(dev, ham):
    """``fciqmc_real``: ``rung.fciqmc_config`` on real stretched N2 as
    bench.py schedules it (12 blocks of 5 warm-up steps, 5 timed; 1 kernel
    A launch per step asserted), a real step's merge input through kernel A
    and its plain version (exact); then bench.py's own values
    (``fciqmc_config(bench_values=True)``: capacity 2^21, shift interval
    10) for bench.py's 65 iterations, with the first overflow logged.
    Returns (results, the merge case)."""
    import torch
    from fries_tpu_torch import rung

    cfg = rung.fciqmc_config()
    t0 = time.perf_counter()
    step, state, args, aux = rung.build_fciqmc_real(dev, ham=ham)
    torch.cuda.synchronize()
    log(f"fciqmc_real: built in {time.perf_counter() - t0:.1f} s (real N2 r = 4.2, "
        f"{ham.n_orb} orbitals, {ham.n_elec} electrons, capacity {cfg.capacity}, attempt_cap "
        f"{cfg.attempt_cap}, {rung.FCIQMC_INIT_WALKERS:.0f} walkers on HF)")
    state, r = power_timed("fciqmc_real", step, state, args, 60, N_TIMED, {"merge": 1})
    s_per_step = r.pop("s_per_step")
    r.update(config="fciqmc_real", walker_iterations_per_s=r["norm"] / s_per_step,
             ns_per_walker_iteration=1e9 * s_per_step / r["norm"],
             merge_launches_per_step=1)
    log(f"fciqmc_real: {json.dumps(r)}")
    case = aux["merge_input"](state)
    r["real_step"] = {**merge_stream_stats(case[0], case[1]),
                      **check_merge("fciqmc_real, a real step's post-death arena and spawn "
                                    "stream, (1,0,0), exact", *case, None, None, exact=True)}
    log(f"fciqmc_real real step: {json.dumps(r['real_step'])}")
    del step, state
    step, state, args, _ = rung.build_fciqmc_real(dev, ham=ham, bench_values=True)
    first = None
    norms = []
    for i in range(65):
        state, m = step(state, *args)
        if i % 5 == 4:
            norms.append(float(m["norm"]))
        if bool(m["overflow"]):
            first = i
            break
    r["bench_values"] = {"capacity": rung.fciqmc_config(True).capacity, "shift_interval": 10,
                         "iterations": 65, "first_overflow_iteration": first,
                         "norm_every_5": norms, "n_dets": int(m["n_dets"])}
    log(f"fciqmc_real with bench.py's values: {json.dumps(r['bench_values'])}")
    return r, (*case, None)


REAL_PROFILES = ("rung_real", "semistoch_cisd", "ne_qz", "ne_qz_unnorm", "ne_qz_subsp",
                 "frifull_real", "fciqmc_real", "rung_real_sharded", "subsp_sharded",
                 "ne2_qz", "ne2_qz_subsp", "frisys_hh_wide")


def phase_real_profiles(dev):
    """``python -m fries_tpu_torch.profile_step --workload W`` for each real
    configuration, one child process each (a profiler slows every later
    launch of its process, so none runs in this one): device busy ms and
    idle share per step, host synchronizations, the largest phases."""
    import os

    import torch
    from fries_tpu_torch import _build

    gc.collect()
    torch.cuda.empty_cache()
    res = {}
    for w in REAL_PROFILES:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "fries_tpu_torch.profile_step",
                              "--workload", w, "--steps", "2", "--trace",
                              str(_build.BUILD_DIR / f"profile_{w}.json")],
                             capture_output=True, text=True, timeout=600,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        if out.returncode != 0:
            raise AssertionError(f"profile_step {w} failed:\n{out.stderr[-3000:]}")
        rep = json.loads(out.stdout[out.stdout.index("{\n"):])
        phases = sorted(rep["phase_busy_ms_per_step"].items(), key=lambda kv: -kv[1])[:8]
        res[w] = {k: rep[k] for k in ("wall_ms_per_step", "device_busy_ms_per_step",
                                      "device_idle_share", "device_ops_per_step",
                                      "host_syncs_per_step")}
        res[w]["top_phases_ms_per_step"] = phases
        res[w]["exchange_ms_per_step"] = {k: v for k, v in rep["phase_busy_ms_per_step"].items()
                                          if k.startswith("fries.exchange")}
        res[w]["seconds"] = time.perf_counter() - t0
        log(f"profile {w}: {json.dumps(res[w])}")
    return res


# ---------------------------------------------------------------------------
# hash sharding
# ---------------------------------------------------------------------------

SHARD_RANKS = 2
SHARD_WARM = 2
SHARD_FIXED = 2
SHARD_TIMED = 5
SUBSP_SHARD_TIMED = 3
SHARD_STREAM = "shard_stream.pt"


@contextlib.contextmanager
def patched(*targets):
    """Each ``(module, name, wrap)``: ``module.name`` replaced by
    ``wrap(module.name)`` for the block, and restored after it."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for (mod, name, wrap), (_, _, orig) in zip(targets, saved):
        setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)


def plain_kernels():
    """The kernel wrappers replaced by their plain versions, which run on
    card tensors as they are (for the kernels' comparison only)."""
    from fries_tpu_torch.runtime import arena, emit, merge, merge_multi

    return patched((merge, "accumulate", lambda _: merge.accumulate_plain),
                   (emit, "emit", lambda _: emit.emit_plain),
                   (emit, "emit_factored", lambda _: emit.emit_factored_plain),
                   (merge_multi, "accumulate", lambda _: arena.accumulate_multi),
                   *plain_plan_targets())


def timed_exchanges(times):
    """CUDA events around every spawn exchange of the power core and the
    subspace step; ``times`` gets (start, end) pairs."""
    import torch
    from fries_tpu_torch.drivers import power

    def wrap(fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            times.append((start, end))
            return out
        return timed
    return patched((power, "exchange_spawns", wrap))


def shard_offsets(seen):
    """Record the first parent's grid offset (``cum_parent[0]``) of every
    emission; ``seen`` gets the values."""
    from fries_tpu_torch.runtime import emit

    def wrap(fn):
        def rec(**plan):
            seen.append(float(plan["cum_parent"][0]))
            return fn(**plan)
        return rec
    return patched((emit, "emit", wrap), (emit, "emit_factored", wrap))


def count_syncs(fn):
    """Host synchronizations of one ``fn()`` (sync debug mode warnings)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


# the stages of a step whose inputs and outputs the reproducibility check
# hashes, in call order: the first entry that differs between two runs
# from one seed names the operation that is not reproducible
REPRO_STAGES = (
    ("fries_tpu_torch.drivers.power", ("draw_uniforms", "exchange_spawns")),
    ("fries_tpu_torch.compress", ("find_preserve", "sys_comp", "_norm_over_ranks",
                                  "_threshold_fixpoint", "_grid_layout", "comp_sub_plan",
                                  "comp_sub_factored_plan")),
    ("fries_tpu_torch.runtime.emit", ("emit", "emit_factored")),
    ("fries_tpu_torch.runtime.shard", ("exchange_ragged", "exchange_dense")),
    ("fries_tpu_torch.runtime.merge", ("accumulate",)),
)


def tensor_digests(obj):
    """Short hashes of the bytes of every tensor in ``obj`` (nested tuples,
    lists, dicts and dataclasses), in order."""
    import dataclasses
    import hashlib

    import torch

    if isinstance(obj, torch.Tensor):
        data = obj.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
        return [hashlib.blake2b(data.tobytes(), digest_size=6).hexdigest()]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [h for x in obj for h in tensor_digests(x)]
    return []


def stage_records(records):
    """Every function of ``REPRO_STAGES`` (where the module has it) appends
    (name, input digests, output digests) to ``records`` for the block."""
    import importlib

    def wrap(name):
        def w(fn):
            def rec(*args, **kwargs):
                din = tensor_digests([args, kwargs])
                out = fn(*args, **kwargs)
                records.append((name, din, tensor_digests(out)))
                return out
            return rec
        return w
    targets = []
    for mod_name, names in REPRO_STAGES:
        mod = importlib.import_module(mod_name)
        targets += [(mod, n, wrap(f"{mod_name.rsplit('.', 1)[1]}.{n}"))
                    for n in names if hasattr(mod, n)]
    return patched(*targets)


def repro_warmups(label, build, n_steps, n_runs=2):
    """``n_runs`` runs of ``build()`` (-> step, state, est) and ``n_steps``
    steps from it, every stage hashed: each run's arena (keys, values,
    n_used) and metrics must equal the first run's bit for bit, else it
    raises and names the first stage whose inputs or outputs differ.
    Returns {"equal", "runs", "steps", "stage_calls"}."""
    runs = []
    for _ in range(n_runs):
        records = []
        with stage_records(records):
            step, state, est = build()
            metrics = []
            for _ in range(n_steps):
                state, m = step(state, *est)
                metrics.append(m)
        runs.append((tensor_digests([state.arena, metrics]), records))
    first = None
    for k, (final, records) in enumerate(runs[1:], 1):
        if final == runs[0][0]:
            continue
        for i, (a, b) in enumerate(zip(runs[0][1], records)):
            if a != b:
                side = "inputs" if a[1] != b[1] else "outputs"
                pos = next(j for j, (x, y) in enumerate(zip(a[1 if side == "inputs" else 2],
                                                            b[1 if side == "inputs" else 2]))
                           if x != y)
                first = f"run {k}: stage call {i} {a[0]} ({side}, tensor {pos}) differs"
                break
        first = first or f"run {k}: final arena differs, every hashed stage equal"
        break
    if first is not None:
        raise AssertionError(f"{label}: not reproducible: {first}")
    return {"equal": True, "runs": n_runs, "steps": n_steps, "stage_calls": len(runs[0][1])}


def repro_rung_real(shards, ham):
    """``rung_real_sharded``'s warm-up on this rank, twice from one seed,
    against itself (:func:`repro_warmups`)."""
    from fries_tpu_torch import rung

    def build():
        step, state, est, _ = rung.build_real_sharded(shards, ham=ham)
        return step, state, est
    return repro_warmups(f"rung_real_sharded rank {shards.rank} of {shards.size}", build,
                         SHARD_WARM)


def built_twice(device):
    """Real N2/cc-pVDZ built twice on ``device``: (the first build, whether
    the two builds' integrals are equal bit for bit)."""
    from fries_tpu_torch import real_systems

    ham = real_systems.n2_ccpvdz(device)
    again = real_systems.n2_ccpvdz(device)
    return ham, tensor_digests([ham.hcore, ham.eris]) == tensor_digests([again.hcore, again.eris])


def probe_collectives(shards):
    """Each collective on CUDA tensors of this world, its values checked:
    {name: None, or the error}."""
    import torch
    import torch.distributed as dist

    n, r, dev = shards.size, shards.rank, shards.device
    x = torch.arange(2 * n, dtype=torch.float64, device=dev) + 100 * r
    base = torch.arange(2 * n, dtype=torch.float64, device=dev)
    every = torch.stack([base + 100 * j for j in range(n)])

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y, every.sum(0)

    def all_gather():
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x)
        return torch.stack(out), every

    def all_to_all_single():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y, every[:, 2 * r:2 * r + 2].reshape(-1)
    out = {}
    for fn in (all_reduce, all_gather, all_to_all_single):
        try:
            got, want = fn()
            torch.cuda.synchronize()
            out[fn.__name__] = None if torch.equal(got, want) else "wrong values"
        except Exception as e:   # a refusal is what the probe reports
            out[fn.__name__] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def exchange_check(shards, path):
    """Rank r's half of a real spawn stream through both exchanges: every
    live row on the rank its hash names, once; the same multiset from both
    paths; times."""
    import torch
    from fries_tpu_torch import dets
    from fries_tpu_torch.runtime import shard as sh

    n, r, dev = shards.size, shards.rank, shards.device
    blob = torch.load(path)
    s = blob["words"].shape[0]
    rows = slice(r * s // n, (r + 1) * s // n)
    arrays = {"keys": blob["words"][rows].to(dev), "amps": blob["amps"][rows].to(dev),
              "ini": blob["ini"][rows].to(dev)}
    tgt = sh.shard_of_words(arrays["keys"], n)
    live = ~dets.is_invalid(arrays["keys"])
    cap = max(1, 2 * tgt.shape[0] // n)
    mix = lambda k: (k * torch.tensor([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F],
                                      device=dev)[:k.shape[1]]).sum(1)
    # what each rank sends to each destination: (count, key checksum) and the
    # amplitude sum
    sent = torch.stack([torch.stack([(live & (tgt == d)).sum(),
                                     torch.where(live & (tgt == d), mix(arrays["keys"]), 0).sum()])
                        for d in range(n)])
    sent_amp = torch.stack([torch.where(live & (tgt == d), arrays["amps"], 0.0).sum()
                            for d in range(n)])
    to_me, amp_to_me = shards.gather(sent)[:, r].sum(0), shards.gather(sent_amp)[:, r].sum()
    res = {"rows_sent": int(live.sum())}
    for mode, fn, c in (("ragged", sh.exchange_ragged, n * cap),
                        ("dense", sh.exchange_dense, cap)):
        times = []
        for _ in range(3):
            shards.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec, ovf = fn(arrays, tgt, n, c, shards)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        if bool(ovf):
            raise AssertionError(f"exchange {mode}: overflow at {c} rows")
        got = ~dets.is_invalid(rec["keys"])
        if not bool((sh.shard_of_words(rec["keys"][got], n) == r).all()):
            raise AssertionError(f"exchange {mode}: a row on rank {r} that it does not own")
        mine = torch.stack([got.sum(), torch.where(got, mix(rec["keys"]), 0).sum()])
        amp = torch.where(got, rec["amps"], 0.0).sum()
        if not torch.equal(mine, to_me) or not torch.isclose(amp, amp_to_me, rtol=1e-12):
            raise AssertionError(f"exchange {mode}: rank {r} received {mine.tolist()}, "
                                 f"{float(amp)}; sent to it {to_me.tolist()}, "
                                 f"{float(amp_to_me)}")
        order = dets.sort_dets(rec["keys"][got])
        res[mode] = {"ms": sorted(times)[1], "rows_received": int(got.sum()),
                     "rows": (rec["keys"][got][order].cpu(), rec["amps"][got][order].cpu(),
                              rec["ini"][got][order].cpu())}
    for a, b in zip(res["ragged"].pop("rows"), res["dense"].pop("rows")):
        if not torch.equal(a, b):
            raise AssertionError(f"exchange: ragged and dense differ on rank {r}")
    return res


# limits of compare_runs, each about 10x above the largest reading of the
# H100 runs of rung_real_sharded (1-rank NCCL and 2 ranks on one card):
# 2 keys in one merged arena only, values' relative L1 7.4e-7, float
# metrics 3.3e-8, integer metrics 2.1e-6 (subsp_sharded read 0 on each)
STEP_KEYS_ONE_ONLY = 20
STEP_VALUES_REL_L1 = 1e-5
STEP_FLOAT_REL = 1e-6
STEP_INT_REL = 2e-5
# integer metrics counted before the vector compression (the merge's
# sign-coherence count, the kept count of find_preserve on the merged vector)
PRE_COMPRESSION_COUNTS = ("sgn_coh", "nkept")


def compare_runs(label, kern, plain):
    """Steps from one state each, with the kernels and with their plain
    versions: per step the merged arena before the vector compression
    (keys, value rows, n_used) and the metrics.  Kernel B may pick a
    neighbouring sub where a grid point sits within an ulp of a boundary
    (0.01% of slots, as its own check allows), and the merge carries that
    into the rows those spawns reach; the compression after the merge is
    left out of the arena check, since one element kept more or fewer moves
    its unit and so re-draws the systematic sample along the vector.  So
    the flags must be equal; at most ``STEP_KEYS_ONE_ONLY`` keys may sit in
    one merged arena only; the values' L1 difference relative to the plain
    run's must stay under ``STEP_VALUES_REL_L1``, the float metrics'
    relative differences under ``STEP_FLOAT_REL`` and those of the integer
    metrics counted before the compression (``PRE_COMPRESSION_COUNTS``)
    under ``STEP_INT_REL``; the rows whose key or values (rtol 1e-10)
    differ and the largest relative difference of every integer metric
    (some count after the compression) are reported."""
    import torch
    from fries_tpu_torch import dets

    out = {"rows_differing": [], "keys_in_one_only": [], "values_rel_l1": [],
           "float_metric_max_rel_err": 0.0, "pre_compression_count_max_rel_err": 0.0,
           "int_metric_max_rel_err": 0.0}
    for i, (a, b) in enumerate(zip(kern, plain)):
        valid_a, valid_b = ~dets.is_invalid(a[0]), ~dets.is_invalid(b[0])
        pos, found = dets.lookup_dets(a[0], b[0])
        found = found & valid_b
        hit_a = torch.zeros_like(valid_a)
        hit_a[pos[found]] = True
        va, vb = a[1][:, pos[found]], b[1][:, found]
        close = torch.isclose(va, vb, rtol=1e-10, atol=1e-12).all(0)
        one_only = int((valid_a & ~hit_a).sum()) + int((valid_b & ~found).sum())
        diff = (float((va - vb).abs().sum()) + float(a[1][:, valid_a & ~hit_a].abs().sum())
                + float(b[1][:, valid_b & ~found].abs().sum()))
        out["rows_differing"].append(one_only + int((~close).sum()))
        out["keys_in_one_only"].append(one_only)
        out["values_rel_l1"].append(diff / max(float(b[1][:, valid_b].abs().sum()), 1e-300))
        for k, v in a[3].items():
            w = b[3][k]
            if v.dtype == torch.bool:
                if not torch.equal(v, w):
                    raise AssertionError(f"{label}: flag {k} differs at step {i}")
                continue
            rel = float(((v - w).abs().double() / w.abs().double().clamp_min(1e-300)).max())
            if v.is_floating_point():
                keys = ["float_metric_max_rel_err"]
            else:
                keys = ["int_metric_max_rel_err"] + (
                    ["pre_compression_count_max_rel_err"] if k in PRE_COMPRESSION_COUNTS else [])
            for key in keys:
                out[key] = max(out[key], rel)
        if one_only > STEP_KEYS_ONE_ONLY or out["values_rel_l1"][-1] > STEP_VALUES_REL_L1:
            raise AssertionError(f"{label}: step {i}: {out}")
    if (out["float_metric_max_rel_err"] > STEP_FLOAT_REL
            or out["pre_compression_count_max_rel_err"] > STEP_INT_REL):
        raise AssertionError(f"{label}: {out}")
    return out


def last_merge(found):
    """``found[0]``: the arena the block's last merge (kernel A or C, or
    whichever version is in place) returned."""
    from fries_tpu_torch.runtime import merge, merge_multi

    def wrap(fn):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            found[:] = [out[0]]
            return out
        return rec
    return patched((merge, "accumulate", wrap), (merge_multi, "accumulate", wrap))


def kernel_plain_steps(step_fn, state, n, store):
    """``n`` steps, each from the kernels' last state, once with the kernels
    and once with their plain versions; the last step's kernel inputs go to
    ``store``.  Returns (the kernels' state, kernel results, plain results)
    as lists of (merged keys, merged value rows, merged n_used, metrics)."""
    kern, plain = [], []
    for k in range(n):
        merged = []
        with (capture_kernel_inputs(store) if k == n - 1 else contextlib.nullcontext()), \
                last_merge(merged):
            st, m = step_fn(state, k)
        kern.append((merged[0].keys, merged[0].vals, merged[0].n_used, m))
        with plain_kernels(), last_merge(merged):
            _, m_p = step_fn(state, k)
        plain.append((merged[0].keys, merged[0].vals, merged[0].n_used, m_p))
        state = st
    return state, kern, plain


def capture_kernel_inputs(store):
    """Keep the inputs of every kernel launch of the block in ``store``
    (lists under "merge", "emit", "merge_multi"), for the kernels' own
    checks against their plain versions."""
    from fries_tpu_torch.runtime import emit, merge, merge_multi

    def into(name):
        def wrap(fn):
            def rec(*args, **kwargs):
                store.setdefault(name, []).append((args, kwargs))
                return fn(*args, **kwargs)
            return rec
        return wrap
    return patched((merge, "accumulate", into("merge")), (emit, "emit", into("emit")),
                   (emit, "emit_factored", into("emit")),
                   (merge_multi, "accumulate", into("merge_multi")))


def check_captured(label, store):
    """Each captured launch of the last step through its kernel and its
    plain version (kernel A: ``check_merge``; B: ``check_emit``; C:
    ``check_merge_multi``); returns the largest error of each."""
    errs = {}
    for name, calls in store.items():
        for args, kwargs in calls:
            if name == "emit":
                r = check_emit(f"{label}, N={kwargs['offsets'].shape[0]}", kwargs,
                               need_kept=False)
            elif name == "merge":
                a, sk, sv, si, origin, dest = args
                keep = kwargs.get("keep_mask")
                r = check_merge(f"{label} ({a.n_vecs},{origin},{dest})", a, sk, sv, si,
                                (a.n_vecs, origin, dest), keep)
            else:
                r = check_merge_multi(label, *args)
            errs[name] = max(errs.get(name, 0.0), r["max_abs_err"])
    return errs


def sharded_rung_real(shards, ham=None):
    """``rung_real_sharded`` on this rank: warm-up, the fixed-uniform steps
    with the kernels and with their plain versions, the timed steps."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import emit, merge

    t0 = time.perf_counter()
    step, state, est, _ = rung.build_real_sharded(shards, ham=ham)
    for _ in range(SHARD_WARM):
        state, m = step(state, *est)
        check_power_metrics("rung_real_sharded warm-up", [m])
    gen = torch.Generator(device="cpu")
    gen.manual_seed(31)
    draws = [torch.rand(7, dtype=torch.float64, generator=gen) for _ in range(SHARD_FIXED)]

    offsets, store = [], {}
    reset_launches(merge, emit)
    with shard_offsets(offsets):
        state, kern, plain = kernel_plain_steps(
            lambda st, k: step(st, *est, rns=draws[k][:6], rn_vec=draws[k][6]), state,
            SHARD_FIXED, store)
    fixed_launches = {"merge": kernel_launches(merge), "emit": kernel_launches(emit)}
    label = f"rung_real_sharded rank {shards.rank}"
    cmp = compare_runs(f"{label}, kernels against plain", kern, plain)
    err = check_captured(f"{label}, a fixed step's", store)
    want = {"merge": SHARD_FIXED, "emit": 3 * SHARD_FIXED}
    if fixed_launches != want:
        raise AssertionError(f"rung_real_sharded: launches {fixed_launches}, want {want}")
    del kern, plain, store
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exch = []
    reset_launches(merge, emit)
    with timed_exchanges(exch), cd_plans() as seen:
        t1 = time.perf_counter()
        metrics = []
        for _ in range(SHARD_TIMED):
            state, m = step(state, *est)
            metrics.append(m)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1) / SHARD_TIMED
    launches = {"merge": kernel_launches(merge), "emit": kernel_launches(emit)}
    check_power_metrics("rung_real_sharded", metrics)
    if launches != {"merge": SHARD_TIMED, "emit": 3 * SHARD_TIMED}:
        raise AssertionError(f"rung_real_sharded: timed launches {launches}")
    plan_per_step = check_plan_launches(label, seen, SHARD_TIMED, 1)
    (state, _), syncs = count_syncs(lambda: step(state, *est))
    last = metrics[-1]
    return {"rank": shards.rank, "ranks": shards.size, "backend": shards.backend,
            "built_and_warm_s": t1 - t0, "ms_per_step": ms,
            "exchange_ms_per_step": sum(a.elapsed_time(b) for a, b in exch) / SHARD_TIMED,
            "host_syncs_per_step": syncs,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
            "launches_per_step": plan_per_step, "fixed_step_launches": fixed_launches, "kernel_vs_plain_max_abs_err": err,
            "steps_kernels_vs_plain": cmp,
            "min_grid_offset": min(offsets), "max_grid_offset": max(offsets),
            "n_used_rank": int(state.arena.n_used[0]),
            "n_dets_timed_steps": [int(m["n_dets"]) for m in metrics],
            "e_corr_est": float(last["proj_num"]) / float(last["proj_den"])}


def sharded_subsp(shards, ham=None):
    """``subsp_sharded`` on this rank: warm-up, two iterations with kernel C
    and with its plain version from one state, the timed iterations."""
    import torch
    from fries_tpu_torch import rung
    from fries_tpu_torch.runtime import merge_multi

    t0 = time.perf_counter()
    step, state, _ = rung.build_subsp_sharded(shards, ham=ham)
    for i in range(SHARD_WARM):
        state, m = step(state)
        if bool(m["overflow"]):
            raise AssertionError(f"subsp_sharded: overflow at warm-up step {i}")

    reset_launches(merge_multi)
    store = {}
    state, kern, plain = kernel_plain_steps(lambda st, k: step(st), state, SHARD_FIXED,
                                            store)
    fixed_launches = kernel_launches(merge_multi)
    label = f"subsp_sharded rank {shards.rank}"
    cmp = compare_runs(f"{label}, kernels against plain", kern, plain)
    err = check_captured(f"{label}, a fixed iteration's", store)
    if fixed_launches != SHARD_FIXED:
        raise AssertionError(f"subsp_sharded: {fixed_launches} kernel C launches")
    del kern, plain
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    exch = []
    reset_launches(merge_multi)
    with timed_exchanges(exch):
        t1 = time.perf_counter()
        metrics = []
        for _ in range(SUBSP_SHARD_TIMED):
            state, m = step(state)
            metrics.append(m)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1) / SUBSP_SHARD_TIMED
    for i, m in enumerate(metrics):
        if bool(m["overflow"]) or not torch.isfinite(m["h_mat"]).all():
            raise AssertionError(f"subsp_sharded: overflow or non-finite h_mat at step {i}")
    # the merged arena holds the compressed rows and the new spawned targets:
    # more than one vector's budget by the timed iterations (the unsharded
    # configuration holds 472,013-592,561 rows in its)
    budget = rung.subsp_sharded_config(shards.size).vec_nonz
    if int(metrics[-1]["n_dets"][0]) < budget:
        raise AssertionError(f"subsp_sharded: {int(metrics[-1]['n_dets'][0])} rows after "
                             f"{SHARD_WARM + SHARD_FIXED + SUBSP_SHARD_TIMED} iterations")
    launches = {"merge_multi": kernel_launches(merge_multi)}
    if launches["merge_multi"] != SUBSP_SHARD_TIMED:
        raise AssertionError(f"subsp_sharded: {launches} kernel C launches")
    (state, _), syncs = count_syncs(lambda: step(state))
    return {"rank": shards.rank, "ranks": shards.size, "backend": shards.backend,
            "built_and_warm_s": t1 - t0, "ms_per_iteration": ms,
            "exchange_ms_per_iteration": sum(a.elapsed_time(b) for a, b in exch)
            / SUBSP_SHARD_TIMED,
            "host_syncs_per_iteration": syncs,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
            "fixed_step_launches": {"merge_multi": fixed_launches},
            "kernel_vs_plain_max_abs_err": err, "steps_kernels_vs_plain": cmp,
            "n_dets_timed_steps": [int(m["n_dets"][0]) for m in metrics],
            "h_mat_last": metrics[-1]["h_mat"].cpu().tolist()}


def equivalence_configs(n_shards):
    """The reference's identity equivalences (tests/test_sharded.py) on a
    small system: frifull and subspace ``exact_h`` with budgets above the
    space, per-rank capacities for ``n_shards`` ranks."""
    from fries_tpu_torch.drivers import power, subspace

    cap = 64 if n_shards > 1 else 128
    ff = power.PowerConfig(eps=0.05, target_nonz=256, capacity=cap + 32, n_shards=n_shards,
                           exchange_cap=4096 if n_shards > 1 else 0)
    ss = subspace.SubspaceConfig(eps=0.05, n_trial=2, vec_nonz=4096, matr_samp=4096,
                                 capacity=2 * cap + 64, spawn_cap=4096, restart_int=10,
                                 exact_h=True, compress_mode="sys", n_shards=n_shards,
                                 exchange_cap=4096 if n_shards > 1 else 0)
    return ff, ss


def equivalence_runs(shards, device):
    """30 frifull steps and 15 subspace ``exact_h`` iterations, sharded over
    ``shards`` (None: one device); their metrics on the CPU."""
    from fries_tpu_torch import rung, synth
    from fries_tpu_torch.drivers import frifull, subspace

    ham = synth.make_system(5, 4, seed=41, device=device)
    ff, ss = equivalence_configs(1 if shards is None else shards.size)
    if shards is None:
        _, run, st, aux = frifull.build(ham, ff, seed=0)
        _, srun, sst, _ = subspace.build(ham, ss, rung.hf_and_single(ham, 1, 3),
                                         [[1.0], [1.0]], seed=0)
    else:
        _, run, st, aux = frifull.build_sharded(ham, ff, 0, shards)
        _, srun, sst, _ = subspace.build_sharded(ham, ss, rung.hf_and_single(ham, 1, 3),
                                                 [[1.0], [1.0]], 0, shards)
    tr = run(st, *rung.estimator_args(aux), 30)[1]
    str_ = srun(sst, 15)[1]
    return {"frifull": {k: v.cpu() for k, v in tr.items()},
            "subspace": {k: v.cpu() for k, v in str_.items()}}


def shard_world(shards, stream_path):
    """The sharded phases of one rank of the 2-rank world on the card."""
    from fries_tpu_torch import _build

    _build.load()
    out = {"exchange": exchange_check(shards, stream_path)}
    ham, same = built_twice(shards.device)
    if not same:
        raise AssertionError(f"rank {shards.rank}: two builds of N2/cc-pVDZ differ")
    out["repro"] = repro_rung_real(shards, ham)
    out["rung_real"] = sharded_rung_real(shards, ham=ham)
    out["subsp"] = sharded_subsp(shards)
    out["equivalence"] = equivalence_runs(shards, shards.device)
    return out


def shard_nccl_world(shards):
    from fries_tpu_torch import _build

    _build.load()
    return sharded_rung_real(shards)


def check_equivalence(sharded, single):
    """Sharded against single: frifull's energies, norms and n_dets, the
    subspace's h and d matrices, rtol 1e-9 / atol 1e-11."""
    import torch

    errs = {}
    for name, keys in (("frifull", ("proj_num", "proj_den", "norm")),
                       ("subspace", ("h_mat", "d_mat"))):
        a, b = sharded[name], single[name]
        if bool(a["overflow"].any()) or bool(b["overflow"].any()):
            raise AssertionError(f"equivalence {name}: overflow")
        for k in keys:
            if not torch.allclose(a[k], b[k], rtol=1e-9, atol=1e-11):
                raise AssertionError(f"equivalence {name}: {k} differs")
            errs[f"{name} {k}"] = float((a[k] - b[k]).abs().max())
    if not torch.equal(sharded["frifull"]["n_dets"], single["frifull"]["n_dets"]):
        raise AssertionError("equivalence frifull: n_dets differ")
    return errs


def phase_sharding(dev, hams, stream):
    """Phase 17d (see the module docstring).  ``stream``: rung_real's real
    spawn stream (words, amplitudes, initiator flags)."""
    import torch
    from fries_tpu_torch import _build, parallel
    from fries_tpu_torch.runtime import emit, merge, merge_multi

    res = {}
    t0 = time.perf_counter()
    probe = parallel.launch(probe_collectives, SHARD_RANKS, "gloo", "cuda", timeout=120)
    res["probe_gloo_cuda"] = probe[0]
    log(f"sharding probe: gloo on CUDA tensors, 2 ranks on one card: {json.dumps(probe[0])}")
    if any(probe[0].values()):
        raise AssertionError(f"gloo refuses CUDA tensors in a collective the port issues: "
                             f"{probe[0]}")
    shards = parallel.init_world(0, 1, "nccl", dev)
    try:
        nccl = probe_collectives(shards)
        res["probe_nccl_one_rank"] = nccl
        log(f"sharding probe: 1-rank NCCL world: {json.dumps(nccl)}")
        if any(nccl.values()):
            raise AssertionError(f"1-rank NCCL world: {nccl}")
        res["repro_nccl1"] = repro_rung_real(shards, hams["n2_ccpvdz"])
        log(f"rung_real_sharded, 1-rank NCCL, two warm-ups from one seed: "
            f"{json.dumps(res['repro_nccl1'])}")
        res["rung_real_nccl1"] = sharded_rung_real(shards, ham=hams["n2_ccpvdz"])
        log(f"rung_real_sharded, 1-rank NCCL: {json.dumps(res['rung_real_nccl1'])}")
        res["subsp_nccl1"] = sharded_subsp(shards, ham=hams["ne_ccpvqz"])
        log(f"subsp_sharded, 1-rank NCCL: {json.dumps(res['subsp_nccl1'])}")
    finally:
        parallel.close_world()
    path = _build.BUILD_DIR / SHARD_STREAM
    path.parent.mkdir(parents=True, exist_ok=True)
    words, amps, ini = (x.cpu() for x in stream)
    torch.save({"words": words, "amps": amps, "ini": ini}, path)
    single = equivalence_runs(None, dev)
    torch.cuda.empty_cache()    # the two ranks share this card with this process
    world = parallel.launch(shard_world, SHARD_RANKS, "gloo", "cuda", args=(str(path),),
                            timeout=300, join_timeout=900)
    res["exchange"] = [w["exchange"] for w in world]
    log(f"exchange, 2 ranks on one card over rung_real's real stream "
        f"({int(words.shape[0])} rows): {json.dumps(res['exchange'])}")
    res["repro_2rank"] = [w["repro"] for w in world]
    log(f"rung_real_sharded, 2 ranks on one card, two warm-ups from one seed: "
        f"{json.dumps(res['repro_2rank'])}")
    res["rung_real_2rank"] = [w["rung_real"] for w in world]
    if not res["rung_real_2rank"][1]["min_grid_offset"] > 0:
        raise AssertionError("rung_real_sharded: rank 1 emitted with no shard offset")
    log(f"rung_real_sharded, 2 ranks on one card (gloo on CUDA tensors; two "
        f"processes share the card: not a scaling result): {json.dumps(res['rung_real_2rank'])}")
    res["subsp_2rank"] = [w["subsp"] for w in world]
    log(f"subsp_sharded, 2 ranks on one card: {json.dumps(res['subsp_2rank'])}")
    for w in world[1:]:
        for name in ("frifull", "subspace"):
            for k, v in w["equivalence"][name].items():
                if k not in ("spawn_rows", "n_merges") and not torch.equal(
                        v, world[0]["equivalence"][name][k]):
                    raise AssertionError(f"equivalence {name}: {k} differs between ranks")
    res["equivalence_max_abs_err"] = check_equivalence(world[0]["equivalence"], single)
    log(f"identity equivalences on the card, 2 ranks against 1: "
        f"{json.dumps(res['equivalence_max_abs_err'])}")
    if torch.cuda.device_count() >= 2:
        res["rung_real_nccl2"] = parallel.launch(shard_nccl_world, 2, "nccl", "cuda",
                                                 timeout=300, join_timeout=600)
        log(f"rung_real_sharded, NCCL on 2 cards: {json.dumps(res['rung_real_nccl2'])}")
    else:
        res["rung_real_nccl2"] = None
        log(f"rung_real_sharded under NCCL across cards: not run "
            f"({torch.cuda.device_count()} card visible)")
    res["seconds"] = time.perf_counter() - t0
    log(f"sharding: {res['seconds']:.1f} s")
    reset_launches(merge, emit, merge_multi)
    return res


def phase_timings(dev, n_elements, chunk_case, fciqmc_case, hh_cases, path_plans, sub_chunk,
                  obs_cases, ne_qz_case, ne_qz_subsp_case, real_cases, ne2_subsp_case):
    """Each kernel's wrapper and its plain version on the inputs of its
    check at the main path's shapes (the same seeds; ``chunk_case`` is the
    exact-H path's own chunk, ``fciqmc_case`` FCIQMC's own merge input,
    ``hh_cases`` the Hubbard-Holstein paths' own merge inputs by name,
    ``path_plans`` frisys_hh's and the unfused rung's own emission plans by
    name, ``sub_chunk`` the subspfull path's own kernel C chunk,
    ``obs_cases`` the observables' own merge inputs (arena, spawn keys,
    values, flags, origin, dest) by name, ``ne_qz_case`` and
    ``ne_qz_subsp_case`` the four-word paths' own kernel A and C inputs,
    ``real_cases`` the real molecules' own merge inputs (arena, spawn keys,
    values, flags, keep mask or None) by name, ``ne2_qz`` among them at
    seven words, ``ne2_subsp_case`` ne2_qz_subsp's own kernel C input),
    with its bound:
    call times first for every kernel, then device times, since the
    profiler slows every later launch of the process."""
    import torch
    from fries_tpu_torch import _build
    from fries_tpu_torch import probe_reshape as probe_mod
    from fries_tpu_torch.runtime import arena as ar
    from fries_tpu_torch.runtime import emit, merge, merge_multi

    cases = {}   # name: (kernel call, plain call, bound, library call or None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    a, sk, sv, si, keep = rung_merge_case(gen, dev)
    a = with_rows(a, 2)
    cases["merge"] = (lambda: merge.accumulate(a, sk, sv, si, 0, 1, keep_mask=keep),
                      lambda: merge.accumulate_plain(a, sk, sv, si, 0, 1, keep),
                      merge_bound(a, (sk, sv, si), keep), None)
    sk1 = one_key_stress(a, sk)
    extras = {"merge": {   # name: {field prefix: call}
        "sort": lambda: merge.sort_spawns(sk),
        "stress": lambda: merge.accumulate(a, sk1, sv, si, 0, 1, keep_mask=keep)}}
    fa, fsk, fsv, fsi = chunk_case
    cases["merge frifull_chunk"] = (lambda: merge.accumulate(fa, fsk, fsv, fsi, 0, 1),
                                    lambda: merge.accumulate_plain(fa, fsk, fsv, fsi, 0, 1),
                                    merge_bound(fa, (fsk, fsv, fsi)), None)
    extras["merge frifull_chunk"] = {"sort": lambda: merge.sort_spawns(fsk)}
    qa, qsk, qsv, qsi = fciqmc_case
    cases["merge fciqmc"] = (lambda: merge.accumulate(qa, qsk, qsv, qsi, 0, 0),
                             lambda: merge.accumulate_plain(qa, qsk, qsv, qsi, 0, 0),
                             merge_bound(qa, (qsk, qsv, qsi)), None)
    extras["merge fciqmc"] = {"sort": lambda: merge.sort_spawns(qsk)}
    for name, (ha, hsk, hsv, hsi, hkeep) in hh_cases.items():
        cases[f"merge {name}"] = (
            lambda a=ha, k=hsk, v=hsv, i=hsi, m=hkeep: merge.accumulate(a, k, v, i, 0, 1,
                                                                        keep_mask=m),
            lambda a=ha, k=hsk, v=hsv, i=hsi, m=hkeep: merge.accumulate_plain(a, k, v, i, 0, 1,
                                                                              m),
            merge_bound(ha, (hsk, hsv, hsi), hkeep), None)
        extras[f"merge {name}"] = {"sort": lambda k=hsk: merge.sort_spawns(k)}
    for name, (oa, osk, osv, osi, origin, dest) in obs_cases.items():
        cases[f"merge {name}"] = (
            lambda a=oa, k=osk, v=osv, i=osi, o=origin, d=dest: merge.accumulate(a, k, v, i, o, d),
            lambda a=oa, k=osk, v=osv, i=osi, o=origin, d=dest: merge.accumulate_plain(
                a, k, v, i, o, d),
            merge_bound(oa, (osk, osv, osi)), None)
        extras[f"merge {name}"] = {"sort": lambda k=osk: merge.sort_spawns(k)}
    for name, (ra, rsk, rsv, rsi, rkeep) in real_cases.items():
        dest = min(1, ra.n_vecs - 1)
        cases[f"merge {name}"] = (
            lambda a=ra, k=rsk, v=rsv, i=rsi, m=rkeep, d=dest: merge.accumulate(
                a, k, v, i, 0, d, keep_mask=m),
            lambda a=ra, k=rsk, v=rsv, i=rsi, m=rkeep, d=dest: merge.accumulate_plain(
                a, k, v, i, 0, d, m),
            merge_bound(ra, (rsk, rsv, rsi), rkeep), None)
        extras[f"merge {name}"] = {"sort": lambda k=rsk: merge.sort_spawns(k)}
    for name, plan in path_plans.items():
        kernel, plain = emit_pair(plan)
        _, rp, rs = plain(**plan)
        cases[f"emit {name}"] = (lambda f=kernel, p=plan: f(**p), lambda f=plain, p=plan: f(**p),
                                 emit_bound(plan, rp, rs), None)
    for w in (2, 4, *WIDER_WORDS):    # kernel A at one C and S, the key widths
        gen.manual_seed(90 + w)
        wa, wsk, wsv, wsi, wkeep = ne_qz_merge_case(gen, dev, w)
        wa = with_rows(wa, 2)
        cases[f"merge ne_qz shapes W={w}"] = (
            lambda a=wa, k=wsk, v=wsv, i=wsi, m=wkeep: merge.accumulate(a, k, v, i, 0, 1,
                                                                        keep_mask=m),
            lambda a=wa, k=wsk, v=wsv, i=wsi, m=wkeep: merge.accumulate_plain(a, k, v, i, 0, 1,
                                                                              m),
            merge_bound(wa, (wsk, wsv, wsi), wkeep), None)
        extras[f"merge ne_qz shapes W={w}"] = {"sort": lambda k=wsk: merge.sort_spawns(k)}
    za, zsk, zsv, zsi, zkeep = ne_qz_case
    zsk1 = one_key_stress(za, zsk)
    cases["merge ne_qz"] = (lambda: merge.accumulate(za, zsk, zsv, zsi, 0, 1, keep_mask=zkeep),
                            lambda: merge.accumulate_plain(za, zsk, zsv, zsi, 0, 1, zkeep),
                            merge_bound(za, (zsk, zsv, zsi), zkeep), None)
    extras["merge ne_qz"] = {
        "sort": lambda: merge.sort_spawns(zsk),
        "stress": lambda: merge.accumulate(za, zsk1, zsv, zsi, 0, 1, keep_mask=zkeep)}
    for name, (qa, qsk, qsv, qsr, qsi) in (("ne_qz_subsp", ne_qz_subsp_case),
                                           ("ne2_qz_subsp", ne2_subsp_case)):
        qsk1 = one_key_stress(qa, qsk)
        cases[f"merge_multi {name}"] = (
            lambda a=qa, k=qsk, v=qsv, r=qsr, i=qsi: merge_multi.accumulate(a, k, v, r, i),
            lambda a=qa, k=qsk, v=qsv, r=qsr, i=qsi: ar.accumulate_multi(a, k, v, r, i),
            merge_bound(qa, (qsk, qsv, qsr, qsi)), None)
        extras[f"merge_multi {name}"] = {
            "sort": lambda k=qsk: merge.sort_spawns(k),
            "stress": lambda a=qa, k=qsk1, v=qsv, r=qsr, i=qsi: merge_multi.accumulate(
                a, k, v, r, i)}
    for w in WIDER_MULTI_TIMED:    # kernel C at ne_qz_subsp's shapes, limb keys
        gen.manual_seed(190 + w)
        wa, wsk, wsv, wsr, wsi = ne_qz_subsp_multi_case(gen, dev, w)
        cases[f"merge_multi ne_qz_subsp shapes W={w}"] = (
            lambda a=wa, k=wsk, v=wsv, r=wsr, i=wsi: merge_multi.accumulate(a, k, v, r, i),
            lambda a=wa, k=wsk, v=wsv, r=wsr, i=wsi: ar.accumulate_multi(a, k, v, r, i),
            merge_bound(wa, (wsk, wsv, wsr, wsi)), None)
        extras[f"merge_multi ne_qz_subsp shapes W={w}"] = {
            "sort": lambda k=wsk: merge.sort_spawns(k)}
    ca, csk, csv, csr, csi = sub_chunk
    cases["merge_multi subspfull_chunk"] = (
        lambda: merge_multi.accumulate(ca, csk, csv, csr, csi),
        lambda: ar.accumulate_multi(ca, csk, csv, csr, csi),
        merge_bound(ca, (csk, csv, csr, csi)), None)
    extras["merge_multi subspfull_chunk"] = {"sort": lambda: merge.sort_spawns(csk)}
    gen.manual_seed(8)
    sa, ssk, ssv, ssi, skeep = semistoch_merge_case(gen, dev, n_elements)
    cases["merge semistoch"] = (
        lambda: merge.accumulate(sa, ssk, ssv, ssi, 0, 1, keep_mask=skeep),
        lambda: merge.accumulate_plain(sa, ssk, ssv, ssi, 0, 1, skeep),
        merge_bound(sa, (ssk, ssv, ssi), skeep), None)
    extras["merge semistoch"] = {"sort": lambda: merge.sort_spawns(ssk)}
    for name, (_, plan) in step_emissions(dev).items():
        kernel, plain = emit_pair(plan)
        _, rp, rs = plain(**plan)
        cases[f"emit {name}"] = (lambda k=kernel, p=plan: k(**p),
                                 lambda f=plain, p=plan: f(**p), emit_bound(plan, rp, rs), None)
    gen.manual_seed(3)
    _, ma, msk, msv, msr, msi = subspace_multi_case(gen, dev)
    cases["merge_multi"] = (lambda: merge_multi.accumulate(ma, msk, msv, msr, msi),
                            lambda: ar.accumulate_multi(ma, msk, msv, msr, msi),
                            merge_bound(ma, (msk, msv, msr, msi)), None)
    msk1 = one_key_stress(ma, msk)
    extras["merge_multi"] = {
        "sort": lambda: merge.sort_spawns(msk),
        "stress": lambda: merge_multi.accumulate(ma, msk1, msv, msr, msi)}
    x = probe_tile(dev)
    dst = torch.empty((probe_mod.TB, 1), dtype=torch.int32, device=dev)
    cases["probe_reshape"] = (lambda: probe_mod.reshape(x),
                              lambda: probe_mod.reshape_plain(x),
                              bound(x.nbytes + dst.nbytes),
                              lambda: dst.copy_(x.view(probe_mod.TB, 1)))
    pc = probe_copy_tile(dev)
    pc_dst = torch.empty_like(pc)
    cases["probe_copy"] = (lambda: _build.probe_copy(pc), lambda: _build.probe_copy_plain(pc),
                           bound(pc.nbytes + pc_dst.nbytes), lambda: pc_dst.copy_(pc))
    res = {}
    for name, (kernel, plain, b, library) in cases.items():
        res[name] = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain), **b,
                     "library_ms": None if library is None else cuda_ms(library)}
        for prefix, fn in extras.get(name, {}).items():
            res[name][f"{prefix}_ms"] = cuda_ms(fn)
    for name, (kernel, plain, _, _) in cases.items():
        ms, ops, top = device_profile(kernel)
        res[name].update(device_ms=ms, device_ops=ops, plain_device_ms=device_profile(plain)[0])
        for prefix, fn in extras.get(name, {}).items():
            res[name][f"{prefix}_device_ms"], res[name][f"{prefix}_device_ops"], _ = \
                device_profile(fn)
        if name in extras:   # what a merge's device time is made of
            log(f"timing {name}: device ms by operation {json.dumps(top)}")
        log(f"timing {name}: {json.dumps(res[name])}")
    return res


def sharding_main(dev, n_runs):
    """``--sharding N``: phase 17d alone, ``N`` times (its inputs built
    once: N2/cc-pVDZ, Ne/cc-pVQZ and rung_real's real spawn stream); each
    run's outcome on a line, and the count of runs that passed.  Exits 1
    unless every run passed."""
    import torch
    from fries_tpu_torch import real_systems, rung

    hams = {"n2_ccpvdz": real_systems.n2_ccpvdz(dev), "ne_ccpvqz": rung.ne_qz_system(dev)}
    _, case, _ = phase_rung_real(dev, hams["n2_ccpvdz"])
    stream = case[1:4]
    del case
    torch.cuda.empty_cache()
    passed = 0
    for i in range(n_runs):
        t0 = time.perf_counter()
        try:
            r = phase_sharding(dev, hams, stream)
        except Exception as e:   # a failed run is counted; the next one runs
            out = {"run": i, "passed": False, "error": f"{type(e).__name__}: {str(e)[-800:]}"}
        else:
            passed += 1
            out = {"run": i, "passed": True, "repro_equal": [
                       x["equal"] for x in (r["repro_nccl1"], *r["repro_2rank"])],
                   "keys_in_one_only": {
                       name: [x["steps_kernels_vs_plain"]["keys_in_one_only"] for x in runs]
                       for name, runs in (("rung_real_nccl1", [r["rung_real_nccl1"]]),
                                          ("rung_real_2rank", r["rung_real_2rank"]),
                                          ("subsp_nccl1", [r["subsp_nccl1"]]),
                                          ("subsp_2rank", r["subsp_2rank"]))},
                   "values_rel_l1_max": max(
                       max(x["steps_kernels_vs_plain"]["values_rel_l1"])
                       for x in (r["rung_real_nccl1"], *r["rung_real_2rank"]))}
        out["seconds"] = time.perf_counter() - t0
        log(f"phase 17d run {i}: {json.dumps(out)}")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 17d: {passed} of {n_runs} runs passed")
    return 0 if passed == n_runs else 1


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="The port on the card, every path and kernel.")
    ap.add_argument("--sharding", type=int, default=0, metavar="N",
                    help="only phase 17d, N times")
    ap.add_argument("--past_bounds", action="store_true",
                    help="only phase 17g (the regimes past kernels A and C's bounds)")
    ap.add_argument("--plan", action="store_true",
                    help="only kernel F at the benchmark cells' C+D shapes")
    ap.add_argument("--fciqmc", action="store_true",
                    help="only the fciqmc phase (kernel G against the plain attempt pass)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from fries_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 1
    check_no_reference_imports()
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    reset_counters("launch.probe_copy")
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    if args.sharding:
        return sharding_main(dev, args.sharding)
    from fries_tpu_torch import real_systems
    from fries_tpu_torch.runtime import arena as ar

    if args.plan:
        log(f"kernel F: {json.dumps(phase_plan(dev))}")
        return 0
    if args.fciqmc:
        phase_fciqmc(dev)
        return 0
    if args.past_bounds:
        past_res = phase_past_bounds(dev)
        past_res["frifull_real twice"] = frifull_real_repeats(dev, real_systems.h2o_ccpvdz(dev))
        log(f"past bounds: {json.dumps(past_res)}")
        return 0
    reset_counters("merge.plain_on_card")
    pc = phase_probe_copy(dev)
    m = phase_merge(dev)
    e = phase_emit(dev)
    c = phase_merge_multi(dev)
    wide = phase_merge_wide(dev)
    wider = phase_merge_wider(dev)
    p = phase_probe(dev)
    phase_small_step(dev)
    main_res = phase_main_path(dev)
    phase_subspace_small(dev)
    sub_res = phase_subspace(dev)
    phase_small_options(dev)
    semi_res = phase_semistoch(dev)
    phase_small_frifull(dev)
    full_res, chunk_case = phase_frifull(dev)
    phase_small_fciqmc(dev)
    fq_res, fciqmc_case = phase_fciqmc(dev)
    phase_small_frimulti(dev)
    fm_res = phase_frimulti(dev)
    phase_small_hh(dev)
    ffhh_res, ffhh_case = phase_frifull_hh(dev)
    fshh_res, fshh_case, hh_plans = phase_frisys_hh(dev)
    hhw_res, hhw_case, hhw_plans = phase_frisys_hh_wide(dev)
    phase_subspace_modes_small(dev)
    modes_res = phase_subspace_modes(dev)
    sfull_res, sub_chunk = phase_subspfull(dev)
    phase_small_observables(dev)
    obs_res, obs_captured = phase_observables(dev, False)
    repl_res, repl_captured = phase_observables(dev, True)
    phase_small_unfused(dev)
    unf_res, unf_plans = phase_unfused(dev)
    cli_res = phase_cli_resume(dev)
    phase_small_wide(dev)
    int_res, hams = phase_integrals(dev)
    native_res = phase_native_reader(hams["ne_ccpvqz"])
    qz_res, qz_case = phase_ne_qz(dev, hams["ne_ccpvqz"])
    qzs_res, qzs_case = phase_ne_qz_subsp(dev, hams["ne_ccpvqz"])
    real_res, real_cases, real_plans = {}, {}, {}
    ne2_res, real_cases["ne2_qz"], ne2_subsp_case = phase_ne2_qz(
        dev, int_res["ne_ccpvqz"]["e_hf_total"])
    gc.collect()
    torch.cuda.empty_cache()    # ne2_qz_subsp's 37 GB peak stays reserved otherwise
    real_res["rung_real"], real_cases["rung_real"], real_plans = phase_rung_real(
        dev, hams["n2_ccpvdz"])
    real_res["semistoch_cisd"], real_cases["semistoch_cisd"] = phase_semistoch_cisd(
        dev, hams["n2_ccpvdz"])
    real_res["flagship"], real_cases["flagship"], flag_plans = phase_flagship(dev)
    real_plans.update(flag_plans)
    real_res["anchor"], real_cases["anchor"], anchor_plans = phase_anchor(dev)
    real_plans.update(anchor_plans)
    tools_res = phase_fcidump_tools(dev)
    real_res["frifull_real"], real_cases["frifull_real_chunk"] = phase_frifull_real(
        dev, hams["h2o_ccpvdz"])
    repeats_res = frifull_real_repeats(dev, hams["h2o_ccpvdz"])
    real_res["fciqmc_real"], real_cases["fciqmc_real"] = phase_fciqmc_real(
        dev, hams["n2_stretched"])
    shard_res = phase_sharding(dev, hams, real_cases["rung_real"][1:4])
    del hams
    if counter("merge.plain_on_card"):
        raise AssertionError(f"{counter('merge.plain_on_card')} merges left the kernels on "
                             "paths inside "
                             "their bounds")
    past_res = phase_past_bounds(dev)
    past_res["frifull_real twice"] = repeats_res
    reset_counters("merge.plain_on_card")
    obs_cases = {f"{name} {layout}": (*captured[layout], layout[1], layout[2])
                 for name, captured, layouts in (
                     ("observables", obs_captured, ((4, 0, 0), (4, 0, 3))),
                     ("obs_repl", repl_captured, ((4, 1, 1), (4, 1, 3))))
                 for layout in layouts}
    # last: its profiler slows what follows
    t = phase_timings(dev, semi_res["n_elements"], chunk_case, fciqmc_case,
                      {"frifull_hh": ffhh_case, "frisys_hh": fshh_case,
                       "frisys_hh_wide": hhw_case},
                      {**hh_plans, **hhw_plans, **unf_plans, **real_plans}, sub_chunk,
                      obs_cases, qz_case, qzs_case, real_cases, ne2_subsp_case)
    del real_cases, real_plans, qz_case, qzs_case, chunk_case, fciqmc_case, ffhh_case, fshh_case
    del hh_plans, unf_plans, sub_chunk, obs_captured, repl_captured, hhw_case, hhw_plans
    del ne2_subsp_case
    if counter("merge.plain_on_card"):
        raise AssertionError(f"{counter('merge.plain_on_card')} merges left the kernels in "
                             "the timings")
    obs_cases = list(obs_cases)     # the names; the tensors go before the child processes
    plan_res = phase_plan(dev)
    profiles = phase_real_profiles(dev)
    trace_res = phase_trace(dev)

    keys = ("ms", "plain_ms", "device_ms", "plain_device_ms", "bound_ms", "bound_by",
            "library_ms")
    timing = lambda name: {key: t[name][key] for key in keys}
    merge_keys = ("device_ops", "sort_ms", "sort_device_ms", "sort_device_ops", "stress_ms",
                  "stress_device_ms")
    merge_timing = lambda name: {**timing(name), **{key: t[name][key] for key in merge_keys}}
    shapes = {name: {**timing(f"emit {name}"), "max_abs_err": r["max_abs_err"]}
              for name, r in e.items()}
    step_sum = lambda key: sum(s[key] for s in shapes.values())
    frisys_bound_by = max((s["bound_ms"], s["bound_by"]) for s in shapes.values())[1]
    emit_step = {key: step_sum(key) for key in ("ms", "plain_ms", "device_ms",
                                                "plain_device_ms", "bound_ms")}
    for name, r in {**fshh_res["emit_checks"], **hhw_res["emit_checks"],
                    **unf_res["emit_checks"], **real_res["rung_real"]["emit_checks"],
                    **real_res["flagship"]["emit_checks"],
                    **real_res["anchor"]["emit_checks"]}.items():
        shapes[name] = {**timing(f"emit {name}"), "max_abs_err": r["max_abs_err"],
                        "n_out": r["n_out"], "kept": r["kept"]}
    sort_keys = ("device_ops", "sort_ms", "sort_device_ms", "sort_device_ops")
    merge_shapes = {
        name: {**timing(f"merge {name}"), **{key: t[f"merge {name}"][key] for key in sort_keys},
               "max_abs_err": err}
        for name, err in (("frifull_chunk", full_res["real_chunk"]["max_abs_err"]),
                          ("semistoch", semi_res["merge_check"]["max_abs_err"]),
                          ("fciqmc", fq_res["real_step"]["max_abs_err"]),
                          ("frifull_hh", ffhh_res["real_step"]["max_abs_err"]),
                          ("frisys_hh", fshh_res["real_step"]["max_abs_err"]),
                          ("frisys_hh_wide", hhw_res["real_step"]["max_abs_err"]))}
    for name, r in (("frifull_hh", ffhh_res), ("frisys_hh", fshh_res),
                    ("frisys_hh_wide", hhw_res)):
        merge_shapes[name].update({key: r["real_step"][key] for key in (
            "arena_rows", "spawns", "live_spawns", "unique_targets", "longest_run")})
    for name in obs_cases:
        path, layout = name.split(" ", 1)
        real = (obs_res if path == "observables" else repl_res)["real_merges"][layout]
        merge_shapes[name] = {
            **timing(f"merge {name}"), **{key: t[f"merge {name}"][key] for key in sort_keys},
            **{key: real[key] for key in ("max_abs_err", "arena_rows", "spawns", "live_spawns",
                                          "unique_targets", "longest_run")}}
    checks = {**wide, **wider}
    for w in (2, 4, *WIDER_WORDS):
        name = f"ne_qz shapes W={w}"
        merge_shapes[f"{name}, made-up"] = {
            **timing(f"merge {name}"), **{key: t[f"merge {name}"][key] for key in sort_keys},
            "max_abs_err": checks[f"merge W={w}"]["max_abs_err"]}
    merge_shapes["ne_qz (W=4)"] = {
        **merge_timing("merge ne_qz"), "max_abs_err": qz_res["ne_qz"]["real_step"]["max_abs_err"],
        **{key: qz_res["ne_qz"]["real_step"][key] for key in (
            "arena_rows", "spawns", "live_spawns", "unique_targets", "longest_run")}}
    merge_shapes["ne2_qz (W=7)"] = {
        **timing("merge ne2_qz"), **{key: t["merge ne2_qz"][key] for key in sort_keys},
        **{key: ne2_res["ne2_qz"]["real_step"][key] for key in (
            "max_abs_err", "arena_rows", "spawns", "live_spawns", "unique_targets",
            "longest_run")}}
    for name, path in (("rung_real", "rung_real"), ("semistoch_cisd", "semistoch_cisd"),
                       ("frifull_real_chunk", "frifull_real"), ("fciqmc_real", "fciqmc_real"),
                       ("flagship", "flagship"), ("anchor", "anchor")):
        real = real_res[path]["real_chunk" if name.endswith("chunk") else "real_step"]
        merge_shapes[name] = {
            **timing(f"merge {name}"), **{key: t[f"merge {name}"][key] for key in sort_keys},
            **{key: real[key] for key in ("max_abs_err", "arena_rows", "spawns", "live_spawns",
                                          "unique_targets", "longest_run")}}
    merge_shapes["frifull_chunk"].update(
        {key: full_res["real_chunk"][key] for key in ("arena_rows", "sentinel_share",
                                                      "unique_targets", "longest_run")},
        spawns=full_res["spawns_per_chunk"])
    merge_shapes["fciqmc"].update(
        {key: fq_res["real_step"][key] for key in ("arena_rows", "spawns", "live_spawns",
                                                   "unique_targets", "longest_run")},
        first_step_longest_run=fq_res["first_step"]["longest_run"])
    sharded_paths = [("rung_real_sharded 1-rank nccl", shard_res["rung_real_nccl1"]),
                     ("subsp_sharded 1-rank nccl", shard_res["subsp_nccl1"]),
                     *((f"rung_real_sharded 2 ranks, rank {r['rank']}", r)
                       for r in shard_res["rung_real_2rank"]),
                     *((f"subsp_sharded 2 ranks, rank {r['rank']}", r)
                       for r in shard_res["subsp_2rank"]),
                     *((f"rung_real_sharded nccl 2 cards, rank {r['rank']}", r)
                       for r in shard_res["rung_real_nccl2"] or ())]
    by_path = lambda kernel: {path: r["launches"][kernel] for path, r in (
        ("frisys rung", main_res), ("subsp", sub_res), ("semistoch", semi_res),
        ("frifull", full_res), ("fciqmc", fq_res), ("frimulti", fm_res),
        ("frifull_hh", ffhh_res), ("frisys_hh", fshh_res),
        ("subsp_lowmem", modes_res["subsp_lowmem"]), ("subsp_multi", modes_res["subsp_multi"]),
        ("subspfull", sfull_res), ("observables", obs_res), ("obs_repl", repl_res),
        ("unfused rung", unf_res), ("ne_qz", qz_res["ne_qz"]),
        ("ne_qz unnorm", qz_res["ne_qz unnorm"]), ("ne_qz_subsp", qzs_res),
        ("frisys_hh_wide", hhw_res), ("ne2_qz", ne2_res["ne2_qz"]),
        ("ne2_qz_subsp", ne2_res["ne2_qz_subsp"]),
        *real_res.items(), ("frisys_mol on water's FCIDUMP", tools_res["frisys_mol"]),
        *sharded_paths, *((f"{name} (cli, past the bounds)", r) for name, r in past_res.items()
                          if "launches" in r))
        if kernel in r["launches"]}
    multi_shape = {**timing("merge_multi subspfull_chunk"),
                   **{key: t["merge_multi subspfull_chunk"][key] for key in sort_keys},
                   "max_abs_err": sfull_res["real_chunk"]["max_abs_err"],
                   **{key: sfull_res["real_chunk"][key] for key in (
                       "arena_rows", "spawns", "live_spawns", "unique_targets", "longest_run")}}
    kernels = [
        {"name": "merge", "route": "cuda", "source": "fries_tpu_torch/csrc/merge.cu",
         "replaces": "fries_tpu/runtime/pallas_merge.py:617",
         "launches": sum(by_path("merge").values()), "launches_by_path": by_path("merge"),
         "launches_per_frifull_step": full_res["merge_launches_per_step"],
         "launches_per_fciqmc_step": fq_res["merge_launches_per_step"],
         "launches_by_observables_layout": {"observables": obs_res["launches_by_layout"],
                                            "obs_repl": repl_res["launches_by_layout"]},
         "max_abs_err": max(m["rung"]["max_abs_err"], m["chunk_regime"]["max_abs_err"],
                            fq_res["first_step"]["max_abs_err"],
                            *(r["max_abs_err"] for k, r in checks.items()
                              if k.startswith("merge W=")),
                            *(sh["max_abs_err"] for sh in merge_shapes.values())),
         **merge_timing("merge"), "shapes": merge_shapes},
        {"name": "emit", "route": "cuda", "source": "fries_tpu_torch/csrc/emit.cu",
         "replaces": "fries_tpu/runtime/pallas_emit.py:147",
         "launches": sum(by_path("emit").values()), "launches_by_path": by_path("emit"),
         "max_abs_err": max(s["max_abs_err"] for s in shapes.values()),
         **emit_step, "bound_by": frisys_bound_by, "library_ms": None, "shapes": shapes},
        {"name": "merge_multi", "route": "cuda",
         "source": "fries_tpu_torch/csrc/merge_multi.cu",
         "replaces": "fries_tpu/runtime/pallas_merge.py:894",
         "launches": sum(by_path("merge_multi").values()),
         "launches_by_path": by_path("merge_multi"),
         "launches_per_subspfull_step": sfull_res["merges_per_step"],
         "max_abs_err": max(c["max_abs_err"], sfull_res["real_chunk"]["max_abs_err"],
                            *(r["max_abs_err"] for k, r in checks.items()
                              if k.startswith("merge_multi W=")),
                            qzs_res["real_step"]["max_abs_err"],
                            ne2_res["ne2_qz_subsp"]["real_step"]["max_abs_err"]),
         **merge_timing("merge_multi"),
         "shapes": {"subspfull_chunk": multi_shape, **{
             f"{name} (W={w})": {
                 **merge_timing(f"merge_multi {name}"),
                 **{key: r["real_step"][key] for key in (
                     "max_abs_err", "arena_rows", "spawns", "live_spawns", "unique_targets",
                     "longest_run")}}
             for name, w, r in (("ne_qz_subsp", 4, qzs_res),
                                ("ne2_qz_subsp", 7, ne2_res["ne2_qz_subsp"]))}, **{
             f"ne_qz_subsp shapes W={w}, made-up": {
                 **timing(f"merge_multi ne_qz_subsp shapes W={w}"),
                 **{key: t[f"merge_multi ne_qz_subsp shapes W={w}"][key] for key in sort_keys},
                 "max_abs_err": checks[f"merge_multi W={w}"]["max_abs_err"]}
             for w in WIDER_MULTI_TIMED}}},
        {"name": "attempt", "route": "cuda", "source": "fries_tpu_torch/csrc/attempt.cu",
         "replaces": None, "launches": sum(by_path("launch.attempt").values()),
         "launches_by_path": by_path("launch.attempt"),
         "launches_per_fciqmc_step": fq_res["launches"]["launch.attempt"] // N_TIMED,
         "max_rel_err": fq_res["kernel_g"]["max_rel_err"],
         "device_ms": fq_res["kernel_g"]["kernel"]["device_ms"],
         "call_ms": fq_res["kernel_g"]["kernel"]["call_ms"],
         "plain_device_ms": fq_res["kernel_g"]["plain"]["device_ms"],
         "plain_call_ms": fq_res["kernel_g"]["plain"]["call_ms"],
         "bound_ms": fq_res["kernel_g"]["bound_ms"], "bound_by": fq_res["kernel_g"]["bound_by"],
         "roofline_pct": 100 * fq_res["kernel_g"]["bound_ms"]
         / fq_res["kernel_g"]["kernel"]["device_ms"]},
        {"name": "probe_reshape", "route": "cuda",
         "source": "fries_tpu_torch/csrc/probe_reshape.cu",
         "replaces": "tools/probe_reshape.py:33", "launches": p["launches"],
         "max_abs_err": p["max_abs_err"], **timing("probe_reshape")},
        {"name": "probe_copy", "route": "cuda", "source": "fries_tpu_torch/csrc/probe_copy.cu",
         "replaces": "fries_tpu/runtime/pallas_merge.py:77", "launches": pc["launches"],
         "max_abs_err": pc["max_abs_err"], **timing("probe_copy")},
    ]
    log(f"cli resume: {json.dumps(cli_res)}")
    brief_shard = {k: shard_res[k] for k in ("probe_gloo_cuda", "probe_nccl_one_rank",
                                            "equivalence_max_abs_err", "seconds")}
    for name in ("rung_real_nccl1", "subsp_nccl1"):
        brief_shard[name] = {k: v for k, v in shard_res[name].items() if k != "h_mat_last"}
    log(f"sharding summary: {json.dumps(brief_shard)}")
    idle = {name: profiles[name]["device_idle_share"] for name in profiles}
    configs = {"ne_qz": qz_res["ne_qz"], "ne_qz unnorm": qz_res["ne_qz unnorm"],
               "ne_qz_subsp": qzs_res, "ne2_qz": ne2_res["ne2_qz"],
               "ne2_qz_subsp": ne2_res["ne2_qz_subsp"], **real_res}
    brief = {name: {k: v for k, v in r.items() if k not in ("emit_checks", "real_step",
                                                             "real_chunk")}
             for name, r in configs.items()}
    log(f"real molecules: {json.dumps({'integrals': int_res, 'configs': brief})}")
    log(f"real molecules, device idle share (profile_step): {json.dumps(idle)}")
    log(f"ne2_qz system: {json.dumps(ne2_res['system'])}")
    log(f"frisys_hh_wide: {json.dumps({k: v for k, v in hhw_res.items() if k != 'emit_checks'})}")
    log(f"native reader: {json.dumps(native_res)}")
    log(f"past bounds: {json.dumps(past_res)}")
    log(f"profiling trace: {json.dumps(trace_res)}")
    log(f"kernel F: {json.dumps(plan_res)}")
    log(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
