"""Initiator FCIQMC for molecules: integer walkers (fciqmc_mol) and the
floating-point variant (fciqmc_fp_mol), with near-uniform or heat-bath
Power-Pitzer excitation generation.

Counterpart of ``fries_tpu/drivers/fciqmc.py``.  The
per-walker loops become a statically capped attempt buffer: attempt slot k
belongs to the determinant whose interval of the running walker counts holds
k (:func:`_attempt_parents`), and every slot samples one excitation
(:func:`_attempt_pass`), valid or not, so a step's shapes are set by the
configuration and the walker total is never read on the host: with kernel G
on the card for heat-bath systems within its bounds
(:mod:`fries_tpu_torch.runtime.attempt`), elsewhere with the batched
generators of :mod:`fries_tpu_torch.ops.near_uniform`
(:func:`_attempt_pass_plain`).  Spawns are rounded binomially (integer walkers) or
below 0.01 (fp walkers); death and cloning round |1 - eps (H_ii - S)| n_walk
binomially per determinant before the merge; the fp variant rounds the
merged vector's elements below 1 stochastically.  One merge per step
(:func:`fries_tpu_torch.runtime.arena.accumulate_best`, kernel A on the
card) adds the spawns into the post-death one-row arena, whose row is both
the initiator rule's origin and the destination; a compaction that keeps HF
follows.

Random draws come from a key node (:mod:`fries_tpu_torch.rng`) in the
reference's tree: ``fold(iterat)``, its ``split(4)`` into (split, spawn,
death, round), ``fold(31)`` (fp attempt counts) and ``fold(37)`` (fp vector
rounding) of the iteration node, ``spawn.split(2)`` into the doubles' and
the singles' nodes, ``death.fold(1)``.

``spawn_cap`` keeps the live spawns in a buffer of that many rows before the
merge by a stable partition (the reference sorts the whole attempt stream by
key; the merge sorts anyway, and while the live spawns fit both keep the
same rows).  On overflow the kept rows may differ from the reference's, and
the run stops there in both packages.  Not ported: ``attempt_chunk`` (a
workaround for the TPU's memory).

Hash sharding (:func:`build_sharded`): each rank draws from its own stream
(the iteration's node folded with the rank, as the reference seeds each
rank), sends its spawns to their owners after death and merges what it
receives; the estimator, the norm and the counts are all-reduced.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from fries_tpu_torch import compress, dets, parallel, profiling, rng
from fries_tpu_torch.drivers import frisys, power
from fries_tpu_torch.ops import heat_bath as hb
from fries_tpu_torch.ops import molecule as mol
from fries_tpu_torch.ops import near_uniform as nu
from fries_tpu_torch.runtime import arena as ar
from fries_tpu_torch.runtime import attempt

F64 = torch.float64
SPARE = 4096   # slots the spawn partition spreads its dropped rows over


@dataclass(frozen=True)
class FciqmcConfig:
    eps: float
    target_walkers: float   # target one-norm of the shift control
    capacity: int
    attempt_cap: int        # spawn attempts per step (>= the walker total)
    init_thresh: float = 0.0
    shift_interval: int = 10
    shift_damping: float = 0.05
    distribution: str = "NU"   # "NU" | "HB"
    integer_walkers: bool = True
    spawn_cap: int = 0      # rows of the merge's spawn buffer (0 = attempt_cap)
    axis_name: str | None = None   # the reference's mesh axis (unused here)
    n_shards: int = 1
    exchange_cap: int = 0   # see power.PowerConfig.exchange_cap


@dataclass
class FciqmcState:
    arena: ar.Arena         # one value row
    en_shift: torch.Tensor
    last_norm: torch.Tensor
    key: object             # key node (rng.KeyTree or the reference's tree)
    iterat: int


@profiling.spanned("fries.attempt_parents")
def _attempt_parents(n_walk, attempt_cap: int):
    """Map attempt slots to parent rows: slot k belongs to the row whose
    interval of the running counts ``n_walk`` (int64) holds it.  Returns
    (parent (A,), valid (A,), total)."""
    offsets = torch.cumsum(n_walk, 0) - n_walk
    total = n_walk.sum()
    slot = torch.arange(attempt_cap, dtype=n_walk.dtype, device=n_walk.device)
    parent = torch.searchsorted(offsets, slot, right=True) - 1
    return parent.clamp(0, n_walk.shape[0] - 1), slot < total, total


@profiling.spanned("fries.spawn_compaction")
def _partition_spawns(words, vals, ini, cap: int):
    """The live spawns (valid key) in stream order in a ``cap``-row buffer,
    sentinel-padded; returns (words, vals, ini, overflow).  Beyond ``cap``
    the later live spawns are dropped and ``overflow`` is set."""
    s = words.shape[0]
    dev = words.device
    live = ~dets.is_invalid(words)
    rank = torch.cumsum(live, 0) - 1
    spare = cap + torch.arange(s, device=dev) % SPARE
    dest = torch.where(live & (rank < cap), rank, spare)
    out_w = dets.invalid_det(words.shape[1], dev).repeat(cap + SPARE, 1)
    out_w[dest] = words
    out_v = vals.new_zeros(cap + SPARE)
    out_v[dest] = vals   # a dead row's value is 0
    out_i = torch.zeros(cap + SPARE, dtype=torch.bool, device=dev)
    out_i[dest] = ini
    return out_w[:cap], out_v[:cap], out_i[:cap], live.sum() > cap


def trial_vectors(ham: mol.MolecularHamiltonian):
    """(num_keys, num_vals) of (H - E_HF)|HF> with HF's own element 0, as
    the projected estimator's numerator vector."""
    hf_words, hf_occ, _ = mol.hf_reference(ham)
    tmpl = mol.ExcitationTemplate.build(ham.n_orb, ham.n_elec)
    tw, ta = mol.exact_offdiag_batch(ham, tmpl, hf_words[None], hf_occ[None],
                                     torch.ones(1, dtype=F64, device=ham.device), 1.0)
    keep = ta[0] != 0
    return (torch.cat([hf_words[None], tw[0][keep]]),
            torch.cat([torch.zeros(1, dtype=F64, device=ham.device), ta[0][keep]]))


@dataclass(frozen=True)
class SpawnTables:
    """What the attempt pass reads besides its arguments: the Hamiltonian,
    the configuration, the doubles' share, the symmetry tables on the
    device, the heat-bath tensors (None for NU), the sentinel key and kernel
    G's tables (:func:`fries_tpu_torch.runtime.attempt.tables`: None where
    the plain pass runs)."""
    ham: mol.MolecularHamiltonian
    cfg: FciqmcConfig
    p_doub: float
    lookup: torch.Tensor
    symm: torch.Tensor
    symm_counts: torch.Tensor
    tens: object
    sentinel: torch.Tensor
    kernel: object


def spawn_tables(ham: mol.MolecularHamiltonian, cfg: FciqmcConfig,
                 p_doub: float) -> SpawnTables:
    """The attempt pass's :class:`SpawnTables` for this system."""
    dev = ham.device
    syminfo = mol.SymmInfo.build(ham.symm.cpu().numpy())
    lookup = torch.as_tensor(syminfo.lookup, device=dev)
    symm = torch.as_tensor(syminfo.symm, device=dev)
    symm_counts = torch.as_tensor(syminfo.counts, device=dev)
    tens = hb.setup(ham) if cfg.distribution == "HB" else None
    return SpawnTables(
        ham=ham, cfg=cfg, p_doub=p_doub, lookup=lookup, symm=symm, symm_counts=symm_counts,
        tens=tens, sentinel=dets.invalid_det(ham.n_words, dev),
        kernel=attempt.tables(ham, tens, symm, lookup, symm_counts, cfg.eps, p_doub,
                              cfg.init_thresh))


def make_spawner(ham: mol.MolecularHamiltonian, cfg: FciqmcConfig, p_doub: float):
    """The attempt pass ``spawn(keys, occ, n_walk, walk_sign, parent,
    valid, k_split, k_doub, k_sing, k_round) -> (words, values, initiator
    flags)``: :func:`_attempt_pass` on this system's tables, looked up in
    the module at each call."""
    tables = spawn_tables(ham, cfg, p_doub)

    def spawn(*args):
        return _attempt_pass(tables, *args)

    return spawn


@profiling.spanned("fries.spawn")
def _attempt_pass(t: SpawnTables, keys, occ, n_walk, walk_sign, parent, valid, k_split, kd,
                  ks, k_round):
    """One excitation sampled and weighed per attempt slot of the parents
    ``parent`` (arena rows), rounded, sentinel-keyed where the value is 0:
    (words, values, initiator flags).

    The draws and weights come from kernel G
    (:func:`fries_tpu_torch.runtime.attempt.launch`) where it takes the
    system (``t.kernel``: heat-bath on the card), from
    :func:`_attempt_pass_plain` on the CPU and for ``"NU"`` (counted in
    ``profiling``'s ``attempt.plain_on_card`` on the card).  Kernel G's key
    nodes must be :class:`rng.KeyTree` s (:func:`attempt.node_keys` raises
    otherwise).  The binomial rounding follows in torch either way."""
    if t.kernel is not None:
        words, spawn_val, ini = attempt.launch(t.kernel, keys, occ, n_walk, walk_sign, parent,
                                               valid, attempt.node_keys(k_split, kd, ks))
    else:
        if keys.is_cuda:
            profiling.count("attempt.plain_on_card")
        words, spawn_val, ini = _attempt_pass_plain(t, keys, occ, n_walk, walk_sign, parent,
                                                    valid, k_split, kd, ks)
    rounded = compress.round_binomially(
        k_round, spawn_val.abs(),
        torch.ones(spawn_val.shape[0], dtype=torch.int32, device=spawn_val.device)).to(F64)
    if t.cfg.integer_walkers:
        spawn_val = torch.sign(spawn_val) * rounded
    else:   # spawns below 0.01 are rounded, larger ones keep their value
        spawn_val = torch.where(spawn_val.abs() < 0.01,
                                torch.sign(spawn_val) * rounded, spawn_val)
    words = torch.where((spawn_val != 0)[:, None], words, t.sentinel)
    return words, spawn_val, ini


def _attempt_pass_plain(t: SpawnTables, keys, occ, n_walk, walk_sign, parent, valid, k_split,
                        kd, ks):
    """The attempt pass's draws and weights in torch, before the rounding:
    a double (heat-bath or near-uniform) and a single sampled for every
    slot, the one ``k_split`` picks kept.  Returns (words (A, W), spawn
    values (A,), initiator flags (A,)); a slot whose draw is not valid has
    the value 0."""
    ham, cfg, p_doub = t.ham, t.cfg, t.p_doub
    dev = ham.device
    n_orb, n_elec = ham.n_orb, ham.n_elec
    a_cap, eps = cfg.attempt_cap, cfg.eps
    p_occ = occ[parent]
    p_keys = keys[parent]
    p_bits = dets.unpack_bits(p_keys, 2 * n_orb)
    counts = hb.unocc_symm_counts(n_orb, n_elec, t.symm, t.symm_counts, p_occ)
    is_doub = k_split.uniform((a_cap,)).to(dev) < p_doub
    if t.tens is not None:
        d = nu.sample_doubles_heat_bath(kd, t.tens, n_orb, n_elec, t.symm, t.lookup, p_occ,
                                        p_bits)
    else:
        d = nu.sample_doubles(kd, n_orb, n_elec, t.symm, t.lookup, p_occ, p_bits, counts)
    s = nu.sample_singles(ks, n_orb, n_elec, t.symm, t.lookup, p_occ, p_bits, counts)

    # one walker's weight per attempt (the attempt count is the rounded
    # population in both variants)
    per_attempt = valid.to(F64)
    dmel = mol.doub_matr_el(ham, d["o1"], d["o2"], d["u1"], d["u2"])
    damp_mag = eps * dmel / d["prob"] / p_doub * per_attempt
    dwords, dsign = dets.double_parity(p_keys, d["o1"], d["o2"], d["u1"], d["u2"])
    dmask = valid & is_doub & d["valid"]
    smel = mol.sing_matr_el(ham, s["o"], s["u"], p_occ)
    samp_mag = eps * smel / s["prob"] / (1 - p_doub) * per_attempt
    swords, ssign = dets.single_parity(p_keys, s["o"], s["u"])
    smask = valid & ~is_doub & s["valid"]

    mag = torch.where(dmask, damp_mag, torch.where(smask, samp_mag, 0.0))
    sign_f = torch.where(dmask, dsign, ssign).to(F64)
    spawn_val = -mag * sign_f * walk_sign[parent]
    words = torch.where(dmask[:, None], dwords, swords)
    return words, spawn_val, n_walk[parent] > cfg.init_thresh


@profiling.spanned("fries.death")
def _death(key, death_p, n_walk, n_walk_int, integer_walkers: bool):
    """Post-death populations: each determinant's |death_p| n_walk rounded
    binomially (integer walkers) or kept (fp walkers), with death_p's sign."""
    if integer_walkers:
        return torch.sign(death_p) * compress.round_binomially(
            key, death_p.abs(), n_walk_int).to(F64)
    return death_p * n_walk


@profiling.spanned("fries.estimator")
def _estimate(a, num_keys, num_vals, den_keys, den_vals):
    """The projected estimator's (numerator, denominator) on arena row 0."""
    return ar.dot(a, num_keys, num_vals), ar.dot(a, den_keys, den_vals)


def build(ham: mol.MolecularHamiltonian, cfg: FciqmcConfig, seed: int,
          init_walkers: float = 100.0, shards=None):
    """FCIQMC on ``ham``'s device.  Returns (step, run_steps, state, aux):
    ``step(state, num_keys, num_vals, den_keys, den_vals, ref_key) ->
    (state, metrics)`` with the reference's eight metrics,
    ``run_steps(..., n_iter)`` a host loop of steps with the metrics
    stacked, ``state`` HF with ``init_walkers`` walkers and the key tree
    ``rng.KeyTree(seed)`` on the device, ``aux`` the estimator vectors,
    ``e_ref``, ``p_doub``, ``merge_input(state)``: the post-death arena
    and the spawn stream (words, values, initiator flags) that a step from
    ``state`` merges (before the exchange), and ``attempt_args(state)``:
    that step's arguments of :func:`_attempt_pass_plain` after its tables,
    which kernel G shares (all of :func:`_attempt_pass`'s but
    ``k_round``).  ``shards``: see
    :func:`build_sharded`."""
    if cfg.distribution not in ("NU", "HB"):
        raise ValueError(f"unknown distribution {cfg.distribution!r}")
    dev = ham.device
    p_doub = frisys.hf_p_doub(ham, mol.SymmInfo.build(ham.symm.cpu().numpy()))
    spawn = make_spawner(ham, cfg, p_doub)
    hf_words, _, hf_en = mol.hf_reference(ham)
    hf_en = float(hf_en)
    parallel.check_world(cfg.n_shards, shards)
    n_bits, n_elec = ham.n_bits, ham.n_elec
    a_cap, eps = cfg.attempt_cap, cfg.eps

    def attempt_args(state: FciqmcState):
        """The step's key node, its death and rounding nodes, the arena's
        attempt counts and their total, and the attempt pass's draws' and
        weights' arguments from ``state``: (key_iter, k_death, k_round,
        n_walk_int, total, (keys, occ, n_walk, walk_sign, parent, valid,
        k_split, kd, ks))."""
        a = state.arena
        key_iter = state.key.fold(state.iterat)
        if shards is not None:
            key_iter = key_iter.fold(shards.rank)
        k_split, k_spawn, k_death, k_round = key_iter.split(4)
        vals0 = torch.where(a.valid, a.vals[0], 0.0)
        arena_occ = dets.occ_list(a.keys, n_bits, n_elec)
        n_walk = vals0.abs()
        if cfg.integer_walkers:
            n_walk_int = torch.round(n_walk).to(torch.int64)
        else:   # attempt counts round_binomially(|v|, 1), one walker's weight each
            n_walk_int = compress.round_binomially(
                key_iter.fold(31), n_walk, torch.ones_like(n_walk, dtype=torch.int32))
        parent, valid, total = _attempt_parents(n_walk_int, a_cap)
        kd, ks = k_spawn.split(2)
        return key_iter, k_death, k_round, n_walk_int, total, (
            a.keys, arena_occ, n_walk, torch.sign(vals0), parent, valid, k_split, kd, ks)

    def merge_input(state: FciqmcState):
        """(post-death one-row arena, spawn words, values, initiator flags,
        attempt / spawn buffer overflow, the iteration's key node)."""
        a = state.arena
        key_iter, k_death, k_round, n_walk_int, total, args = attempt_args(state)
        _, arena_occ, n_walk, walk_sign = args[:4]
        arena_diag = mol.diag_matrel_chunked(ham, arena_occ) - hf_en
        overflow = total > a_cap
        words, spawn_val, ini = spawn(*args, k_round)
        if cfg.spawn_cap and cfg.spawn_cap < a_cap:
            words, spawn_val, ini, cap_over = _partition_spawns(words, spawn_val, ini,
                                                                cfg.spawn_cap)
            overflow = overflow | cap_over

        # death / cloning before the merge: spawns land on the post-death
        # populations
        death_p = (1 - eps * (arena_diag - state.en_shift)) * walk_sign
        new_v = _death(k_death.fold(1), death_p, n_walk, n_walk_int, cfg.integer_walkers)
        a1 = ar.Arena(keys=a.keys, vals=torch.where(a.valid, new_v, 0.0)[None],
                      n_used=a.n_used)
        return a1, words, spawn_val, ini, overflow, key_iter

    @profiling.stepped
    def step(state: FciqmcState, num_keys, num_vals, den_keys, den_vals, ref_key):
        a1, words, spawn_val, ini, overflow, key_iter = merge_input(state)
        if shards is not None:
            words, spawn_val, rec, exch_over = power.exchange_spawns(
                cfg, shards, words, spawn_val, ini=ini)
            ini, overflow = rec["ini"], overflow | exch_over
        a2, stats = ar.accumulate_best(a1, words, spawn_val, ini, origin_row=0, dest_row=0)

        final_v = torch.where(a2.valid, a2.vals[0], 0.0)
        if not cfg.integer_walkers:
            # elements below 1 rounded to 0 or +-1 after the merge
            small_v = (final_v.abs() < 1.0) & (final_v != 0)
            rv = compress.stochastic_round(key_iter.fold(37), final_v.abs())
            final_v = torch.where(small_v, torch.sign(final_v) * rv, final_v)
        a2v = ar.Arena(keys=a2.keys, vals=final_v[None], n_used=a2.n_used)
        proj_num, proj_den = _estimate(a2v, num_keys, num_vals, den_keys, den_vals)
        glob_norm = final_v.abs().sum()
        proj_num, proj_den, glob_norm = parallel.gsum(shards, proj_num, proj_den,
                                                          glob_norm)
        en_shift, last_norm = state.en_shift, state.last_norm
        if (state.iterat + 1) % cfg.shift_interval == 0:
            en_shift, last_norm = compress.adjust_shift(
                state.en_shift, glob_norm, state.last_norm, cfg.target_walkers,
                cfg.shift_damping / cfg.shift_interval / eps)

        is_ref = dets.det_eq(a2v.keys, ref_key[None, :])
        a3 = ar.compact(a2v, (final_v != 0) | is_ref)
        n_dets, nnonz, sgn_coh, n_over = parallel.gsum(
            shards, a3.n_used[0], ar.n_nonzero(a3).to(torch.int64),
            stats["nonini_occ_add"].to(torch.int64),
            (stats["overflow"] | overflow).to(torch.int64))
        metrics = {
            "proj_num": proj_num, "proj_den": proj_den, "norm": glob_norm,
            "shift": en_shift, "n_dets": n_dets, "nnonz": nnonz,
            "sgn_coh": sgn_coh, "overflow": n_over > 0,
        }
        return FciqmcState(a3, en_shift, last_norm, state.key, state.iterat + 1), metrics

    def run_steps(state, num_keys, num_vals, den_keys, den_vals, ref_key, n_iter: int):
        """``n_iter`` steps (a host loop); returns (state, metrics stacked
        over the steps)."""
        traj = []
        for _ in range(n_iter):
            state, m = step(state, num_keys, num_vals, den_keys, den_vals, ref_key)
            traj.append(m)
        return state, {k: torch.stack([torch.as_tensor(m[k]) for m in traj])
                       for k in traj[0]}

    num_keys, num_vals = trial_vectors(ham)
    init_rows = torch.tensor([[float(init_walkers)]], dtype=F64)
    if shards is not None:
        a = parallel.distribute_rows(hf_words[None].cpu(), init_rows, shards.size,
                                     cfg.capacity, shards.rank, dev)
    else:
        a = ar.from_unsorted(ar.make(cfg.capacity, ham.n_words, 1, device=dev),
                             hf_words[None], init_rows)
    zero = torch.zeros((), dtype=F64, device=dev)
    state = FciqmcState(arena=a, en_shift=zero, last_norm=zero.clone(),
                        key=rng.KeyTree(seed, dev), iterat=0)
    aux = {"e_ref": hf_en, "num_keys": num_keys, "num_vals": num_vals,
           "den_keys": hf_words[None], "den_vals": torch.ones(1, dtype=F64, device=dev),
           "ref_key": hf_words, "p_doub": p_doub,
           "merge_input": lambda st: merge_input(st)[:4],
           "attempt_args": lambda st: attempt_args(st)[-1]}
    return step, run_steps, state, aux


def build_sharded(ham: mol.MolecularHamiltonian, cfg: FciqmcConfig, seed: int, shards,
                  init_walkers: float = 100.0):
    """Hash-sharded FCIQMC on this rank (``shards``, ``cfg.n_shards`` ranks):
    ``cfg.capacity`` and ``attempt_cap`` are per rank.  Returns (step,
    run_steps, state, aux) as :func:`build` does, for this rank."""
    return build(ham, cfg, seed, init_walkers, shards=shards)
