"""The walker attempt pass on the card: kernel G (``csrc/attempt.cu``), its
tables and its wrapper.

:func:`fries_tpu_torch.drivers.fciqmc._attempt_pass` draws one excitation
per attempt slot.  Its plain version
(:func:`~fries_tpu_torch.drivers.fciqmc._attempt_pass_plain`) samples a
heat-bath double and a single for every slot over (A, K) rows of bits,
weights and gathers, and keeps one.  Kernel G does the same work per slot
in registers: slot k of the arena row ``parent[k]`` draws ``is_doub`` and
its sampler's variates as element k of the key nodes' uniforms, so it draws
the plain pass's variates bit for bit, samples only the excitation it takes,
and writes the spawn before rounding, its key and the initiator flag.  The
categorical rows' f64 totals and f32 prefixes are summed left to right with
round-to-nearest operations, as ``compress.sample_categorical_rows`` sums
them; the rows' normalizing sums, the single's element and ``norm_weight``'s
sums run left to right where torch reduces in its own order, so a value may
differ from the plain pass's in its last bits, and a draw differs only where
a uniform lands within those bits of a boundary.  No state is shared between
slots, so a launch repeats bit for bit.

The kernel takes heat-bath (``"HB"``) systems of at most :data:`MAX_ORB`
orbitals and :data:`MAX_ELEC` electrons (:func:`fits`: keys of up to four
32-bit words); :func:`tables` gives None for the CPU and the ``"NU"``
distribution, where the pass takes its plain version, and raises for a
heat-bath system on the card past those bounds.  Each launch counts one in
``profiling``'s ``launch.attempt``; while a profiler records, the draws past
every f32 prefix that took the last column of positive weight go to the
device counter ``sampler.fallback``, as in the plain samplers.

On the H100 the pass would be bound by its ~150 bytes a slot at N2's shapes
(``csrc/attempt.cu`` has the design note).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from fries_tpu_torch import _build, dets, profiling, rng

F64 = torch.float64
MAX_ORB = 64            # kMaxOrb in csrc/attempt.cu
MAX_ELEC = 32           # kMaxElec
N_IRREPS = 8


@dataclass(frozen=True)
class Tables:
    """Kernel G's inputs besides the slots: the heat-bath and symmetry tables
    packed as the kernel stages them, the integrals, the sizes and the
    configuration's scalars."""
    ftab: torch.Tensor      # f64: d_same, d_diff, exch_sqrt (n*n each), s_tens,
                            # exch_norms (n each), symm_sums (n*8)
    itab: torch.Tensor      # int32: symm (n), symm_counts (8), lookup (8 * max_count)
    hcore: torch.Tensor
    eris: torch.Tensor
    n_orb: int
    n_elec: int
    n_words: int
    max_count: int
    half_frz: int
    scalars: tuple          # eps, p_doub, 1 / p_doub, 1 / (1 - p_doub), init_thresh


def fits(n_orb: int, n_elec: int, n_words: int, max_count: int) -> bool:
    """Whether kernel G takes a system of these sizes (``fits`` in
    ``csrc/attempt.cu``)."""
    return (1 <= n_orb <= MAX_ORB and 2 <= n_elec <= MAX_ELEC and n_elec // 2 < n_orb
            and n_words == dets.n_words(2 * n_orb) and 1 <= max_count <= MAX_ORB)


def tables(ham, tens, symm, lookup, symm_counts, eps: float, p_doub: float,
           init_thresh: float):
    """Kernel G's :class:`Tables` for ``ham`` on its card, or None where the
    plain pass runs: on the CPU and without heat-bath tables (``tens`` None:
    the ``"NU"`` distribution).  A heat-bath system on the card past
    :func:`fits` raises ValueError.  ``symm_sums`` is
    ``heat_bath.norm_weight``'s ``exch_sqrt @ onehot(symm)``, computed once
    by the same product."""
    if tens is None or not ham.hcore.is_cuda:
        return None
    if not fits(ham.n_orb, ham.n_elec, ham.n_words, lookup.shape[1]):
        raise ValueError(
            f"kernel G takes heat-bath systems of at most {MAX_ORB} orbitals and {MAX_ELEC} "
            f"electrons, got {ham.n_orb} orbitals, {ham.n_elec} electrons, {ham.n_words} key "
            f"words and symmetry rows of {lookup.shape[1]}")
    irrep_onehot = symm[:, None] == torch.arange(N_IRREPS, device=symm.device)[None, :]
    symm_sums = tens.exch_sqrt @ irrep_onehot.to(F64)
    ftab = torch.cat([tens.d_same.reshape(-1), tens.d_diff.reshape(-1),
                      tens.exch_sqrt.reshape(-1), tens.s_tens, tens.exch_norms,
                      symm_sums.reshape(-1)]).to(F64).contiguous()
    itab = torch.cat([symm, symm_counts, lookup.reshape(-1)]).to(torch.int32).contiguous()
    return Tables(ftab=ftab, itab=itab, hcore=ham.hcore.contiguous(),
                  eris=ham.eris.contiguous(), n_orb=ham.n_orb, n_elec=ham.n_elec,
                  n_words=ham.n_words, max_count=int(lookup.shape[1]),
                  half_frz=ham.n_frozen // 2,
                  scalars=(eps, p_doub, _inverse(p_doub), _inverse(1 - p_doub), init_thresh))


def _inverse(p: float) -> float:
    """1 / p, infinite at 0: a share of 0 is never drawn (as torch divides)."""
    return 1.0 / p if p else math.inf


def node_keys(k_split, kd, ks):
    """The 64-bit keys of the nodes a pass draws from, in the kernel's order:
    ``k_split``, ``kd.split(4)`` (the double's four categorical draws) and
    ``ks.split(2)`` (the single's two).  Nodes that are not
    :class:`rng.KeyTree` s raise TypeError: the kernel draws only their
    generator."""
    if not all(isinstance(k, rng.KeyTree) for k in (k_split, kd, ks)):
        raise TypeError("kernel G draws from rng.KeyTree nodes, got "
                        f"{[type(k).__name__ for k in (k_split, kd, ks)]}")
    return [k_split.key, *(c.key for c in kd.split(4)), *(c.key for c in ks.split(2))]


def launch(tab: Tables, keys, occ, n_walk, walk_sign, parent, valid, nodes, exc=None):
    """One launch of kernel G over the slots of ``parent`` (A,) int64 and
    ``valid`` (A,) bool, from the arena's ``keys`` (C, W), occupied lists
    ``occ`` (C, E; rows at any stride), ``n_walk`` and ``walk_sign`` (C,)
    f64, with the key nodes ``nodes`` (:func:`node_keys`).  Returns (words (A, W), spawn values
    before rounding (A,) f64, initiator flags (A,) bool); ``exc``, an (A,)
    int64 tensor, gets each slot's draws (bit 0 a double, bit 1 a valid
    draw, then 8 bits per orbital: o1, o2, u1, u2 of a double, o, u of a
    single; -1 for a slot that is not valid).  Counts one in
    ``launch.attempt``."""
    a = parent.shape[0]
    c, w, e = keys.shape[0], tab.n_words, tab.n_elec
    if occ.dtype != torch.int64 or tuple(occ.shape) != (c, e) or occ.stride(1) != 1 \
            or not occ.is_cuda:
        raise ValueError(f"fries_attempt: occ must be int64 ({c}, {e}) on the card with unit "
                         f"column stride, got {occ.dtype} {tuple(occ.shape)} {occ.stride()}")
    for name, t, dt, shape in (("keys", keys, torch.int64, (c, w)),
                               ("n_walk", n_walk, F64, (c,)), ("walk_sign", walk_sign, F64, (c,)),
                               ("parent", parent, torch.int64, (a,)),
                               ("valid", valid, torch.bool, (a,))):
        _build.check_tensor("fries_attempt", name, t, dt, shape)
    if exc is not None:
        _build.check_tensor("fries_attempt", "exc", exc, torch.int64, (a,))
    dev = keys.device
    words = torch.empty((a, w), dtype=torch.int64, device=dev)
    vals = torch.empty(a, dtype=F64, device=dev)
    ini = torch.empty(a, dtype=torch.bool, device=dev)
    fallback = (torch.zeros(1, dtype=torch.int64, device=dev) if profiling.recording()
                else None)
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    node_arr = (ctypes.c_uint64 * 7)(*nodes)
    scal_arr = (ctypes.c_double * 5)(*tab.scalars)
    err = _build.load().fries_attempt(
        p(keys), p(occ), p(n_walk), p(walk_sign), p(parent), p(valid), p(tab.ftab),
        p(tab.itab), p(tab.hcore), p(tab.eris), p(words), p(vals), p(ini), p(exc), p(fallback),
        node_arr, scal_arr, ctypes.c_longlong(a), ctypes.c_longlong(occ.stride(0)),
        ctypes.c_int(tab.n_orb), ctypes.c_int(e), ctypes.c_int(w), ctypes.c_int(tab.max_count),
        ctypes.c_int(tab.hcore.shape[0]), ctypes.c_int(tab.half_frz),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"fries_attempt launch failed: {_build.error_string(err)}")
    profiling.count("launch.attempt")
    if fallback is not None:
        profiling.device_count("sampler.fallback", lambda: fallback)
    return words, vals, ini
