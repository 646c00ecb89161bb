"""Multi-row sorted-merge accumulate: dispatch between the plain torch merge
(:func:`fries_tpu_torch.runtime.arena.accumulate_multi`) and the CUDA kernel
``csrc/merge_multi.cu`` (kernel C).

Replaces the TPU kernel ``fries_tpu/runtime/pallas_merge.py:_make_kernel_multi``
(launched by ``_merge_call_multi``), reached through
``pallas_merge.accumulate_multi_pallas`` from ``arena.accumulate_multi_best``
in the subspace driver.  Each spawn carries its destination value row; the
initiator rule checks occupancy in that row; every valid arena row passes
through (no fused compaction: the subspace compacts before it spawns).

The Pallas kernel's bound of 14 rows comes from its int32 flag word; kernel C
runs kernel A's design (``csrc/merge_common.cuh``) with one channel per
value row and takes up to :data:`MAX_ROWS`.  The spawn sort runs before it
with ``torch.sort`` (:func:`merge.sort_spawns`).  Outside
:func:`merge.kernel_fits`' bounds the dispatcher
:func:`fries_tpu_torch.runtime.arena.accumulate_multi_best` takes the plain
merge on the card.
"""

from __future__ import annotations

import torch

from fries_tpu_torch import _build, profiling
from fries_tpu_torch.runtime import arena as arena_mod
from fries_tpu_torch.runtime import merge

F64 = torch.float64
MAX_ROWS = merge.MAX_ROWS


def accumulate(arena, spawn_keys, spawn_vals, spawn_rows, spawn_ini):
    """Merge spawns with per-spawn destination rows into the arena.  Tensors
    on the card go through the CUDA kernel, tensors on the CPU through
    :func:`fries_tpu_torch.runtime.arena.accumulate_multi`.  Returns
    (new_arena, stats)."""
    if arena.keys.is_cuda:
        return _accumulate_cuda(arena, spawn_keys, spawn_vals, spawn_rows, spawn_ini)
    return arena_mod.accumulate_multi(arena, spawn_keys, spawn_vals, spawn_rows,
                                      spawn_ini)


def _accumulate_cuda(arena, spawn_keys, spawn_vals, spawn_rows, spawn_ini):
    r = arena.n_vecs
    if not 1 <= r <= MAX_ROWS:
        raise NotImplementedError(f"merge_multi kernel takes 1..{MAX_ROWS} rows, got {r}")
    spawn_rows = spawn_rows.to(torch.int64).contiguous()
    _build.check_tensor("merge_multi", "spawn rows", spawn_rows, torch.int64,
                        (spawn_keys.shape[0],))
    out = merge.launch("merge_multi", "fries_merge_multi", arena, spawn_keys,
                       spawn_vals.to(F64).contiguous(), spawn_ini.contiguous(), r,
                       spawn_args=(merge.ptr(spawn_rows),))
    profiling.count("launch.merge_multi")
    return out
