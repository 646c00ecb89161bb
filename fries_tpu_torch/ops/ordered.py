"""Float sums in an order fixed by the data's shape, on the card.

Two of PyTorch's CUDA operations sum floats in an order that depends on
timing, so the same inputs give different last bits from run to run:

* ``torch.cumsum`` of a 1-D float tensor runs CUB's decoupled look-back
  scan, whose tiles take a predecessor's inclusive prefix or its aggregate
  depending on which has been published;
* ``Tensor.index_add_`` (and ``scatter_add_``) on floats add with atomics.

One last bit is enough to move a grid point of a systematic sample across
a boundary, or one element across a threshold fixpoint of ``comp_sub``,
and that re-draws the sample.  These helpers give the same function in an
order fixed by the shapes alone.  On the CPU they are the plain torch call
(both run in one fixed order there), so CPU results are unchanged:

* :func:`cumsum` scans blocks of ``BLOCK`` elements as rows of a 2-D
  tensor (PyTorch's row scan: one fixed tree per row, no atomics) and
  carries the block totals by the same scan, recursively;
* :func:`index_add` is ``index_put_(..., accumulate=True)``, which sorts
  the indices and sums each target's rows in a fixed order (PyTorch's own
  deterministic ``index_add_``);
* :func:`segment_sum` is that sum where the rows already come sorted by
  target (the plain merges' runs of equal keys): ``segment_reduce`` sums
  each run in one fixed order, with no sort;
* :func:`run_sums` sums runs of rows one row after another, on every
  device, so the card gives the CPU's bits; fixed shapes, no host read.
"""

from __future__ import annotations

import torch

BLOCK = 1024


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, 0)`` of a 1-D tensor, in a fixed order on the card."""
    if x.device.type != "cuda" or not x.is_floating_point():
        return torch.cumsum(x, 0)
    return blocked_cumsum(x)


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The scan :func:`cumsum` runs on the card, on any device."""
    n = x.shape[0]
    if n <= 1:
        return x.clone()
    # at least two rows: PyTorch hands a scan whose dimension holds every
    # element to CUB whatever the tensor's shape
    m = max(2, -(-n // BLOCK))
    rows = x.new_zeros(m * BLOCK)
    rows[:n] = x
    rows = torch.cumsum(rows.view(m, BLOCK), 1)
    carry = x.new_zeros(m)
    carry[1:] = blocked_cumsum(rows[:-1, -1].contiguous())
    return (rows + carry[:, None]).view(-1)[:n]


def index_add(out: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out.index_add_(0, index, values)``, in a fixed order on the card."""
    if out.device.type != "cuda" or not out.is_floating_point():
        return out.index_add_(0, index, values)
    return out.index_put_((index,), values, accumulate=True)


def segment_sum(values: torch.Tensor, inv: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Sums over dim 0 of ``values`` in runs: row i belongs to run
    ``inv[i]`` (non-decreasing), run j holds ``counts[j]`` rows.  Returns
    (len(counts), *values.shape[1:]); in a fixed order on the card."""
    if values.device.type != "cuda" or not values.is_floating_point():
        return values.new_zeros((counts.shape[0], *values.shape[1:])).index_add_(0, inv, values)
    return torch.segment_reduce(values, "sum", lengths=counts, axis=0, unsafe=True)


def run_sums(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive runs of the rows of ``values`` (n, k): run j is
    the next ``lengths[j]`` rows, and the rows past ``lengths.sum()`` are
    not read, so ``lengths`` may end in zeros and keep a fixed shape.  Each
    run adds its rows one after another from 0, column by column, on any
    device (``segment_reduce`` over 2-D rows, one thread per run and column
    on the card), the order of ``index_add_`` on the CPU.  Returns
    (len(lengths), k)."""
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0, unsafe=True)
