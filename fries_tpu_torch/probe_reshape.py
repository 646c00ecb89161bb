"""The packed-to-column relayout probe: an (8, 128) int32 tile becomes a
(1024, 1) column with pos = r * 128 + lane.

Counterpart of ``tools/probe_reshape.py``, whose ``direct`` body
(probe_reshape.py:44, run through ``pl.pallas_call`` at :33) checked that
Mosaic lowers the relayout the deleted v3 merge needed.  :func:`reshape`
launches the CUDA kernel ``csrc/probe_reshape.cu`` for a tensor on the card
and takes the plain version (:func:`reshape_plain`) for a tensor on the
CPU.  Usage (the tool's output, for the port)::

    python -m fries_tpu_torch.probe_reshape [--device cpu]
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from fries_tpu_torch import _build, profiling

RB, LANES = 8, 128
TB = RB * LANES


def reshape_plain(x):
    """(8, 128) -> (1024, 1), pos = r * 128 + lane."""
    return x.reshape(TB, 1)


def reshape(x):
    """The relayout: the CUDA kernel for a tensor on the card, the plain
    version for a tensor on the CPU."""
    if not x.is_cuda:
        return reshape_plain(x)
    _build.check_tensor("probe_reshape", "x", x, torch.int32, (RB, LANES))
    out = torch.empty((TB, 1), dtype=torch.int32, device=x.device)
    err = _build.load().fries_probe_reshape(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"probe_reshape launch failed: {_build.error_string(err)}")
    profiling.count("launch.probe_reshape")
    return out


def probe(device) -> bool:
    """The tool's check: the relayout of arange(1024) viewed (8, 128) is
    the column arange(1024)."""
    x = torch.arange(TB, dtype=torch.int32, device=device).reshape(RB, LANES)
    expect = torch.arange(TB, dtype=torch.int32)[:, None]
    return torch.equal(reshape(x).cpu(), expect)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_reshape: no CUDA device is available (pass --device cpu)")
    ok = probe(torch.device(args.device))
    print(f"direct reshape ({RB},{LANES})->({TB},1): {'OK' if ok else 'WRONG RESULT'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
