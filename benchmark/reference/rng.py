"""The key tree of the walker path's draws: a counter-based generator (the
splitmix64 mixer over a 64-bit node key and the element index), with
``fold``, ``split``, ``uniform`` and ``binomial``.  Frozen copy of the
port's ``rng.py``; ``binomial`` is ``torch.binomial`` under a generator on
the node's device seeded with the node's key, so the reference draws what
the program draws on the same device.
"""

from __future__ import annotations

import math

import torch

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MUL1 = 0xBF58476D1CE4E5B9
_MUL2 = 0x94D049BB133111EB
_SPLIT_TAG = 0x5EED5EED5EED5EED


def _signed(x: int) -> int:
    """A 64-bit unsigned Python int as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def mix64(z: int) -> int:
    """The splitmix64 output function on a Python int (64-bit wrap)."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * _MUL1) & _MASK64
    z = ((z ^ (z >> 27)) * _MUL2) & _MASK64
    return z ^ (z >> 31)


def _lsr(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def mix64_tensor(z: torch.Tensor) -> torch.Tensor:
    """:func:`mix64` on int64 tensors (products wrap modulo 2^64)."""
    z = (z ^ _lsr(z, 30)) * _signed(_MUL1)
    z = (z ^ _lsr(z, 27)) * _signed(_MUL2)
    return z ^ _lsr(z, 31)


class KeyTree:
    """A node of the port's key tree: a 64-bit key and a device."""

    def __init__(self, seed: int, device=None, *, _key: int | None = None):
        self.key = mix64(int(seed) + _GOLDEN) if _key is None else _key
        self.device = torch.device("cpu") if device is None else torch.device(device)

    def _child(self, key: int) -> KeyTree:
        return KeyTree(0, self.device, _key=key)

    def fold(self, i: int) -> KeyTree:
        return self._child(mix64(self.key ^ mix64(int(i) * _GOLDEN + 1)))

    def split(self, n: int) -> list[KeyTree]:
        base = mix64(self.key ^ _SPLIT_TAG)
        return [self._child(mix64(base + (j + 1) * _GOLDEN)) for j in range(n)]

    def uniform(self, shape=()) -> torch.Tensor:
        shape = tuple(shape)
        idx = torch.arange(math.prod(shape), dtype=torch.int64, device=self.device)
        z = mix64_tensor(idx * _signed(_GOLDEN) + _signed(self.key))
        return (_lsr(z, 11).to(torch.float64) * 2.0 ** -53).reshape(shape)

    def binomial(self, n: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.key)
        count = n.to(device=self.device, dtype=torch.float64)
        prob = p.to(device=self.device, dtype=torch.float64)
        return torch.binomial(count, prob, generator=gen).to(torch.int64)
