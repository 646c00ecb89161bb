"""A cell's system worked out from its integrals by definition.

Determinants are rows of occupation bits over the 2n spin orbitals (alpha
0..n-1, beta n..2n-1) and, for sorting and matching, the same bit string cut
into columns of 62 bits, most significant column first: the vector's order
is that of the bit string read as an unsigned number, bit b worth 2^b.

Matrix elements follow the Slater-Condon rules on the physicist-notation
integrals <pq|rs>; the sign of an excitation is the parity of the occupied
orbitals that each moved electron passes, one electron after the other.
The heat-bath Power-Pitzer (HB-PP) tables and every selection probability
are computed from their definitions, with loops over orbitals.
"""

from __future__ import annotations

import numpy as np
import torch

from . import REAL

COL_BITS = 62


class System:
    """Integrals, irreps and the tables of one system on one device."""

    def __init__(self, hcore, eris, symm, n_orb: int, n_elec: int):
        self.dev = hcore.device
        self.n, self.n_elec = int(n_orb), int(n_elec)
        self.n_bits = 2 * self.n
        self.half = self.n_elec // 2
        self.n_virt = self.n - self.half
        self.h = hcore.to(REAL)
        self.g = eris.to(REAL)
        self.symm = symm.to(self.dev, torch.int64)
        self.n_cols = -(-self.n_bits // COL_BITS)
        # the orbitals of each irrep, ascending, padded with n
        rows = [torch.nonzero(self.symm == k)[:, 0] for k in range(8)]
        self.irrep_width = max(1, max(len(r) for r in rows))
        self.irrep_rows = torch.full((8, self.irrep_width), self.n, dtype=torch.int64,
                                     device=self.dev)
        for k, r in enumerate(rows):
            self.irrep_rows[k, :len(r)] = r
        self._heat_bath_tables()
        self.hf_bits = torch.zeros(self.n_bits, dtype=torch.bool, device=self.dev)
        self.hf_bits[:self.half] = True
        self.hf_bits[self.n:self.n + self.half] = True
        self.hf_cols = self.cols(self.hf_bits[None])[0]
        self.e_hf = float(self.diag(self.occ(self.hf_bits[None]))[0])

    # ---- determinants ----------------------------------------------------

    def cols(self, bits):
        """(N, n_bits) bits -> (N, n_cols) int64 columns, most significant first."""
        out = []
        for j in reversed(range(self.n_cols)):
            part = bits[:, j * COL_BITS:(j + 1) * COL_BITS].to(torch.int64)
            shifts = torch.arange(part.shape[1], device=self.dev, dtype=torch.int64)
            out.append((part << shifts).sum(1))
        return torch.stack(out, 1)

    def bits(self, cols):
        """The inverse of :meth:`cols`."""
        b = torch.arange(self.n_bits, device=self.dev)
        col = cols[:, self.n_cols - 1 - b // COL_BITS]
        return ((col >> (b % COL_BITS)) & 1).to(torch.bool)

    def from_words(self, words):
        """(columns, valid) of the program's stored keys: rows of 32-bit words
        held in int64, bit b at ``words[b // 32] >> (b % 32)``; a row whose
        last word is all ones is empty."""
        words = words.to(self.dev)
        valid = words[:, -1] != 0xFFFFFFFF
        b = torch.arange(self.n_bits, device=self.dev)
        bits = ((words[valid][:, b // 32] >> (b % 32)) & 1).to(torch.bool)
        return self.cols(bits), valid

    def read(self, snap):
        """(columns, values, shift, last norm) of a program's state snapshot
        (:func:`benchmark.check.snapshot`), value row 0."""
        cols, valid = self.from_words(snap["keys"])
        return (cols, snap["vals"][0].to(self.dev, REAL)[valid],
                snap["en_shift"].to(self.dev, REAL), snap["last_norm"].to(self.dev, REAL))

    def n_bad(self, cols):
        """Rows that are not determinants of the system: a number of alpha or
        beta electrons other than half of ``n_elec``."""
        b = self.bits(cols)
        return int(((b[:, :self.n].sum(1) != self.half)
                    | (b[:, self.n:].sum(1) != self.half)).sum())

    def occ(self, bits):
        """(N, E) occupied spin orbitals of each row, ascending."""
        return torch.nonzero(bits)[:, 1].view(bits.shape[0], self.n_elec)

    # ---- Slater-Condon ---------------------------------------------------

    def _g(self, p, q, r, s):
        n = self.n
        return self.g[p % n, q % n, r % n, s % n]

    def diag(self, occ):
        """<D|H|D> = sum_i h_ii + sum_{i<j} (<ij|ij> - [same spin] <ij|ji>)."""
        n = self.n
        e = self.h[occ % n, occ % n].sum(1)
        for i in range(self.n_elec):
            for j in range(i + 1, self.n_elec):
                a, b = occ[:, i], occ[:, j]
                same = (a // n) == (b // n)
                e = e + self._g(a, b, a, b) - torch.where(same, self._g(a, b, b, a), 0.0)
        return e

    @staticmethod
    def _passed(occ, a, b):
        """Occupied orbitals of ``occ`` strictly between a and b."""
        lo, hi = torch.minimum(a, b)[:, None], torch.maximum(a, b)[:, None]
        return ((occ > lo) & (occ < hi)).sum(1)

    def single(self, occ, o, u):
        """<D'|H|D> for D' = D with o -> u (same spin)."""
        n = self.n
        sign = 1 - 2 * (self._passed(occ, o, u) % 2)
        el = self.h[o % n, u % n]
        for j in range(self.n_elec):
            q = occ[:, j]
            term = self._g(o, q, u, q) - torch.where(q // n == o // n, self._g(o, q, q, u), 0.0)
            el = el + torch.where(q == o, 0.0, term)
        return sign * el

    def double(self, occ, o1, o2, u1, u2):
        """<D'|H|D> for D' = D with o1 -> u1 and o2 -> u2 (spin kept)."""
        n = self.n
        s1 = self._passed(occ, o1, u1)
        # o1 -> u1 done: o1 is empty and u1 full when o2 moves
        s2 = (self._passed(occ, o2, u2) - self._between(o1, o2, u2)
              + self._between(u1, o2, u2))
        sign = 1 - 2 * ((s1 + s2) % 2)
        direct = torch.where((o1 // n == u1 // n) & (o2 // n == u2 // n),
                             self._g(o1, o2, u1, u2), 0.0)
        exch = torch.where((o1 // n == u2 // n) & (o2 // n == u1 // n),
                           self._g(o1, o2, u2, u1), 0.0)
        return sign * (direct - exch)

    @staticmethod
    def _between(x, a, b):
        return ((x > torch.minimum(a, b)) & (x < torch.maximum(a, b))).to(torch.int64)

    # ---- excitations of one determinant (host loops) ---------------------

    def excitations(self, bits):
        """Every symmetry-allowed single and double of one determinant:
        (targets' bits (M, n_bits), <D'|H|D> (M,), number of doubles, of singles)."""
        occ = [int(p) for p in torch.nonzero(bits)[:, 0]]
        n, symm = self.n, self.symm.tolist()
        empty = [p for p in range(self.n_bits) if not bool(bits[p])]
        sing, doub = [], []
        for o in occ:
            for u in empty:
                if o // n == u // n and symm[o % n] == symm[u % n]:
                    sing.append((o, u))
        for i, o1 in enumerate(occ):
            for o2 in occ[i + 1:]:
                for k, u1 in enumerate(empty):
                    for u2 in empty[k + 1:]:
                        if sorted((o1 // n, o2 // n)) != sorted((u1 // n, u2 // n)):
                            continue
                        if symm[o1 % n] ^ symm[o2 % n] ^ symm[u1 % n] ^ symm[u2 % n]:
                            continue
                        doub.append((o1, o2, u1, u2))
        occ_t = torch.as_tensor(occ, device=self.dev)[None]
        t = lambda xs, i: torch.as_tensor([x[i] for x in xs], dtype=torch.int64,
                                          device=self.dev)
        el_d = torch.zeros(0, dtype=REAL, device=self.dev)
        if doub:
            o1, o2, u1, u2 = (t(doub, i) for i in range(4))
            # opposite spins: the electron of each spin goes to the orbital of its spin
            swap = (o1 // n) != (u1 // n)
            u1, u2 = torch.where(swap, u2, u1), torch.where(swap, u1, u2)
            el_d = self.double(occ_t.expand(len(doub), -1), o1, o2, u1, u2)
        el_s = torch.zeros(0, dtype=REAL, device=self.dev)
        if sing:
            el_s = self.single(occ_t.expand(len(sing), -1), t(sing, 0), t(sing, 1))
        base = bits.cpu().numpy()
        targets = np.repeat(base[None], len(doub) + len(sing), 0)
        for k, (gone, come) in enumerate([(d[:2], d[2:]) for d in doub]
                                         + [((s[0],), (s[1],)) for s in sing]):
            targets[k, list(gone)] = False
            targets[k, list(come)] = True
        stacked = torch.as_tensor(targets, device=self.dev)
        return stacked, torch.cat([el_d, el_s]), len(doub), len(sing)

    def hf_trial(self):
        """(H - E_HF)|HF> over HF's excitations: (columns, values); HF itself
        is 0 there."""
        tb, el, _, _ = self.excitations(self.hf_bits)
        keep = el != 0
        return self.cols(tb[keep]), el[keep]

    def p_doub(self) -> float:
        """The share of doubles among HF's symmetry-allowed excitations."""
        _, _, nd, ns = self.excitations(self.hf_bits)
        return nd / (nd + ns)

    # ---- heat-bath Power-Pitzer ------------------------------------------

    def _heat_bath_tables(self):
        """d_diff[i, j] = sum_{a != i, b != j} |<ij|ab>|;
        d_same[i, j] = 2 sum_{a > b; a, b not in {i, j}} |<ij|ab> - <ij|ba>| (0 at i = j);
        s_tens[i] = sum_j d_same[i, j] + d_diff[i, j];
        exch[i, j] = sqrt(|<ij|ji>|)."""
        g = self.g.cpu().numpy()
        n = self.n
        d_diff = np.zeros((n, n))
        d_same = np.zeros((n, n))
        exch = np.zeros((n, n))
        below = np.tril(np.ones((n, n), dtype=bool), -1)    # a > b
        for i in range(n):
            for j in range(n):
                block = g[i, j]
                mask = np.ones((n, n), dtype=bool)
                mask[i, :] = False
                mask[:, j] = False
                d_diff[i, j] = np.abs(block)[mask].sum()
                if i != j:
                    keep = below.copy()
                    keep[[i, j], :] = False
                    keep[:, [i, j]] = False
                    d_same[i, j] = 2 * np.abs(block - block.T)[keep].sum()
                exch[i, j] = np.sqrt(abs(g[i, j, j, i]))
        as_t = lambda x: torch.as_tensor(x, dtype=REAL, device=self.dev)
        self.d_diff, self.d_same, self.exch = as_t(d_diff), as_t(d_same), as_t(exch)
        self.s_tens = self.d_same.sum(1) + self.d_diff.sum(1)

    @staticmethod
    def _norm(w):
        return w / w.sum(-1, keepdim=True).clamp_min(1e-300)

    def p_first(self, occ):
        """(N, E): P(first electron = slot e) = s_tens[e] / sum."""
        return self._norm(self.s_tens[occ % self.n])

    def _pair(self, a, b):
        """The table of the pair (a, b): d_same for one spin, d_diff for two."""
        n = self.n
        return torch.where(a // n == b // n, self.d_same[a % n, b % n],
                           self.d_diff[a % n, b % n])

    def p_second(self, occ, first_slot):
        """(N, E): P(second electron = slot e | the first)."""
        a = occ.gather(1, first_slot[:, None])
        w = self._pair(a.expand_as(occ), occ)
        slots = torch.arange(self.n_elec, device=self.dev)
        return self._norm(torch.where(slots[None] == first_slot[:, None], 0.0, w))

    def virtuals(self, bits, spin):
        """(N, n_virt): the empty spatial orbitals of ``spin``, ascending."""
        n = self.n
        spin_bits = torch.where((spin == 0)[:, None], bits[:, :n], bits[:, n:])
        return torch.nonzero(~spin_bits)[:, 1].view(bits.shape[0], self.n_virt)

    def p_first_virtual(self, bits, a):
        """(N, n_virt) P(first empty orbital = slot v | first electron a), and
        the slots' spatial orbitals."""
        virts = self.virtuals(bits, a // self.n)
        return self._norm(self.exch[(a % self.n)[:, None], virts]), virts

    def second_row(self, a, b, x):
        """(N, K) spatial orbitals of the irrep irrep(a)^irrep(b)^irrep(x),
        ascending and padded with n."""
        n = self.n
        return self.irrep_rows[self.symm[a % n] ^ self.symm[b % n] ^ self.symm[x % n]]

    def p_second_virtual(self, a, b, x):
        """(N, K) P(second orbital = column c | a, b, x) over :meth:`second_row`,
        occupied ones included; x itself excluded where a and b share a spin."""
        n = self.n
        row = self.second_row(a, b, x)
        w = torch.where(row < n, self.exch[(b % n)[:, None], row.clamp_max(n - 1)], 0.0)
        w = torch.where(((a // n == b // n)[:, None]) & (row == (x % n)[:, None]), 0.0, w)
        return self._norm(w), row

    def pick_prob(self, bits, occ, o1, o2, u1, u2):
        """The HB-PP probability of picking the double (o1, o2) -> (u1, u2):
        the sum over the orders of the electrons, and over the orbitals the
        first can take, of P(first) P(second | first) P(first orbital | first)
        P(second orbital | first, second, first orbital)."""
        n = self.n
        e_of = lambda o: (occ == o[:, None]).to(torch.int64).argmax(1)
        p1 = self.p_first(occ)
        total = torch.zeros(o1.shape[0], dtype=REAL, device=self.dev)
        for a, b in ((o1, o2), (o2, o1)):
            ea, eb = e_of(a), e_of(b)
            pa = p1.gather(1, ea[:, None])[:, 0]
            pb = self.p_second(occ, ea).gather(1, eb[:, None])[:, 0]
            pv, virts = self.p_first_virtual(bits, a)
            for x, y in ((u1, u2), (u2, u1)):
                ok = (x // n == a // n) & (y // n == b // n)
                px = torch.where(virts == (x % n)[:, None], pv, 0.0).sum(1)
                pw, row = self.p_second_virtual(a, b, x)
                py = torch.where(row == (y % n)[:, None], pw, 0.0).sum(1)
                total = total + torch.where(ok, pa * pb * px * py, 0.0)
        return total

    def single_counts(self, bits, occ):
        """(N, E) the empty orbitals of each electron's spin and irrep."""
        n = self.n
        same_irrep = self.symm[occ % n][:, :, None] == self.symm[None, None, :]
        spin = occ // n
        empty = torch.where((spin == 0)[:, :, None], ~bits[:, None, :n], ~bits[:, None, n:])
        return (same_irrep & empty).sum(2)
