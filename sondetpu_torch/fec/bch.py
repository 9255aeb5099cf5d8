"""Binary BCH codec (Meisei iMS-100 / RS-11G FEC, SURVEY.md S4; a copy of
``sondetpu/fec/bch.py`` that reaches the port's native FEC).

Generic narrow-sense binary BCH over GF(2^m): generator from the LCM of
minimal polynomials of alpha^1..alpha^2t, syndrome + Berlekamp-Massey +
Chien decode, batch-vectorized over codewords like the RS codec
(BASELINE.json:10 "Meisei iMS-100 + RS-11G (BCH FEC)"). The Meisei frames
use BCH(63,51) t=2 [inferred from public decoder implementations; verify
against recorded IQ, SURVEY.md §7].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class _GF2m:
    def __init__(self, m: int, prim_poly: int):
        self.m = m
        self.n = (1 << m) - 1
        exp = np.zeros(2 * self.n, dtype=np.int32)
        log = np.zeros(self.n + 1, dtype=np.int32)
        x = 1
        for i in range(self.n):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & (1 << m):
                x ^= prim_poly
        exp[self.n:2 * self.n] = exp[:self.n]
        self.exp, self.log = exp, log

    def mul(self, a, b):
        a = np.asarray(a, dtype=np.int32)
        b = np.asarray(b, dtype=np.int32)
        out = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), 0, out)

    def div(self, a, b):
        a = np.asarray(a, dtype=np.int32)
        b = np.asarray(b, dtype=np.int32)
        out = self.exp[(self.log[a] - self.log[b]) % self.n]
        return np.where(a == 0, 0, out)


class BCH:
    """Binary BCH(n, k) with n = 2^m - 1 and design distance 2t+1."""

    def __init__(self, m: int, t: int, prim_poly: int):
        self.prim_poly = prim_poly
        self.gf = _GF2m(m, prim_poly)
        self.n = self.gf.n
        self.t = t
        # generator polynomial: LCM of minimal polys of alpha^1..alpha^{2t}
        g = [1]
        covered = set()
        for i in range(1, 2 * t + 1):
            if i in covered:
                continue
            # conjugacy class of alpha^i
            cls = set()
            j = i
            while j not in cls:
                cls.add(j)
                j = (j * 2) % self.n
            covered |= cls
            # minimal polynomial: prod (x - alpha^j) over the class
            mp = [1]
            for j in cls:
                root = int(self.gf.exp[j])
                nmp = [0] * (len(mp) + 1)
                for d, c in enumerate(mp):
                    nmp[d + 1] ^= c
                    nmp[d] ^= int(self.gf.mul(c, root))
                mp = nmp
            # multiply g by mp (coeffs in GF(2^m) but result binary)
            ng = [0] * (len(g) + len(mp) - 1)
            for a, ca in enumerate(g):
                for b, cb in enumerate(mp):
                    ng[a + b] ^= int(self.gf.mul(ca, cb))
            g = ng
        assert all(c in (0, 1) for c in g), "generator must be binary"
        self.genpoly = np.array(g, dtype=np.uint8)   # lowest-degree first
        self.k = self.n - (len(g) - 1)

    def encode(self, msg_bits: np.ndarray) -> np.ndarray:
        """Systematic encode: msg_bits [batch, k] -> codeword [batch, n].

        Codeword layout [msg | parity], msg[0] = highest-degree coefficient.
        """
        msg = np.atleast_2d(np.asarray(msg_bits, dtype=np.uint8))
        batch, k = msg.shape
        assert k == self.k, (k, self.k)
        r = self.n - k
        reg = np.zeros((batch, r), dtype=np.uint8)
        glo = self.genpoly[:-1][::-1]        # below x^r, highest first
        for i in range(k):
            fb = msg[:, i] ^ reg[:, 0]
            reg = np.roll(reg, -1, axis=1)
            reg[:, -1] = 0
            reg ^= fb[:, None] * glo[None, :]
        return np.concatenate([msg, reg], axis=1)

    def decode(self, recv_bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Correct up to t bit errors. recv [batch, n] -> (corrected, nerr, ok)."""
        recv = np.atleast_2d(np.asarray(recv_bits, dtype=np.uint8))
        batch, n = recv.shape
        assert n == self.n
        if n == 63 and self.t == 2 and self.prim_poly == 0x43:
            from sondetpu_torch.fec import native
            if native.available():
                return native.bch63_decode(recv)
        gf = self.gf
        t2 = 2 * self.t

        # Syndromes S_i = r(alpha^i), i = 1..2t; bit j has degree n-1-j
        deg = np.arange(n - 1, -1, -1)
        S = np.zeros((batch, t2), dtype=np.int32)
        for i in range(1, t2 + 1):
            term = np.where(recv != 0, gf.exp[(deg * i) % gf.n][None, :], 0)
            S[:, i - 1] = np.bitwise_xor.reduce(term, axis=1)
        no_err = ~S.any(axis=1)

        # Berlekamp-Massey (same fixed-iteration batch form as fec/rs.py)
        C = np.zeros((batch, t2 + 1), dtype=np.int32); C[:, 0] = 1
        B = np.zeros((batch, t2 + 1), dtype=np.int32); B[:, 0] = 1
        L = np.zeros(batch, dtype=np.int32)
        m_ = np.ones(batch, dtype=np.int32)
        bb = np.ones(batch, dtype=np.int32)
        for i in range(t2):
            d = S[:, i].copy()
            for j in range(1, i + 1):
                d ^= gf.mul(C[:, j], S[:, i - j])
            coef = gf.div(d, bb)
            idx = np.arange(t2 + 1)[None, :] - m_[:, None]
            Bs = np.where(idx >= 0, np.take_along_axis(B, np.clip(idx, 0, t2), axis=1), 0)
            Cnew = C ^ gf.mul(coef[:, None], Bs)
            upd = d != 0
            grow = upd & (2 * L <= i)
            B = np.where(grow[:, None], C, B)
            bb = np.where(grow, d, bb)
            L = np.where(grow, i + 1 - L, L)
            m_ = np.where(upd & grow, 1, m_ + 1)
            C = np.where(upd[:, None], Cnew, C)

        # Chien search over all degrees p
        p = np.arange(n)
        evals = np.zeros((batch, n), dtype=np.int32)
        lam_nz = C != 0
        lam_logs = gf.log[C]
        for i in range(t2 + 1):
            e = (lam_logs[:, i][:, None] + (-i * p) % gf.n) % gf.n
            evals ^= np.where(lam_nz[:, i][:, None], gf.exp[e], 0)
        is_root = evals == 0
        nroots = is_root.sum(axis=1)

        flips = is_root.astype(np.uint8)
        corrected = recv ^ flips[:, ::-1]    # degree p -> array index n-1-p
        ok = no_err | ((nroots == L) & (L <= self.t) & (L > 0))
        corrected = np.where(ok[:, None], corrected, recv)
        nerr = np.where(no_err, 0, nroots)
        return corrected, nerr, ok


# Meisei iMS-100 / RS-11G: BCH(63,51), t=2, GF(2^6) with x^6 + x + 1
BCH_63_51 = BCH(m=6, t=2, prim_poly=0x43)
