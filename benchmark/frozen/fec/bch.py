"""Binary BCH encoder over GF(2^m) (a copy of the encoding half of
``sondetpu_torch/fec/bch.py``, NumPy only), frozen for the benchmark.

Narrow-sense binary BCH: the generator is the LCM of the minimal
polynomials of alpha^1..alpha^2t, and the encoder is systematic. The
Meisei iMS-100 / RS-11G frames use BCH(63,51) t=2 over GF(2^6) with
x^6 + x + 1, shortened to (46,34) by an implicit zero prefix of 17 message
bits. The decoders are left out: the benchmark only makes frames, and the
program's own host decode reads them.
"""

from __future__ import annotations

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


class BCH:
    """Binary BCH(n, k) with n = 2^m - 1 and design distance 2t+1."""

    def __init__(self, m: int, t: int, prim_poly: int):
        self.gf = _GF2m(m, prim_poly)
        self.n = self.gf.n
        self.t = t
        # generator polynomial: LCM of minimal polys of alpha^1..alpha^{2t}
        g = [1]
        covered = set()
        for i in range(1, 2 * t + 1):
            if i in covered:
                continue
            cls = set()
            j = i
            while j not in cls:
                cls.add(j)
                j = (j * 2) % self.n
            covered |= cls
            mp = [1]
            for j in cls:
                root = int(self.gf.exp[j])
                nmp = [0] * (len(mp) + 1)
                for d, c in enumerate(mp):
                    nmp[d + 1] ^= c
                    nmp[d] ^= int(self.gf.mul(c, root))
                mp = nmp
            ng = [0] * (len(g) + len(mp) - 1)
            for a, ca in enumerate(g):
                for b, cb in enumerate(mp):
                    ng[a + b] ^= int(self.gf.mul(ca, cb))
            g = ng
        assert all(c in (0, 1) for c in g), "generator must be binary"
        self.genpoly = np.array(g, dtype=np.uint8)   # lowest-degree first
        self.k = self.n - (len(g) - 1)

    def encode(self, msg_bits: np.ndarray) -> np.ndarray:
        """Systematic encode: msg_bits [batch, k] -> codeword [batch, n],
        laid out [msg | parity], msg[0] the highest-degree coefficient."""
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


# Meisei iMS-100 / RS-11G: BCH(63,51), t=2, GF(2^6) with x^6 + x + 1
BCH_63_51 = BCH(m=6, t=2, prim_poly=0x43)
SHORT = 17                    # zero bits removed from each (63,51) codeword


def bch_46_34_encode(msg_bits: np.ndarray) -> np.ndarray:
    """[batch, 34] data bits -> [batch, 46] shortened codewords."""
    msg = np.atleast_2d(np.asarray(msg_bits, np.uint8))
    full = np.zeros((msg.shape[0], 51), np.uint8)
    full[:, SHORT:] = msg                  # implicit zero prefix
    return BCH_63_51.encode(full)[:, SHORT:]
