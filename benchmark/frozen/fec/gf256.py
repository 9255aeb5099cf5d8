"""GF(2^8) arithmetic via log/antilog tables, vectorized (a copy of
``sondetpu/fec/gf256.py``).

The arithmetic substrate for RS(255,231) (SURVEY.md S1: "RS decode =
GF(256) syndrome/Berlekamp-Massey ... int ops"). All operations broadcast
over NumPy arrays; the tables are plain int32 so the identical structure
lifts to jnp gathers on the VPU when FEC moves on-device.
"""

from __future__ import annotations

import numpy as np


class GF256:
    def __init__(self, prim_poly: int = 0x11D, generator: int = 2):
        self.prim_poly = prim_poly
        exp = np.zeros(512, dtype=np.int32)
        log = np.zeros(256, dtype=np.int32)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= prim_poly
        exp[255:510] = exp[:255]
        self.exp = exp
        self.log = log

    def mul(self, a, b):
        a = np.asarray(a, dtype=np.int32)
        b = np.asarray(b, dtype=np.int32)
        out = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), 0, out)

    def div(self, a, b):
        a = np.asarray(a, dtype=np.int32)
        b = np.asarray(b, dtype=np.int32)
        if np.any(b == 0):
            # log[0] is a table placeholder: a silent division by zero
            # would return a plausible-looking wrong field element
            raise ZeroDivisionError("GF(256) division by zero")
        out = self.exp[(self.log[a] - self.log[b]) % 255]
        return np.where(a == 0, 0, out)

    def inv(self, a):
        a = np.asarray(a, dtype=np.int32)
        return self.exp[(255 - self.log[a]) % 255]

    def pow(self, a, n):
        a = np.asarray(a, dtype=np.int32)
        n = np.asarray(n, dtype=np.int32)
        return np.where(a == 0, 0, self.exp[(self.log[a] * n) % 255])

    def poly_eval_batch(self, coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
        """Evaluate polynomials at points, Horner, batched.

        coeffs: [batch, deg+1] highest-degree first; x: [batch] or [batch, m].
        Returns [batch] (or [batch, m]).
        """
        coeffs = np.asarray(coeffs, dtype=np.int32)
        x = np.asarray(x, dtype=np.int32)
        expand = x.ndim == coeffs.ndim  # x [batch, m]
        acc = np.zeros(x.shape, dtype=np.int32)
        for j in range(coeffs.shape[-1]):
            c = coeffs[..., j][..., None] if expand else coeffs[..., j]
            acc = self.mul(acc, x) ^ c
        return acc


GF = GF256()
