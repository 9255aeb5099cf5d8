"""Reed-Solomon codec over GF(2^8), batch-vectorized (a copy of
``sondetpu/fec/rs.py``, NumPy only).

RS41's RS(255,231) FEC (SURVEY.md S1, BASELINE.json:7) re-implemented from
the textbook algorithms: systematic LFSR encoding, syndrome computation,
Berlekamp-Massey with fixed 2t iterations (per-batch conditionals as
``np.where`` masks — the shape a TPU port needs), Chien search evaluated at
every position (dense, no ragged gathers), and Forney error magnitudes
applied through a root-indicator mask.

Field polynomial 0x11D, generator roots alpha^fcr .. alpha^(fcr+2t-1) with
fcr=0 — the parameters publicly documented for the RS41 (and the CCSDS
conventional-representation RS(255,223) sibling). Constants must be
re-verified against recorded IQ when available (SURVEY.md §7 "protocol
ground truth").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from benchmark.frozen.fec.gf256 import GF256


class ReedSolomon:
    def __init__(self, nroots: int, fcr: int = 0, prim_poly: int = 0x11D):
        self.gf = GF256(prim_poly)
        self.nroots = nroots          # parity symbols = 2t
        self.t = nroots // 2
        self.fcr = fcr
        # generator polynomial g(x) = prod (x - alpha^(fcr+i)), lowest first
        g = np.zeros(nroots + 1, dtype=np.int32)
        g[0] = 1
        deg = 0
        for i in range(nroots):
            root = self.gf.exp[(fcr + i) % 255]
            # g = g * (x + root)
            ng = np.zeros_like(g)
            ng[1:deg + 2] = g[:deg + 1]
            ng[:deg + 1] ^= self.gf.mul(g[:deg + 1], root)
            g = ng
            deg += 1
        self.genpoly = g              # [nroots+1], lowest-degree first

    # -- encoding -----------------------------------------------------------

    def encode(self, msg: np.ndarray) -> np.ndarray:
        """Systematic encode: msg [batch, k] -> codeword [batch, k+nroots].

        Parity is the remainder of msg(x) * x^nroots mod g(x); codeword is
        [msg | parity] with msg[0] the highest-degree coefficient.
        """
        msg = np.atleast_2d(np.asarray(msg, dtype=np.int32))
        batch, k = msg.shape
        gf = self.gf
        # LFSR division, vectorized over batch
        reg = np.zeros((batch, self.nroots), dtype=np.int32)
        ghi = self.genpoly[:-1][::-1].copy()  # coeffs below x^nroots, highest first
        for i in range(k):
            fb = msg[:, i] ^ reg[:, 0]
            reg = np.roll(reg, -1, axis=1)
            reg[:, -1] = 0
            reg ^= gf.mul(fb[:, None], ghi[None, :])
        return np.concatenate([msg, reg], axis=1).astype(np.uint8)

    # -- decoding -----------------------------------------------------------

    def decode(self, recv: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Correct a batch of (possibly shortened) codewords.

        recv: [batch, n] uint8 with n <= 255; returns (corrected [batch, n],
        n_errors [batch], ok [batch] bool). ``ok`` is False when the error
        pattern is uncorrectable (> t errors detected).
        """
        recv = np.atleast_2d(np.asarray(recv, dtype=np.int32))
        batch, n = recv.shape
        # ALL syndromes, once, for the whole batch: clean frames skip the
        # BM/Chien/Forney machinery entirely (the bulk of the cost), and
        # suspects reuse these syndromes instead of recomputing them — and
        # the full set keeps the ok verdict identical to the native path.
        S = self._syndromes(recv)
        maybe_err = S.any(axis=1)
        if not maybe_err.any():
            return (recv.astype(np.uint8), np.zeros(batch, np.int64),
                    np.ones(batch, bool))
        if maybe_err.all():
            return self._correct(recv, S)
        corr_d, nerr_d, ok_d = self._correct(recv[maybe_err], S[maybe_err])
        corrected = recv.astype(np.uint8).copy()
        corrected[maybe_err] = corr_d
        nerr = np.zeros(batch, np.int64)
        nerr[maybe_err] = nerr_d
        ok = np.ones(batch, bool)
        ok[maybe_err] = ok_d
        return corrected, nerr, ok

    def _syndromes(self, recv: np.ndarray) -> np.ndarray:
        """S_i = r(alpha^(fcr+i)) for a [batch, n] int32 batch."""
        gf = self.gf
        nr = self.nroots
        batch, n = recv.shape
        pad = 255 - n
        cw = np.zeros((batch, 255), dtype=np.int32)
        cw[:, pad:] = recv
        deg = np.arange(254, -1, -1)    # r[j] has degree 254-j
        expo = (deg[None, :] * (np.arange(nr)[:, None] + self.fcr)) % 255
        nz = cw != 0
        logs = gf.log[cw]
        S = np.zeros((batch, nr), dtype=np.int32)
        for i in range(nr):
            term = np.where(nz, gf.exp[(logs + expo[i][None, :]) % 255], 0)
            S[:, i] = np.bitwise_xor.reduce(term, axis=1)
        return S

    def _correct(self, recv: np.ndarray, S: np.ndarray):
        """BM/Chien/Forney over rows whose syndromes are already known
        (every row here has at least one nonzero syndrome)."""
        gf = self.gf
        nr = self.nroots
        batch, n = recv.shape
        pad = 255 - n
        cw = np.zeros((batch, 255), dtype=np.int32)
        cw[:, pad:] = recv
        no_err = ~S.any(axis=1)

        # Berlekamp-Massey, fixed 2t iterations, batch-conditional
        C = np.zeros((batch, nr + 1), dtype=np.int32); C[:, 0] = 1
        B = np.zeros((batch, nr + 1), dtype=np.int32); B[:, 0] = 1
        L = np.zeros(batch, dtype=np.int32)
        m = np.ones(batch, dtype=np.int32)
        bb = np.ones(batch, dtype=np.int32)
        for i in range(nr):
            # discrepancy d = S[i] + sum_{j=1..deg} C[j] S[i-j]
            d = S[:, i].copy()
            for j in range(1, nr + 1):
                if i - j < 0:
                    break
                d ^= gf.mul(C[:, j], S[:, i - j])
            coef = gf.div(d, bb)                                     # [batch]
            # x^m * B  (per-batch shift by m)
            idx = np.arange(nr + 1)[None, :] - m[:, None]
            Bs = np.where(idx >= 0,
                          np.take_along_axis(B, np.clip(idx, 0, nr), axis=1), 0)
            Cnew = C ^ gf.mul(coef[:, None], Bs)
            upd = d != 0
            grow = upd & (2 * L <= i)
            B = np.where(grow[:, None], C, B)
            bb = np.where(grow, d, bb)
            Lnew = np.where(grow, i + 1 - L, L)
            m = np.where(grow, 1, m + 1)
            C = np.where(upd[:, None], Cnew, C)
            L = Lnew

        # Chien search: lambda(alpha^{-p}) for every degree p (0..254)
        p = np.arange(255)
        # eval at x_p = alpha^{-p}: lam(x) = sum_i C[i] x^i
        lam_nz = C != 0
        lam_logs = gf.log[C]
        evals = np.zeros((batch, 255), dtype=np.int32)
        for i in range(nr + 1):
            e = (lam_logs[:, i][:, None] + (-i * p) % 255) % 255
            term = np.where(lam_nz[:, i][:, None], gf.exp[e], 0)
            evals ^= term
        is_root = evals == 0                                         # [batch, 255]
        # shortened code: only degrees 0..n-1 exist in the received window
        in_window = p < (255 - pad)
        is_root = is_root & in_window[None, :]
        nroots_found = is_root.sum(axis=1)

        # Forney: Omega = S * C mod x^nr ; e_p = X Omega(Xinv) / lam'(Xinv)
        Omega = np.zeros((batch, nr), dtype=np.int32)
        for i in range(nr):
            acc = np.zeros(batch, dtype=np.int32)
            for j in range(i + 1):
                acc ^= gf.mul(S[:, j], C[:, i - j])
            Omega[:, i] = acc
        # evaluate Omega and lambda' at Xinv = alpha^{-p} densely
        om_nz = Omega != 0
        om_logs = gf.log[Omega]
        om_eval = np.zeros((batch, 255), dtype=np.int32)
        for i in range(nr):
            e = (om_logs[:, i][:, None] + (-i * p) % 255) % 255
            om_eval ^= np.where(om_nz[:, i][:, None], gf.exp[e], 0)
        dlam_eval = np.zeros((batch, 255), dtype=np.int32)
        for i in range(1, nr + 1, 2):       # odd powers only (GF(2) derivative)
            e = (lam_logs[:, i][:, None] + (-(i - 1) * p) % 255) % 255
            dlam_eval ^= np.where(lam_nz[:, i][:, None], gf.exp[e], 0)
        X = gf.exp[p % 255][None, :]        # alpha^{p}
        Xfcr = gf.exp[((1 - self.fcr) * p) % 255][None, :]
        mag = gf.mul(Xfcr, gf.div(om_eval, np.where(dlam_eval == 0, 1, dlam_eval)))
        errors = np.where(is_root & (dlam_eval != 0), mag, 0)

        # apply corrections: position with degree p is array index 254-p
        corr = cw.copy()
        corr[:, ::-1] ^= errors             # errors indexed by degree p -> index 254-p
        corrected = corr[:, pad:].astype(np.uint8)

        ok = no_err | ((nroots_found == L) & (L <= self.t) & (L > 0))
        n_errors = np.where(no_err, 0, nroots_found)
        # where not ok, return input unchanged
        corrected = np.where(ok[:, None], corrected, recv.astype(np.uint8))
        return corrected, n_errors, ok


RS255_231 = ReedSolomon(nroots=24, fcr=0)
