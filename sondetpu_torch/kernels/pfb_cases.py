"""Edge-value planes for the bfloat16 branch FIR (``kernels/pfb.py``): the
inputs where a packed product or sum that rounded otherwise would part
from the twin. The CPU tests hold the twin to the JAX package on them,
and the card's tests and ``chip_smoke.py`` hold the kernel to the twin.

Each case gives two float32 planes of ``rows`` x ``n`` and, where the case
needs them, its own taps [8, n] (else None: the PFB's):

- ``ties``: exact bfloat16 values of few significant bits, so that products
  and running sums fall on exact halfway points between two bfloat16
  values (with taps k / 64), and float32 inputs halfway between two
  bfloat16 values: round to nearest even;
- ``subnormal``: bfloat16 subnormals (and float32 ones that round to them)
  beside the smallest normals: no flush to zero;
- ``near_max``: magnitudes near bfloat16's largest finite value, whose sums
  overflow to infinity (no input rounds past it; the taps stay below 1, so
  no product overflows and no NaN arises);
- ``signed_zero``: +0, -0 and the smallest subnormals, whose products
  round to zeros of either sign.
"""

import numpy as np

BF16_EDGE_CASES = ("ties", "subnormal", "near_max", "signed_zero")


def _bits(hi, lo):
    """float32 values from their upper and lower 16 bits."""
    return ((hi.astype(np.uint32) << 16) | lo.astype(np.uint32)).view(
        np.float32)


def bf16_edge_planes(case: str, rows: int, n: int, seed: int):
    """(x_i, x_q, hcol or None): float32 planes [rows, n] of ``case``."""
    rng = np.random.default_rng(seed)
    shape = (rows, n)

    def sign(size=shape):
        return rng.integers(0, 2, size=size).astype(np.uint32) << 15

    def plane():
        if case == "ties":
            exact = np.ldexp(rng.integers(-255, 256, size=shape),
                             rng.integers(-4, 5, size=shape))
            tie = _bits(sign() | rng.integers(0x3c00, 0x4100, size=shape),
                        np.full(shape, 0x8000))
            return np.where(rng.random(shape) < 0.5, exact,
                            tie).astype(np.float32)
        if case == "subnormal":
            sub = _bits(sign() | rng.integers(0, 0x80, size=shape),
                        rng.integers(0, 0x10000, size=shape))
            small = _bits(sign() | rng.integers(0x80, 0x180, size=shape),
                          rng.integers(0, 0x10000, size=shape))
            return np.where(rng.random(shape) < 0.7, sub, small)
        if case == "near_max":
            return _bits(sign() | rng.integers(0x7f00, 0x7f80, size=shape),
                         rng.integers(0, 0x8000, size=shape))
        if case == "signed_zero":
            zero = _bits(sign(), np.zeros(shape, np.uint32))
            tiny = _bits(sign() | rng.integers(1, 4, size=shape),
                         np.zeros(shape, np.uint32))
            return np.where(rng.random(shape) < 0.8, zero, tiny)
        raise ValueError(case)

    hcol = None
    if case == "ties":
        k = rng.integers(1, 64, size=(8, n)) * np.where(
            rng.random((8, n)) < 0.5, -1, 1)
        hcol = (k / 64.0).astype(np.float32)
    return plane(), plane(), hcol


def misaligned(t):
    """A contiguous copy of tensor t whose data starts 2 bytes past a
    16-byte boundary (for 2-byte elements): planes a kernel's bulk or
    vector copies cannot take."""
    buf = t.new_empty(t.numel() + 8)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out
