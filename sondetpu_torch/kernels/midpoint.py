"""Midpoint DC: the per-row midpoint ``0.5 * (q10 + q90)`` of the
midpoint-DC families' metric (counterpart: the original's ``0.5 *
(jnp.quantile(x, 0.10, axis=-1) + jnp.quantile(x, 0.90, axis=-1))``,
``sondetpu/runtime/pipeline.py:715-718, 881-889``; jnp ops, not a Pallas
kernel).

:func:`midpoint_dc` launches the CUDA kernel of ``csrc/midpoint.cu`` for
CUDA tensors, one launch a call, and runs :func:`midpoint_dc_plain` for
CPU tensors; the two agree bit for bit. Both devices refuse the same
arguments: anything but a [C, n] float32 or bfloat16 tensor with n >= 1
whose rows hold their elements side by side (the rows themselves may lie
at any stride: the K7 twin's metric is a view of wider rows).
"""

from __future__ import annotations

import numpy as np
import torch

from sondetpu_torch.kernels import cuda

DTYPES = (torch.float32, torch.bfloat16)


def quantile_ranks(n: int) -> tuple:
    """((lo, hi, w), ...) for q = 0.1 and 0.9 over a row of ``n``: as
    ``jnp.quantile`` computes it, the position q * (n - 1) in float32 (q
    rounded to float32 first) sets the 0-based order statistics at its
    floor and ceil and the float32 weight w of the upper one."""
    out = []
    for q in (np.float32(0.1), np.float32(0.9)):
        pos = np.float32(q * np.float32(n - 1))
        out.append((int(np.floor(pos)), int(np.ceil(pos)),
                    np.float32(pos - np.floor(pos))))
    return tuple(out)


def _fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """fl32(a * b + c) rounded once, for float32 ``a``, ``c`` and a float32
    value ``b``: the fused multiply-add that XLA on the CPU makes of
    ``jnp.quantile``'s ``lo * (1 - w) + hi * w``. In float64 the product is
    exact; the sum is taken with its rounding error (TwoSum) and rounded to
    odd, so that the final rounding to float32 is the single one."""
    f64 = torch.float64
    x = a.to(f64) * b
    y = c.to(f64)
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _check_args(x) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("midpoint_dc: x must be a [C, n] tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"midpoint_dc: dtype {x.dtype}, expected float32 or "
                        "bfloat16")
    if x.shape[1] < 1:
        raise ValueError("midpoint_dc: rows of no columns")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError("midpoint_dc: the elements of a row are not "
                         "contiguous")


def midpoint_dc_plain(x: torch.Tensor) -> torch.Tensor:
    """The eager twin of :func:`midpoint_dc` (same argument and result).

    Each quantile is ``lo * (1 - w) + hi * w`` in float32 at the ranks and
    weight of :func:`quantile_ranks`, the first product fused into the sum
    as XLA on the CPU fuses it, cast back to x's dtype; the midpoint is
    formed in x's dtype. A row holding a NaN gives NaN. The order
    statistics come from ``torch.kthvalue`` (exact, whatever the method of
    selection); ``torch.quantile`` refuses rows of more than 2**24
    elements in all and interpolates with lerp."""
    f32 = torch.float32
    stats = {}

    def order_stat(k):
        if k not in stats:
            stats[k] = torch.kthvalue(x, k + 1, dim=-1).values.to(f32)
        return stats[k]

    qs = []
    for lo, hi, w in quantile_ranks(x.shape[-1]):
        hw = order_stat(hi) * torch.tensor(w, dtype=f32, device=x.device)
        qs.append(_fma_f32(order_stat(lo), float(np.float32(1.0) - w),
                           hw).to(x.dtype))
    mid = (qs[0] + qs[1]) * 0.5
    return torch.where(torch.isnan(x).any(dim=-1),
                       torch.full_like(mid, float("nan")), mid)


def midpoint_dc(x: torch.Tensor) -> torch.Tensor:
    """Per-row midpoint ``0.5 * (q10 + q90)`` of ``x`` [C, n] in x's dtype:
    the original's ``0.5 * (jnp.quantile(x, 0.10, axis=-1) +
    jnp.quantile(x, 0.90, axis=-1))`` bit for bit (midpoint DC,
    ``sondetpu/runtime/pipeline.py:715-718, 881-889``).

    CPU tensors run the twin; CUDA tensors launch the kernel, one launch,
    which takes the ranks and weights by value, copies nothing from the
    host and allocates nothing but the [C] result."""
    _check_args(x)
    dev = x.device
    if dev.type == "cpu":
        return midpoint_dc_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"midpoint_dc: unsupported device {dev}")
    c, n = x.shape
    out = torch.empty(c, dtype=x.dtype, device=dev)
    if c == 0:
        return out
    (lo0, hi0, w0), (lo1, hi1, w1) = quantile_ranks(n)
    one = np.float32(1.0)
    cuda.launch("midpoint_dc", "sondetpu_midpoint_dc", x.data_ptr(), c, n,
                x.stride(0), int(x.dtype == torch.bfloat16), lo0, hi0, lo1,
                hi1, float(w0), float(one - w0), float(w1), float(one - w1),
                out.data_ptr(), cuda.stream_handle(dev))
    return out
