"""The PFB channelizer's two stages: the time-major branch FIR and the DFT
across branches (counterpart: ``sondetpu/pallas/pfb.py``:
``pfb_fir_stream``, ``pfb_fir_timemajor`` and ``pfb_dft_perm``).

:func:`pfb_fir_stream` and :func:`pfb_fir_timemajor` launch the two entry
points of ``csrc/pfb.cu`` for CUDA tensors and run :func:`pfb_fir_plain`
for CPU tensors; they agree bit for bit (the same products and sums in the
same order, each rounded on its own). :func:`pfb_dft` launches
``csrc/pfb_dft.cu`` (a radix-2 FFT per time row, f32) for CUDA tensors and
runs :func:`pfb_dft_plain` (``torch.fft.fft``) for CPU tensors.

The DFT writes channel k at row k. The TPU kernel's ``dft_perm`` row order
is not reproduced: it existed so that the fleet's row gather absorbed it.

A bf16 channelizer runs both stages in bfloat16, as the original's Pallas
kernels with ``cdt = bfloat16`` do: the FIR rounds its float32 input and
taps to bfloat16 and each product and running sum to bfloat16 and writes
bfloat16 (kernel and twin agree bit for bit: the kernel's packed bfloat16
products and sums are each correctly rounded, subnormals kept); the DFT
reads bfloat16, transforms in float32 and rounds its output to bfloat16
once (at N = 2048 in a persistent body of 2-block clusters that moves its
input by bulk copies and stores 32 bytes a channel).
"""

from __future__ import annotations

import numpy as np
import torch

from sondetpu_torch.kernels import cuda

TPP = 8   # taps per phase the FIR kernel is built for


def pfb_fir_plain(vv_i: torch.Tensor, vv_q: torch.Tensor,
                  hcol: torch.Tensor, cdt: torch.dtype = torch.float32):
    """Plain torch twin of the branch FIR over pre-concatenated planes
    vv [tpp + m, N] -> (u_i, u_q) [m, N] (the slice-sum of
    ``dsp/channelizer.py:_impl``):
    ``u[r, j] = sum_t hcol[t, j] * vvs[r + tpp - 1 - t, j]``, where ``vvs``
    is ``vv`` with column 0 moved up one row, summed in ascending t from
    the product of tap 0, in the compute dtype ``cdt`` (float32, or
    bfloat16: input and taps rounded to it, every product and sum rounded
    to it)."""
    tpp = hcol.shape[0]
    m = vv_i.shape[0] - tpp
    rows = m + tpp - 1
    hcol = hcol.to(cdt)

    def fir(vv):
        vv = vv.to(cdt)
        vvs = torch.cat([vv[1:rows + 1, :1], vv[:rows, 1:]], dim=1)
        acc = None
        for t in range(tpp):
            o = tpp - 1 - t
            s = vvs[o:o + m, :] * hcol[t][None, :]
            acc = s if acc is None else acc + s
        return acc

    return fir(vv_i), fir(vv_q)


def _out_dtype(cdt) -> torch.dtype:
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype {cdt}: float32 or bfloat16")
    return cdt


def _check_fir(name, planes, hcol, dev):
    tpp, n = hcol.shape
    if tpp != TPP:
        raise ValueError(f"{name}: {tpp} taps per phase; the kernel takes "
                         f"{TPP}")
    for pname, t in planes:
        cuda.check_tensor(pname, t, torch.float32, dev, (None, n))
    cuda.check_tensor("hcol", hcol, torch.float32, dev, (TPP, n))


def pfb_fir_stream(x_i: torch.Tensor, x_q: torch.Tensor,
                   tail_i: torch.Tensor, tail_q: torch.Tensor,
                   hcol: torch.Tensor, cdt: torch.dtype = torch.float32):
    """Branch FIR of one block: raw float32 planes x [m, N] and the carried
    tail [tpp, N] (the previous block's last tpp rows) -> (u_i, u_q) [m, N]
    in ``cdt`` (float32 or bfloat16), branch-permuted time-major (column j
    holds branch (N - j) % N). Equal to :func:`pfb_fir_timemajor` over
    ``concat(tail, x)``; nothing is concatenated on the card. CPU tensors
    run the twin; CUDA tensors launch the kernel (body ``f32`` or
    ``bf16``)."""
    dev = x_i.device
    out = _out_dtype(cdt)
    if dev.type == "cpu":
        return pfb_fir_plain(torch.cat([tail_i, x_i]),
                             torch.cat([tail_q, x_q]), hcol, out)
    if dev.type != "cuda":
        raise ValueError(f"pfb_fir_stream: unsupported device {dev}")
    m, n = x_i.shape
    _check_fir("pfb_fir_stream", (("x_i", x_i), ("x_q", x_q),
                                  ("tail_i", tail_i), ("tail_q", tail_q)),
               hcol, dev)
    if x_q.shape[0] != m or tail_i.shape[0] != TPP or tail_q.shape[0] != TPP:
        raise ValueError("pfb_fir_stream: plane or tail rows differ")
    bf16 = out == torch.bfloat16
    u_i = torch.empty((m, n), dtype=out, device=dev)
    u_q = torch.empty((m, n), dtype=out, device=dev)
    cuda.launch("pfb_fir_stream", "sondetpu_pfb_fir_stream",
                x_i.data_ptr(), x_q.data_ptr(), tail_i.data_ptr(),
                tail_q.data_ptr(), hcol.data_ptr(), TPP, m, n, int(bf16),
                u_i.data_ptr(), u_q.data_ptr(), cuda.stream_handle(dev),
                body="bf16" if bf16 else "f32")
    return u_i, u_q


def pfb_fir_timemajor(vv_i: torch.Tensor, vv_q: torch.Tensor,
                      hcol: torch.Tensor, cdt: torch.dtype = torch.float32):
    """Branch FIR over pre-concatenated float32 planes vv [tpp + m, N] ->
    (u_i, u_q) [m, N] in ``cdt``: the channelizer's path for blocks shorter
    than its history. CPU tensors run the twin; CUDA tensors launch the
    kernel (body ``f32`` or ``bf16``)."""
    dev = vv_i.device
    out = _out_dtype(cdt)
    if dev.type == "cpu":
        return pfb_fir_plain(vv_i, vv_q, hcol, out)
    if dev.type != "cuda":
        raise ValueError(f"pfb_fir_timemajor: unsupported device {dev}")
    rows, n = vv_i.shape
    _check_fir("pfb_fir_timemajor", (("vv_i", vv_i), ("vv_q", vv_q)), hcol,
               dev)
    m = rows - TPP
    if m < 1 or vv_q.shape[0] != rows:
        raise ValueError(f"pfb_fir_timemajor: {rows} rows for {TPP} taps per "
                         "phase")
    bf16 = out == torch.bfloat16
    u_i = torch.empty((m, n), dtype=out, device=dev)
    u_q = torch.empty((m, n), dtype=out, device=dev)
    cuda.launch("pfb_fir_timemajor", "sondetpu_pfb_fir_timemajor",
                vv_i.data_ptr(), vv_q.data_ptr(), hcol.data_ptr(), TPP, m, n,
                int(bf16), u_i.data_ptr(), u_q.data_ptr(),
                cuda.stream_handle(dev), body="bf16" if bf16 else "f32")
    return u_i, u_q


def twiddle_table(n: int):
    """cos, sin(2*pi*x/n) for x < n/2, taken in float64 and rounded once to
    float32 (NumPy arrays): the FFT kernel's twiddles."""
    ang = 2.0 * np.pi * np.arange(n // 2, dtype=np.float64) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def pfb_dft_plain(u_i: torch.Tensor, u_q: torch.Tensor):
    """Plain torch twin of :func:`pfb_dft`: ``torch.fft.fft`` of the
    complex rows (widened to float32), transposed to [N, m], in the input's
    dtype (bfloat16 output rounded once)."""
    dt = u_i.dtype
    y = torch.fft.fft(torch.complex(u_i.to(torch.float32),
                                    u_q.to(torch.float32)), dim=-1)
    return (y.real.t().contiguous().to(dt), y.imag.t().contiguous().to(dt))


def pfb_dft(u_i: torch.Tensor, u_q: torch.Tensor, twiddles=None):
    """Complex DFT across the N branches of every time row, sign -1,
    channel-major: (u_i, u_q) [m, N] -> (y_i, y_q) [N, m], float32 or
    bfloat16 in and out (computed in float32), with
    ``y[k, r] = sum_j u[r, j] * exp(-2*pi*i*j*k/N)``. ``twiddles`` is
    :func:`twiddle_table` for N as tensors on the card (made here when
    None). N must be a power of two from 8 to 4096. CPU tensors run the
    twin; CUDA tensors launch the kernel (a register-pass body at N = 2048,
    for bfloat16 the persistent clustered one, the radix-2 body otherwise;
    ``_bf16`` for bfloat16)."""
    dev = u_i.device
    if dev.type == "cpu":
        return pfb_dft_plain(u_i, u_q)
    if dev.type != "cuda":
        raise ValueError(f"pfb_dft: unsupported device {dev}")
    m, n = u_i.shape
    if n < 8 or n > 4096 or n & (n - 1):
        raise ValueError(f"pfb_dft: N={n}; the kernel covers powers of two "
                         "from 8 to 4096")
    dt = _out_dtype(u_i.dtype)
    bf16 = dt == torch.bfloat16
    cuda.check_tensor("u_i", u_i, dt, dev, (m, n))
    cuda.check_tensor("u_q", u_q, dt, dev, (m, n))
    if twiddles is None:
        twiddles = tuple(torch.from_numpy(t).to(dev) for t in twiddle_table(n))
    twc, tws = twiddles
    cuda.check_tensor("twiddle cos", twc, torch.float32, dev, (n // 2,))
    cuda.check_tensor("twiddle sin", tws, torch.float32, dev, (n // 2,))
    y_i = torch.empty((n, m), dtype=dt, device=dev)
    y_q = torch.empty((n, m), dtype=dt, device=dev)
    cuda.launch("pfb_dft", "sondetpu_pfb_dft", u_i.data_ptr(), u_q.data_ptr(),
                twc.data_ptr(), tws.data_ptr(), m, n, int(bf16),
                y_i.data_ptr(), y_q.data_ptr(), cuda.stream_handle(dev),
                body=("n2048" if n == 2048 else "radix2")
                + ("_bf16" if bf16 else ""))
    return y_i, y_q
