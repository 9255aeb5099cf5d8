"""Syncword correlator (counterpart: ``sondetpu/pallas/corr.py:corr_kernel``).

:func:`corr_kernel` launches the CUDA kernel of ``csrc/corr.cu`` for CUDA
tensors and runs :func:`corr_plain` for CPU tensors; the two agree bit for
bit (same order of operations, each rounded on its own). The kernel has a
body per template kind and length, which :func:`corr_body` names. A
bfloat16 chip ring (the bf16 compute dtype's) is widened to float32 before
either runs: exact, as the original's Pallas correlator promotes its
float32 template times a bfloat16 buffer to float32.
"""

from __future__ import annotations

import numpy as np
import torch

from sondetpu_torch.dsp.fir import conv1d
from sondetpu_torch.kernels import cuda

MAX_TAPS = 64                 # csrc/common.cuh SONDETPU_MAX_TAPS
FIXED_LENGTHS = (64, 32)      # template lengths csrc/corr.cu compiles in


def corr_plain(chipbuf: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """chipbuf [C, buf], template [L] -> corr [C, buf - L + 1]:
    ``(sum_k t[k] * buf[c, i + k]) * float32(1/L)``, as the Pallas
    correlator scales it (``sondetpu/pallas/corr.py:28``). The plain
    ``correlate_syncword`` divides by L instead. A bfloat16 ``chipbuf`` is
    widened to float32 first."""
    t = template.cpu().numpy()
    inv_l = torch.tensor(np.float32(1.0 / t.shape[0]), device=chipbuf.device)
    return conv1d(chipbuf.to(torch.float32), t) * inv_l


def is_sign_template(template) -> bool:
    """True when every tap of ``template`` is exactly +1.0 or -1.0 in
    float32 (every syncword template of the port): then ``t * x`` is exact
    and one fused multiply-add per tap rounds as the twin's separate product
    and sum do, so the kernel takes its sign body. Zeros, halves, NaN and
    anything one ulp off are a template like any other."""
    t = np.asarray(template, np.float32)
    return bool(t.ndim == 1 and t.size >= 1 and np.all(np.abs(t) == 1.0))


def corr_body(length: int, sign: bool) -> str:
    """The kernel body that runs a template of ``length`` taps: the sign or
    the separately rounded body, with L = 64 or 32 compiled in or L at run
    time; above 64 taps the shared-template body."""
    if length > MAX_TAPS:
        return "long_l"
    kind = "sign" if sign else "rounded"
    return f"{kind}_l{length}" if length in FIXED_LENGTHS else \
        f"{kind}_runtime_l"


def corr_kernel(chipbuf: torch.Tensor, template) -> torch.Tensor:
    """chipbuf [C, buf] float32 (or bfloat16, widened to float32 here: one
    elementwise pass over the ring) -> corr [C, buf - L + 1] float32,
    normalized so a perfect hard match scores 1.0. ``template`` [L] is a
    float32 NumPy array or tensor; the kernel takes up to 64 taps from the
    host, so a template on the card is copied back (the pipeline passes
    NumPy). CPU tensors run the plain twin; CUDA tensors launch the
    kernel."""
    dev = chipbuf.device
    if dev.type == "cpu":
        return corr_plain(chipbuf, torch.as_tensor(template))
    if dev.type != "cuda":
        raise ValueError(f"corr_kernel: unsupported device {dev}")
    if chipbuf.dtype == torch.bfloat16:
        chipbuf = chipbuf.to(torch.float32)
    cuda.check_tensor("chipbuf", chipbuf, torch.float32, dev, (None, None))
    if isinstance(template, torch.Tensor):
        cuda.check_tensor("template", template, torch.float32,
                          template.device, (None,))
        template = template.cpu().numpy()
    h = np.ascontiguousarray(template, np.float32)
    c, buf = chipbuf.shape
    L = h.shape[0]
    if h.ndim != 1 or not 1 <= L <= min(buf, 2048):
        raise ValueError(f"corr_kernel: template of shape {h.shape} for a "
                         f"buffer of {buf} (at most 2048 taps)")
    if c > 65535:
        raise ValueError(f"corr_kernel: {c} channels exceed the grid's 65535 "
                         "rows")
    sign = is_sign_template(h)
    # the long body reads the template from the card
    tdev = torch.from_numpy(h).to(dev) if L > MAX_TAPS else None
    out = torch.empty((c, buf - L + 1), dtype=torch.float32, device=dev)
    cuda.launch("corr", "sondetpu_corr", chipbuf.data_ptr(),
                0 if tdev is None else tdev.data_ptr(), h.ctypes.data, L,
                float(np.float32(1.0 / L)), int(sign), c, buf, out.data_ptr(),
                cuda.stream_handle(dev), body=corr_body(L, sign))
    return out
