"""The PFB's share of its roofline: the frozen bounds of the branch FIR
(K4) and the DFT (K6) at the cell's shapes, summed, over the device time
a block of their kernels (``pfb_fir`` and ``dft`` kernels), in
percent."""

from benchmark.frozen.roofline import pfb_dft_s, pfb_fir_s
from benchmark.metrics.common import kernels


def read(record):
    f = record["config"].get("fleet")
    if f is None:
        return None
    ev = kernels(record, "pfb_fir_kernel", "pfb_fir_bf16_kernel",
                 "pfb_dft_kernel", "dft2048_kernel", "dft2048_bf16_kernel")
    if not ev:
        return None
    bf16 = f["compute_dtype"] == "bf16"
    m, n = int(f["block_len"]), int(f["n_bins"])
    bound = pfb_fir_s(m, n, bf16=bf16) + pfb_dft_s(m, n, bf16=bf16)
    t = sum(d for _, _, d in ev) / record["blocks"] / 1e6
    return 100.0 * bound / t
