"""Frozen roofline counts of the kernels the benchmark reports.

The least time the card could take for a function's work is the larger of
the bytes it must move over device memory's rate and its operations over
the arithmetic rate. Bytes: each input read once, each output written
once. Operations: the single-rounded ones the function's exact order needs
(the kernels round every product and sum on its own, so an FMA counts as
two). Rates: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67
TFLOP/s of FP32 outside the tensor cores, 33.5e12 single-rounded
operations a second; bfloat16 arithmetic on packed bf16x2 pairs at twice
that. These counts are the benchmark's yardstick and are not edited.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
BF16X2_OPS_PER_S = 2 * FP32_OPS_PER_S

# the FM discriminator per output: 4 products and 2 sums, fast_atan2's
# division, 5 polynomial steps of a product and a sum, 4 more, the scale
DISC_OPS = 23


def bound_s(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S
            ) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def frontend_s(channels: int, n: int, decim: int, ntaps: int,
               in_bytes: int = 4, halo: int = 256, identity: bool = False
               ) -> float:
    """K1, the fused front end as the pipeline calls it (block DC on), on
    planes [channels, n] of ``in_bytes`` a sample: per output the channel
    filter (2 planes x T products and sums), the discriminator, the matched
    FIR unless its taps are the delay, the DC sum and its subtraction.
    Bytes: both planes and both tails read, the tails written, the
    float32 output and the DC."""
    outs = channels * (n // decim)
    per = 4 * ntaps + DISC_OPS + (0 if identity else 2 * ntaps) + 2
    nbytes = (2 * channels * n * in_bytes + 2 * 2 * channels * halo * in_bytes
              + 4 * outs + 4 * channels)
    return bound_s(nbytes, outs * per)


def pfb_fir_s(m: int, n_bins: int, tpp: int = 8, bf16: bool = True) -> float:
    """K4, the PFB's branch FIR on float32 wideband planes [m, N] with a
    [tpp, N] tail each: a product and a sum per tap but the first, per
    output of two planes; bfloat16 outputs at the bf16x2 rate (float32:
    float32 outputs at the FP32 rate)."""
    out_bytes = 2 if bf16 else 4
    nbytes = (2 * m * n_bins * 4 + 2 * tpp * n_bins * 4 + tpp * n_bins * 4
              + 2 * m * n_bins * out_bytes)
    ops = 2 * m * n_bins * (2 * tpp - 1)
    return bound_s(nbytes, ops, BF16X2_OPS_PER_S if bf16 else FP32_OPS_PER_S)


def pfb_dft_s(m: int, n_bins: int, bf16: bool = True) -> float:
    """K6, the DFT across the N branches of every row: both planes read
    and written once in their dtype, the twiddles read; 5 N log2 N
    operations a row."""
    width = 2 if bf16 else 4
    nbytes = 2 * 2 * m * n_bins * width + 4 * n_bins
    ops = m * 5 * n_bins * (n_bins.bit_length() - 1)
    return bound_s(nbytes, ops)
