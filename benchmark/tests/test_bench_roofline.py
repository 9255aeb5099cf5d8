"""The frozen roofline counts at the kernel table's shapes (PERF.md):
K1 at decim 2 1.59 ms; K4 1.88 ms and in bf16 1.41; K6 1.88 and in bf16
0.94 ([2048, 192000] channels, 41 taps; [192000, 2048] PFB rows)."""

import pytest

from benchmark.frozen import roofline


@pytest.mark.parametrize("got,want", [
    (lambda: roofline.frontend_s(2048, 192000, 2, 41), 1.59e-3),
    (lambda: roofline.pfb_fir_s(192000, 2048, bf16=False), 1.88e-3),
    (lambda: roofline.pfb_fir_s(192000, 2048, bf16=True), 1.41e-3),
    (lambda: roofline.pfb_dft_s(192000, 2048, bf16=False), 1.88e-3),
    (lambda: roofline.pfb_dft_s(192000, 2048, bf16=True), 0.94e-3),
], ids=["k1-decim2", "k4-f32", "k4-bf16", "k6-f32", "k6-bf16"])
def test_bounds_match_the_kernel_table(got, want):
    assert round(got(), 5) == pytest.approx(want, abs=6e-6)
