"""Rows the peak pick (``peak_pick.py``) is held to its twin on, on the card
and, against the original, on the CPU.

:func:`planted_rows` makes rows at a route's shape: quantized noise (ties
everywhere) with planted peaks at ``float32(threshold)``, one ulp either
side of it, and at two values that tie with each other. ``EDGE_CASES``
names small shapes the routes do not give but the pick must still follow:
rows whose every candidate ends up suppressed, ``n`` not a multiple of
the half-window, a last window of one column, windows whose top two tie,
one-column windows, a window wider than the row, rows of -inf columns.
"""

from __future__ import annotations

import numpy as np
import torch

# 0.6 rounds up to float32 and 0.7 down: a comparison made in float64
# would part from the eager one at float32(0.7)
THRESHOLDS = (0.6, 0.7)


def threshold_values(threshold: float) -> np.ndarray:
    """float32(threshold) and the float32 values one ulp below and above."""
    t = np.float32(threshold)
    return np.array([np.nextafter(t, np.float32(-np.inf)), t,
                     np.nextafter(t, np.float32(np.inf))], np.float32)


def planted_rows(c: int, n: int, min_distance: int, threshold: float,
                 seed: int, device="cpu") -> torch.Tensor:
    """[c, n] float32 on ``device``: noise in [-1, 1] quantized to 1/4,
    with a peak every ~``min_distance`` columns (each row shifted by its
    own offset) cycling through :func:`threshold_values`, 0.9 and 0.9 again
    (a tie), so that the rounds meet ties, values on the threshold and
    peaks within each other's suppression distance."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.rand((c, n), generator=g, device=device) * 2.0 - 1.0
    x = torch.round(x * 4.0) / 4.0
    step = max(min_distance, 1)
    offsets = torch.randint(0, step, (c, 1), generator=g, device=device)
    cols = torch.arange(0, n, step, device=device)[None, :] + offsets
    values = torch.from_numpy(np.concatenate(
        [threshold_values(threshold), np.float32([0.9, 0.9])])).to(device)
    peaks = values[torch.arange(cols.shape[1], device=device) % len(values)]
    keep = cols < n
    rows = torch.arange(c, device=device)[:, None].expand_as(cols)
    x[rows[keep], cols[keep]] = peaks.expand_as(cols)[keep]
    return x


def _edge_rows(kind: str, c: int, n: int, rng) -> np.ndarray:
    if kind == "noise":
        return np.round(rng.uniform(-1, 1, (c, n)) * 4) / 4
    if kind == "flat":                  # every window: first and second tie
        return np.full((c, n), 0.5)
    if kind == "pairs":                 # each window's max twice
        x = np.round(rng.uniform(-1, 0.5, (c, n)) * 4) / 4
        x[:, ::5] = 0.9
        x[:, 2::5] = 0.9
        return x
    if kind == "below":                 # nothing reaches the threshold
        return rng.uniform(-1, 0.5, (c, n))
    x = rng.uniform(-1, 1, (c, n))      # "neg_inf": -inf columns and a row
    x[rng.uniform(size=(c, n)) < 0.4] = -np.inf
    x[-1] = -np.inf
    return x


# (label, n, max_peaks, min_distance, row kind); half = max(md // 2, 1)
EDGE_CASES = (
    ("all_suppressed", 50, 12, 20, "noise"),      # 10 candidates, 12 rounds
    ("all_suppressed_long", 37, 40, 8, "flat"),
    ("n_not_multiple_of_half", 5 * 32 + 17, 6, 64, "noise"),
    ("one_column_last_window", 3 * 32 + 1, 5, 64, "pairs"),
    ("duplicate_second", 300, 9, 10, "pairs"),
    ("flat_rows", 256, 7, 16, "flat"),
    ("one_column_windows", 40, 5, 1, "noise"),
    ("zero_distance", 33, 6, 0, "pairs"),
    ("window_wider_than_row", 300, 3, 5000, "noise"),
    ("one_column_row", 1, 3, 64, "noise"),
    ("below_threshold", 500, 8, 40, "below"),
    ("neg_inf_columns", 301, 9, 30, "neg_inf"),
)


def edge_case_rows(kind: str, c: int, n: int, seed: int = 0) -> np.ndarray:
    """[c, n] float32 rows of an ``EDGE_CASES`` kind."""
    return _edge_rows(kind, c, n, np.random.default_rng(seed)).astype(
        np.float32)
