"""Traffic of one sonde per channel, every channel on its centre.

``T`` truths of the configuration's family are drawn from the seed and
modulated once, each into a circular signal of ``period_s`` seconds.
Channel ch carries truth ch % T, circularly shifted by a seeded number of
samples, plus complex Gaussian noise of a seeded standard deviation per
channel (per component, uniform over ``noise_std``), made on the device,
quantized to cs16 when the configuration ingests int16. The ring holds
``RING_BLOCKS`` consecutive blocks of that stream; the period is a whole
number of ring lengths, so the stream through the ring is continuous.

With ``tuning``, each channel's carrier is rotated off the channel centre
by a seeded offset, drawn uniformly from ``offset_hz`` and rounded to
``offset_step_hz`` (a whole number of cycles a period, so the rotated
stream stays continuous through the ring), in float64 on the device. The
offsets go to the system as its ``fine_offsets`` (the receiver is tuned
to its carriers), with ``afc`` as the mix says.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen.signals import (RING_BLOCKS, Ring, circular_baseband,
                                   draw_truth, numpy_rng, torch_generator)


def make(torch, config: dict, traffic: dict, seed: int, device) -> Ring:
    p = config["pipeline"]
    fs, n, c = float(p["fs"]), int(p["block_len"]), int(p["channels"])
    ring = RING_BLOCKS
    period = int(round(traffic["period_s"] * fs))
    if period != ring * n:
        raise ValueError(f"a period of {period} samples is not {ring} blocks "
                         f"of {n}")
    rng = numpy_rng(seed)
    truths = [draw_truth(p["sonde"], rng) for _ in range(traffic["truths"])]
    shift = rng.integers(0, period, size=c)
    lo, hi = traffic["noise_std"]
    std = rng.uniform(lo, hi, size=c).astype(np.float32)
    tune = traffic.get("tuning")
    offsets = None
    if tune:
        step = float(tune["offset_step_hz"])
        cycles = step * traffic["period_s"]
        if cycles < 1 or abs(cycles - round(cycles)) > 1e-9:
            raise ValueError("offset_step_hz: not whole cycles a period")
        olo, ohi = tune["offset_hz"]
        offsets = np.round(rng.uniform(olo, ohi, size=c) / step) * step
        off_t = torch.from_numpy(offsets).to(device)[:, None]
    base = np.stack([circular_baseband(t, period, fs) for t in truths])
    # [T, period + n]: a block never wraps inside this copy
    ext = np.concatenate([base, base[:, :n]], axis=1)
    planes = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
              for x in (ext.real, ext.imag)]
    del base, ext
    gen = torch_generator(torch, seed, device)
    which = torch.from_numpy(np.arange(c) % len(truths)).to(device)
    shift_t = torch.from_numpy(shift).to(device)
    std_t = torch.from_numpy(std).to(device)[:, None]
    ar = torch.arange(n, device=device)
    quant = p.get("input_dtype", "f32") == "i16"
    chunk = 256
    blocks = []
    for b in range(ring):
        out = []
        for base_plane in planes:
            rows = []
            for r0 in range(0, c, chunk):
                r1 = min(c, r0 + chunk)
                start = (b * n + shift_t[r0:r1]) % period
                x = base_plane[which[r0:r1, None], start[:, None] + ar[None, :]]
                if offsets is not None:
                    x = _rotate(torch, planes, which[r0:r1], start,
                                off_t[r0:r1], b * n, ar, fs, base_plane)
                x = x + std_t[r0:r1] * torch.randn((r1 - r0, n), generator=gen,
                                                   device=device)
                if quant:
                    x = torch.clamp(torch.round(x * 32767.0), -32768.0,
                                    32767.0).to(torch.int16)
                rows.append(x)
            out.append(torch.cat(rows))
        blocks.append(tuple(out))
    info = {"truths": len(truths), "period_s": traffic["period_s"],
            "noise_std": [float(std.min()), float(std.max())],
            "input_dtype": "i16" if quant else "f32"}
    if offsets is not None:
        info["tuning"] = {"fine_offsets": [float(f) for f in offsets],
                          "afc": bool(tune.get("afc"))}
    return Ring(blocks, {ch: truths[ch % len(truths)] for ch in range(c)}, info)


def _rotate(torch, planes, which, start, off, t0, ar, fs, plane):
    """One plane of the rows' signal rotated by exp(+2 pi i f t), t the
    stream's sample index over fs, in float64."""
    idx = start[:, None] + ar[None, :]
    i = planes[0][which[:, None], idx].to(torch.float64)
    q = planes[1][which[:, None], idx].to(torch.float64)
    ph = (2.0 * torch.pi / fs) * off * (t0 + ar[None, :]).to(torch.float64)
    c, s = torch.cos(ph), torch.sin(ph)
    out = i * c - q * s if plane is planes[0] else i * s + q * c
    return out.to(torch.float32)
