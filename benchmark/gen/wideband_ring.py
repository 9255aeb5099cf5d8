"""Traffic of a wideband stream into the PFB: noise plus a few carriers.

The configuration's fleet map gives each PFB bin its family. For each
family, ``carriers[family]`` bins are drawn from the seed among that
family's bins (never bin 0), each with a truth of its own, modulated once
at the channel rate into a circular signal of ``period_s`` seconds and
shifted by a seeded number of samples. A carrier at bin k is placed as a
zero-order hold over the N bins and a phase ramp: row r, column j of a
block (wideband sample r * N + j) gets a[r] * exp(2*pi*i*k*j/N), one
float32 matrix product for all carriers, plus complex Gaussian noise of
``noise_std`` per component, made on the device. The ring holds
``RING_BLOCKS`` consecutive blocks; the period is a whole number of ring
lengths.
"""

from __future__ import annotations

import numpy as np

from benchmark.gen.signals import (RING_BLOCKS, Ring, circular_baseband,
                                   draw_truth, numpy_rng, torch_generator)


def family_of(config: dict, k: int) -> str:
    fmap = config["fleet"]["family_by_bin_mod"]
    return fmap[k % len(fmap)]


def make(torch, config: dict, traffic: dict, seed: int, device) -> Ring:
    f = config["fleet"]
    nb, m, fs = int(f["n_bins"]), int(f["block_len"]), float(f["fs_chan"])
    ring = RING_BLOCKS
    period = int(round(traffic["period_s"] * fs))
    if period != ring * m:
        raise ValueError(f"a period of {period} samples is not {ring} blocks "
                         f"of {m}")
    rng = numpy_rng(seed)
    carriers = []
    for family, count in traffic["carriers"].items():
        bins = [k for k in range(1, nb) if family_of(config, k) == family]
        for k in rng.choice(bins, size=int(count), replace=False):
            carriers.append((int(k), draw_truth(family, rng)))
    carriers.sort()
    shift = rng.integers(0, period, size=len(carriers))
    base = np.stack([circular_baseband(t, period, fs) for _, t in carriers])
    ext = np.concatenate([base, base[:, :m]], axis=1)        # [C, period + m]
    a_re = torch.from_numpy(np.ascontiguousarray(ext.real, np.float32)).to(device)
    a_im = torch.from_numpy(np.ascontiguousarray(ext.imag, np.float32)).to(device)
    del base, ext
    ks = np.array([k for k, _ in carriers], np.float64)
    ang = 2.0 * np.pi * np.outer(ks, np.arange(nb)) / nb
    er, ei = np.cos(ang), np.sin(ang)
    # [2C, 2N]: [a_re, a_im] @ this = [wide_re, wide_im]
    e = torch.from_numpy(np.block([[er, ei], [-ei, er]]).astype(np.float32)
                         ).to(device)
    gen = torch_generator(torch, seed, device)
    ar = torch.arange(m, device=device)
    std = float(traffic["noise_std"])
    blocks = []
    for b in range(ring):
        start = torch.from_numpy((b * m + shift) % period).to(device)
        idx = start[:, None] + ar[None, :]
        rows = torch.arange(len(carriers), device=device)[:, None]
        a = torch.cat([a_re[rows, idx], a_im[rows, idx]]).t()     # [m, 2C]
        wide = a @ e                                              # [m, 2N]
        wi = wide[:, :nb] + std * torch.randn((m, nb), generator=gen,
                                              device=device)
        wq = wide[:, nb:] + std * torch.randn((m, nb), generator=gen,
                                              device=device)
        del wide, a
        blocks.append((wi.reshape(-1).contiguous(),
                       wq.reshape(-1).contiguous()))
    info = {"carriers": [[k, t["family"], t["serial"]] for k, t in carriers],
            "period_s": traffic["period_s"], "noise_std": std}
    return Ring(blocks, {k: t for k, t in carriers}, info)
