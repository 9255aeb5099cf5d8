"""Wideband spectrum scan and automatic sonde-type classification
(counterpart: ``sondetpu/dsp/scan.py``).

In the reference an operator watches the waterfall, drags a VFO onto a
carrier and picks the protocol from the type combobox (main.cpp:55-56,
136-151). This module does both steps:

1. :func:`welch_psd`: the mean Hann-windowed periodogram of the wideband
   planes, one ``torch.fft.fft`` over segments on ``device`` (the
   original's mixed-radix einsum DFT runs outside any kernel, so the FFT
   is its plain port).
2. :func:`detect_carriers`: host NumPy peak grouping of the PSD into
   candidate carriers over a median noise floor, copied as is.
3. :func:`classify_carriers`: channelize once with the port's PFB, then run
   one probe :class:`DecoderSession` per family over all the carriers; a
   family claims a carrier when its frames parse, the most decoded frames
   winning and ties going to the earlier registry entry.

:func:`scan_to_config` turns the result into the ``channel_map`` that
``decode --wideband`` reads. Planes may be NumPy arrays or tensors; they
are moved to ``device`` once, and a complex64 capture is split into planes
on the host (never rebuilt as a complex array there).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sondetpu_torch.dsp.channelizer import PFBChannelizer
from sondetpu_torch.io.iq import c64_to_planes


def device_planes(iq, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A complex64 host capture or an (i, q) pair of arrays or tensors ->
    float32 planes on ``device``."""
    x_i, x_q = iq if isinstance(iq, tuple) else c64_to_planes(np.asarray(iq))
    return tuple(torch.as_tensor(x).to(device, torch.float32)
                 for x in (x_i, x_q))


# ---------------------------------------------------------------------------
# 1. spectrum estimate
# ---------------------------------------------------------------------------

def welch_psd(x_i, x_q, nfft: int = 4096, device="cuda"):
    """Averaged power spectrum of a wideband I/Q capture.

    Returns ``(bins, psd)`` in ascending frequency from -fs/2: ``bins`` in
    units of fs_wide / nfft (the caller multiplies), ``psd`` a host float32
    array."""
    x_i, x_q = device_planes((x_i, x_q), device)
    n = (x_i.shape[-1] // nfft) * nfft
    if n == 0:
        raise ValueError(f"need at least nfft={nfft} samples")
    win = torch.from_numpy(np.hanning(nfft).astype(np.float32)).to(x_i.device)
    seg = torch.complex(x_i[:n].reshape(-1, nfft) * win,
                        x_q[:n].reshape(-1, nfft) * win)
    y = torch.fft.fft(seg, dim=1)
    psd = (y.real * y.real + y.imag * y.imag).mean(dim=0).cpu().numpy()
    # natural DFT order -> ascending frequency (negative half first)
    psd = np.fft.fftshift(psd)
    bins = np.arange(nfft) - nfft // 2
    return bins, psd


# ---------------------------------------------------------------------------
# 2. carrier detection
# ---------------------------------------------------------------------------

@dataclass
class Carrier:
    """One detected emission in the wideband span."""

    center_hz: float
    bw_hz: float
    snr_db: float
    power: float = 0.0
    sonde: Optional[str] = None     # filled by classify_carriers
    frames: int = 0                 # decoded frames backing the claim
    scores: Dict[str, int] = field(default_factory=dict)


def detect_carriers(iq, fs_wide: float, nfft: int = 4096,
                    min_snr_db: float = 8.0, merge_hz: float = 4000.0,
                    min_bw_hz: float = 800.0, max_carriers: int = 64,
                    device="cuda") -> List[Carrier]:
    """Find active emissions in a wideband capture.

    ``iq`` is complex64 (host) or an (i, q) plane pair (arrays or
    tensors). The noise floor is the PSD median (sondes occupy a tiny
    fraction of a wideband span); bins more than ``min_snr_db`` above it
    are grouped into runs, runs closer than ``merge_hz`` merge (GFSK
    spectra are double-lobed), and each run becomes a :class:`Carrier` at
    its power centroid.
    """
    x_i, x_q = device_planes(iq, device)
    bins, psd = welch_psd(x_i, x_q, nfft, device)
    hz_per_bin = fs_wide / nfft
    # light smoothing (~500 Hz) so double-lobed FSK spectra group cleanly
    k = max(1, int(round(500.0 / hz_per_bin)))
    if k > 1:
        psd = np.convolve(psd, np.ones(k, np.float32) / k, mode="same")
    floor = float(np.median(psd))
    thresh = floor * 10.0 ** (min_snr_db / 10.0)
    mask = psd > thresh

    # group mask runs, merging gaps below merge_hz
    gap = max(1, int(round(merge_hz / hz_per_bin)))
    runs: List[Tuple[int, int]] = []   # [start, end) bin index ranges
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        return []
    start = prev = idx[0]
    for i in idx[1:]:
        if i - prev > gap:
            runs.append((start, prev + 1))
            start = i
        prev = i
    runs.append((start, prev + 1))

    # the spectrum is circular: a carrier near +/-fs/2 has energy on both
    # edges of the fftshifted PSD — merge edge runs across the wrap so a
    # near-Nyquist sonde is ONE carrier, not a main lobe plus an alias tail
    # (combined circular gap — each run being near ITS edge is not enough,
    # or two carriers up to 2*merge_hz apart across the fold would merge)
    wrap = (len(runs) >= 2
            and runs[0][0] + (nfft - runs[-1][1]) <= gap)
    out: List[Carrier] = []
    for ri, (a, b) in enumerate(runs):
        if wrap and ri == len(runs) - 1:
            continue                       # consumed by the first run below
        p = np.clip(psd[a:b] - floor, 0.0, None)
        f = bins[a:b].astype(np.float64)
        width = b - a
        pk = float(psd[a:b].max())
        if wrap and ri == 0:
            a2, b2 = runs[-1]
            # unwrap the top-edge run below -fs/2 so the centroid is right;
            # span the circular gap like linear merging spans in-band gaps
            p = np.concatenate([np.clip(psd[a2:b2] - floor, 0.0, None), p])
            f = np.concatenate([bins[a2:b2].astype(np.float64) - nfft, f])
            width += (b2 - a2) + a + (nfft - b2)
            pk = max(pk, float(psd[a2:b2].max()))
        tot = float(p.sum())
        if tot <= 0.0:
            continue
        center = float((f * p).sum() / tot) * hz_per_bin
        # wrap the centroid back into [-fs/2, fs/2)
        center = (center + fs_wide / 2.0) % fs_wide - fs_wide / 2.0
        bw = width * hz_per_bin
        if bw < min_bw_hz:
            continue
        snr = 10.0 * np.log10(pk / max(floor, 1e-30))
        out.append(Carrier(center_hz=center, bw_hz=bw, snr_db=snr, power=tot))
    out.sort(key=lambda c: -c.power)
    return out[:max_carriers]


# ---------------------------------------------------------------------------
# 3. classification by decode probe
# ---------------------------------------------------------------------------

def classify_carriers(iq, fs_wide: float, carriers: Sequence[Carrier],
                      fs_chan: float = 48000.0, block_len: int = 48000,
                      families: Optional[Sequence[str]] = None,
                      sync_threshold: float = 0.55,
                      min_frames: int = 1, device="cuda") -> List[Carrier]:
    """Identify the protocol on each detected carrier by decoding it.

    The wideband capture is PFB-channelized once on ``device``; each
    carrier maps to its nearest bin plus a fine DDC offset (the VFO-snap
    analogue, main.cpp:56). Then for every candidate family a probe
    :class:`DecoderSession` runs ALL carriers as one channel batch, their
    rows gathered from the PFB output on the device; the per-carrier
    telemetry-update counts are the evidence. A carrier is claimed by the
    family that decoded the most frames on it (ties to the earlier
    registry entry); carriers nothing decodes keep ``sonde=None``.

    Mutates and returns ``carriers`` (``sonde``, ``frames``, ``scores``).
    """
    from sondetpu_torch.runtime.pipeline import PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession
    from sondetpu_torch.sondes import SUPPORTED_TYPES

    carriers = list(carriers)
    if not carriers:
        return carriers
    n_bins = int(round(fs_wide / fs_chan))
    if abs(n_bins * fs_chan - fs_wide) > 1e-6 or n_bins < 2:
        raise ValueError(
            f"fs_wide={fs_wide} must be an integer multiple (>=2) of "
            f"fs_chan={fs_chan} to channelize for classification")
    device = torch.device(device)
    x_i, x_q = device_planes(iq, device)

    # channelize once; probe blocks are shared by every family
    pfb = PFBChannelizer(n_bins, device)
    st = pfb.init_state()
    w = n_bins * block_len
    blocks: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for s in range(0, x_i.shape[-1] - w + 1, w):
        st, yi, yq = pfb(st, x_i[s:s + w], x_q[s:s + w])
        blocks.append((yi, yq))
    if not blocks:
        raise ValueError(f"capture too short: need {w} wideband samples "
                         f"per probe block")

    bins_sel: List[int] = []
    resids: List[float] = []
    for c in carriers:
        k, resid = pfb.bin_and_offset(c.center_hz, fs_chan)
        bins_sel.append(k)
        resids.append(resid)
    rows = torch.tensor(bins_sel, dtype=torch.int64, device=device)

    fams = list(families) if families is not None else list(SUPPORTED_TYPES)
    counts: Dict[str, np.ndarray] = {}
    for fam in fams:
        cfg = PipelineConfig(
            sonde=fam, channels=len(carriers), fs=fs_chan,
            block_len=block_len, sync_threshold=sync_threshold,
            fine_offsets=tuple(resids) if any(resids) else None)
        sess = DecoderSession(cfg, device)
        n_upd = np.zeros(len(carriers), np.int64)
        for yi, yq in blocks:
            for ch, _t in sess.process_block((yi.index_select(0, rows),
                                              yq.index_select(0, rows))):
                n_upd[ch] += 1
        counts[fam] = n_upd

    for i, c in enumerate(carriers):
        c.scores = {f: int(counts[f][i]) for f in fams if counts[f][i] > 0}
        # ties go to the earlier registry entry; measured on-air case:
        # rs41x (the extended superset decoder) parses standard RS41 frames
        # too, so a standard carrier ties rs41==rs41x and resolves to rs41,
        # while a genuine extended carrier scores rs41x strictly higher
        best = max(fams, key=lambda f: counts[f][i])
        if counts[best][i] >= min_frames:
            c.sonde = best
            c.frames = int(counts[best][i])
    return carriers


def scan_to_config(carriers: Sequence[Carrier], cfg=None,
                   fs_wide: Optional[float] = None):
    """Fill a :class:`FrameworkConfig` channel_map from classified carriers
    (classified ones only), ready for ``decode --wideband --config``.
    ``fs_wide`` also bakes the PFB bin count so decode needs no --bins."""
    from sondetpu_torch.cli.config import ChannelConfig, FrameworkConfig

    cfg = cfg or FrameworkConfig()
    cfg.wideband = True
    if fs_wide is not None:
        cfg.wide_bins = int(round(fs_wide / cfg.fs))
    cfg.channel_map = [
        ChannelConfig(center_freq=float(c.center_hz), sonde=c.sonde)
        for c in carriers if c.sonde is not None]
    return cfg
