"""Waveform synthesis for the modulators (counterpart:
``sondetpu/sondes/modulate.py``).

A copy that takes ``gaussian_taps`` from the port's ``dsp.fir`` (the
original imports it from the jax module ``sondetpu.dsp.fir``). NumPy,
host-side, test- and smoke-time only; noise comes from an explicit
``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np

from benchmark.frozen.dsp.fir import gaussian_taps


def bits_to_symbols(bits: np.ndarray) -> np.ndarray:
    return np.asarray(bits, dtype=np.float32) * 2.0 - 1.0


def gfsk_modulate(bits: np.ndarray, sps: float, deviation_norm: float,
                  bt: float = 0.5) -> np.ndarray:
    """GFSK/FSK IQ from a bit stream.

    sps: samples per symbol (may be fractional); deviation_norm: peak
    deviation as a fraction of fs; bt: Gaussian BT product (bt >= 4 is
    effectively unfiltered FSK). Returns complex64 IQ at unit amplitude.
    """
    n_sym = bits.size
    n = int(round(n_sym * sps))
    idx = np.minimum((np.arange(n) / sps).astype(np.int64), n_sym - 1)
    nrz = bits_to_symbols(np.asarray(bits))[idx]
    if bt < 4.0:
        h = gaussian_taps(bt, sps)
        nrz = np.convolve(nrz, h, mode="same")
    phase = 2.0 * np.pi * deviation_norm * np.cumsum(nrz)
    return np.exp(1j * phase).astype(np.complex64)


def afsk_modulate(bits: np.ndarray, sps: float, f_mark: float, f_space: float,
                  fs: float, deviation_norm: float = 0.05) -> np.ndarray:
    """AFSK-over-FM IQ: audio tones keyed by bits, then FM-modulated.

    Mirrors the iMet-4/SRS-C50 uplink structure (SURVEY.md S5/S6): the
    carrier is FM-modulated by an audio signal that switches between the
    mark and space tones.
    """
    n_sym = bits.size
    n = int(round(n_sym * sps))
    idx = np.minimum((np.arange(n) / sps).astype(np.int64), n_sym - 1)
    freq = np.where(np.asarray(bits)[idx] > 0, f_mark, f_space)
    audio = np.sin(2.0 * np.pi * np.cumsum(freq) / fs)
    phase = 2.0 * np.pi * deviation_norm * np.cumsum(audio)
    return np.exp(1j * phase).astype(np.complex64)


def add_awgn(iq: np.ndarray, snr_db: float, rng=None,
             signal_power: float = 1.0) -> np.ndarray:
    """Add complex AWGN at the given SNR (dB, relative to signal power)."""
    rng = rng or np.random.default_rng(0)
    npow = signal_power / (10.0 ** (snr_db / 10.0))
    noise = (rng.normal(size=iq.size) + 1j * rng.normal(size=iq.size)) * np.sqrt(npow / 2)
    return (iq + noise).astype(np.complex64)


def freq_shift(iq: np.ndarray, f_norm: float) -> np.ndarray:
    """Shift IQ by a normalized frequency (cycles/sample)."""
    n = np.arange(iq.size)
    return (iq * np.exp(2j * np.pi * f_norm * n)).astype(np.complex64)
