"""The port's FER harness against the JAX package's (ROADMAP §C, gap 4).

For each of the eight families, ``fer_sweep`` runs in both packages at the
SNRs of ``tests/test_fer_acceptance.py`` (10 and 14 dB for the GFSK/FSK
families, 12 and 16 dB for AFSK) on the same seed, the port on the CPU in
the original's config (the plain-op path, one channel). The decoded-unit
key sets of every run (the clean one and each SNR) must be equal, and so
must the returned points (decoded counts and FER). The AFSK families run
200 frames, where their FER is not 0 at the knee; the rest 24. The kernel
path (``use_pallas`` on 8 channels) is held to the JAX package's kernels
in interpret mode on the clean signal, with the one diagnosed tie of
imet4 named (``KERNEL_TIE``).
"""

import functools

import pytest

from sondetpu.bench import fer as jfer
from sondetpu_torch.bench import fer as tfer
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

CASES = {"rs41": 24, "rs41x": 24, "m10": 24, "dfm": 24, "ims100": 24,
         "mrzn1": 24, "imet4": 200, "c50": 200}


def jax_sweep_with_units(monkeypatch, *args, use_pallas=False, **kw):
    """The JAX package's fer_sweep(*args, **kw), and the decoded-unit key
    set (the port's ``unit_key``) of each session it ran, in order (the
    clean run, then each SNR). ``use_pallas`` sets the sessions' config
    flag, which the original's fer_sweep does not take; on the CPU its
    kernels run in interpret mode."""
    if use_pallas:
        monkeypatch.setattr(jfer, "PipelineConfig", functools.partial(
            jfer.PipelineConfig, use_pallas=True))
    made = jfer.DecoderSession
    runs = []

    def recording(*a, **k):
        sess = made(*a, **k)
        keys = set()
        runs.append(keys)
        inner = sess.decoder.decode_byte_frames

        def decode(*aa, **kk):
            frags = inner(*aa, **kk)
            keys.update(tfer.unit_key(ch, fr) for ch, fr in frags)
            return frags

        sess.decoder.decode_byte_frames = decode
        return sess

    monkeypatch.setattr(jfer, "DecoderSession", recording)
    return jfer.fer_sweep(*args, **kw), runs


@pytest.mark.parametrize("sonde", list(CASES))
def test_fer_sweep_equals_the_original(monkeypatch, sonde):
    snrs = [12.0, 16.0] if sonde in ("imet4", "c50") else [10.0, 14.0]
    n = CASES[sonde]
    want, jruns = jax_sweep_with_units(monkeypatch, sonde, snrs,
                                       n_frames=n, seed=1)
    truns = []
    got = tfer.fer_sweep(sonde, snrs, n_frames=n, seed=1, device="cpu",
                         unit_sets=truns)
    assert len(truns) == len(jruns) == 1 + len(snrs)
    assert truns == jruns
    assert got == want
    assert want["fer_denominator_clean_units"] >= n * 0.5


# the one decode unit in which the port's CPU twins part from the JAX
# package's kernel path: imet4's packet 124 in the clean run (see below)
KERNEL_TIE = {"imet4": 124}


@pytest.mark.parametrize("sonde", list(CASES))
def test_fer_kernel_path_against_the_original(monkeypatch, sonde):
    """The kernel path (use_pallas, 8 identical channels) in both packages
    on the clean signal: the port's twins against the JAX package's
    kernels in interpret mode. The decoded-unit sets are equal, but for
    imet4: one of its blocks holds 11 sync peaks for its 10 frame slots,
    and the two weakest correlations (chips 1122 and 1642 of the ring)
    differ by about 1e-7, so the last ulp decides which is dropped. The
    JAX package's kernels (and the card's) keep 1122, packet 124, and the
    port's twins keep 1642, a packet the next block gathers anyway; so
    the JAX side has packet 124 on every channel, and the port has nothing
    the JAX side lacks."""
    n = CASES[sonde]
    want, jruns = jax_sweep_with_units(monkeypatch, sonde, [], n_frames=n,
                                       seed=1, channels=8, use_pallas=True)
    truns = []
    got = tfer.fer_sweep(sonde, [], n_frames=n, seed=1, channels=8,
                         device="cpu", use_pallas=True, unit_sets=truns)
    assert len(truns) == len(jruns) == 1
    jax_only, port_only = jruns[0] - truns[0], truns[0] - jruns[0]
    assert not port_only
    tie = KERNEL_TIE.get(sonde)
    if tie is None:
        assert not jax_only
        assert got == want
    else:
        assert sorted((k[0], k[2]) for k in jax_only) == \
            [(ch, tie) for ch in range(8)]
        assert got["fer_denominator_clean_units"] == \
            want["fer_denominator_clean_units"] - 1
