"""The port's FleetSession with the JAX fleet's use_pallas and compute_dtype
against the JAX FleetSession with the same arguments, on the CPU.

A 16-bin wideband stream carries an rs41, an m10, a dfm, an imet4 and a
c50 sonde, each from the port's modulator at the wideband rate, at the
centre of its bin, plus seeded noise. The JAX fleet runs its PFB's XLA
form (its Pallas PFB needs a TPU) and its groups' Pallas kernels in
interpret mode; the port's runs its plain twins. Block by block the
number of telemetry updates and the telemetry of every logical channel
must be equal. The float32 fleet on its kernel routes is
tests/test_torch_fleet.py's (rs41, m10, dfm) and tests/test_torch_afsk.py's
(imet4, c50) against the JAX fleet with use_pallas=True.
"""

import json

import numpy as np
import pytest

from sondetpu.runtime.fleet import FleetChannel as JaxChannel
from sondetpu.runtime.fleet import FleetSession as JaxFleet
from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
from sondetpu_torch.sondes.c50 import C50Modulator, C50Truth
from sondetpu_torch.sondes.dfm import DFMModulator, DFMTruth
from sondetpu_torch.sondes.imet4 import IMET4Modulator, IMET4Truth
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
from sondetpu_torch.sondes.modulate import freq_shift
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

N_BINS = 16
FS_WIDE = N_BINS * 48000.0
N_BLOCKS = 2
PLAN = ((2, "rs41"), (4, "m10"), (7, "dfm"), (10, "imet4"), (13, "c50"))


@pytest.fixture(scope="module")
def wideband():
    """N_BLOCKS one-second blocks of the 16-bin stream, noise std 0.02."""
    n = N_BLOCKS * N_BINS * 48000
    sig = {"rs41": RS41Modulator().modulate(
        [RS41Truth(frame_no=40 + i) for i in range(5)], fs=FS_WIDE),
        "m10": M10Modulator().modulate(
            [M10Truth(frame_no=8 + i) for i in range(14)], fs=FS_WIDE),
        "dfm": DFMModulator().modulate(
            [DFMTruth(frame_no=2 + k) for k in range(11)], fs=FS_WIDE),
        "imet4": IMET4Modulator().modulate(
            [IMET4Truth(frame_no=1 + k) for k in range(3)], fs=FS_WIDE),
        "c50": C50Modulator().modulate(
            [C50Truth(frame_no=1 + k) for k in range(10)], fs=FS_WIDE)}
    centers = FleetSession([FleetChannel(1, "rs41")], N_BINS,
                           "cpu").pfb.center_freqs(FS_WIDE)
    wide = np.zeros(n, np.complex64)
    for k, family in PLAN:
        x = freq_shift(sig[family][:n], centers[k] / FS_WIDE)
        wide[:x.size] += x
    rng = np.random.default_rng(16)
    return wide + (0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
                   ).astype(np.complex64)


def _telemetry_text(telem):
    return {k: json.dumps(t.to_dict(), sort_keys=True)
            for k, t in telem.items()}


@pytest.fixture(scope="module")
def jax_runs(wideband):
    """run(compute_dtype, use_pallas) -> (the JAX fleet, [(updates,
    telemetry) per block]): one JAX run per argument pair, shared by the
    cases that compare with it."""
    cache = {}
    w = N_BINS * 48000

    def run(compute_dtype, use_pallas):
        key = (compute_dtype, use_pallas)
        if key not in cache:
            jf = JaxFleet([JaxChannel(b, s) for b, s in PLAN], N_BINS,
                          use_pallas=use_pallas, compute_dtype=compute_dtype)
            per = []
            for i in range(0, wideband.size, w):
                per.append((jf.process_wideband(wideband[i:i + w]),
                            _telemetry_text(jf.telemetry)))
            cache[key] = (jf, per)
        return cache[key]

    return run


@pytest.mark.parametrize("compute_dtype,use_pallas,jax_pallas", [
    ("f32", False, False), ("bf16", True, True), ("bf16", False, False),
    ("bf16", None, True)],
    ids=["f32-plain", "bf16-kernels", "bf16-plain", "bf16-none"])
def test_fleet_dtype_and_route_match_jax_fleet(wideband, jax_runs,
                                                compute_dtype, use_pallas,
                                                jax_pallas):
    """Each group takes the original's route and dtype (bf16: AFSK groups
    and kernel-route groups that are not dual-tone in float32, the rest in
    bfloat16; the PFB in bfloat16); use_pallas=None puts every group on its
    kernel route, held to the JAX fleet with use_pallas=True (the
    original's None means no kernels on any backend but a TPU). A group is
    padded to 8 rows only on a kernel route. Block by block the same
    updates and telemetry; every carrier decodes."""
    w = N_BINS * 48000
    jf, per_block = jax_runs(compute_dtype, jax_pallas)
    tf = FleetSession([FleetChannel(b, s) for b, s in PLAN], N_BINS, "cpu",
                      use_pallas=use_pallas, compute_dtype=compute_dtype)
    bf16 = compute_dtype == "bf16"
    assert tf.pfb.dtype == jf.pfb.dtype == compute_dtype
    for sonde, (idxs, sess) in tf.groups.items():
        jcfg, cfg = jf.groups[sonde][1].config, sess.config
        assert cfg.compute_dtype == jcfg.compute_dtype
        assert cfg.use_pallas == jcfg.use_pallas == jax_pallas
        assert (cfg.compute_dtype == "bf16") == (
            bf16 and sonde not in ("imet4", "c50")
            and (sonde == "m10" or not jax_pallas))
        assert cfg.channels == (8 if jax_pallas else 1)
        assert (sess.pipeline._route is None) == (not jax_pallas)
    for i, (updates, telem) in zip(range(0, wideband.size, w), per_block):
        assert tf.process_wideband(wideband[i:i + w]) == updates
        assert _telemetry_text(tf.telemetry) == telem
    telem = tf.telemetry
    assert sorted(telem) == list(range(len(PLAN)))
    assert telem[0].serial == "S1234567"
    assert telem[3].lat == pytest.approx(40.0, abs=1e-5)
