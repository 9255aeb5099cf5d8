#!/usr/bin/env python3
"""Smoke run of sondetpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero
before the result line:

1. env: torch/CUDA versions, the card's name and power limit, TF32 off.
2. build: nvcc builds the kernels of sondetpu_torch/csrc.
3. kernels: each CUDA kernel against its plain torch twin on the card, at
   the shapes its path gives it (the RS41 path: 2048 channels x 192000
   samples; the fleet: 2048 PFB bins x 4 s, m10 group 616 x 192000), with
   the tolerance stated beside it, and both timed with CUDA events.
4. main_path: the RS41 kernel path through DecoderSession at 2048 channels
   x 4 s blocks: decoded telemetry checked, each kernel's launch count
   read from that run alone; then an 8-channel run with three serials,
   held byte for byte to the same pipeline on the CPU (plain twins).
5. step: steady-state step time, the real-time channels it implies, and
   peak device memory.
6. pfb_stream: the 2048-bin channelizer fed blocks shorter than its
   history (the pfb_fir_timemajor path) equals one long block.
7. fleet_path: FleetSession.process_wideband at 2048 bins x 4 s (1230
   rs41, 614 m10, 204 dfm channels), 4 blocks with rs41, m10 and dfm
   carriers in bins 1, 6 and 9: their serials decoded, every kernel of the
   path launched.
8. fleet_distinct: a 16-bin fleet with two channels per family, on the
   card and on the CPU (twins): validity, valid frame bytes and telemetry
   equal.
9. fleet_step: the fleet's device step, the real-time channels it implies,
   peak device memory, and process_wideband with readback and host decode.
10. afsk_kernels: the AFSK tone kernel (imet4's win 40 and c50's win 20)
    and the fused front end at decim 1 with an identity matched filter,
    against their twins at 2048 x 192000; the two kernels no path runs
    (the r4 demod+FIR front end at 2048 x 96000, the lane experiment's FIR
    at its four shapes), against theirs; then plain_correlation: the
    dual-tone and AFSK paths' syncword correlation on the card divides by
    L (m10's L = 80, imet4's L = 20), as on the CPU.
11. afsk_path: imet4 (3 blocks) and c50 (2 blocks) through DecoderSession
    at 2048 channels x 4 s: the truth's telemetry on every channel, the
    front end and the AFSK tone kernel launched, the correlator not; then
    each family's steady-state device step (afsk_step).
12. afsk_distinct: 8 channels of each family with four distinct truths, on
    the card and on the CPU (twins): validity, valid frame bytes and
    telemetry equal.

The last lines are the kernel table, the card as nvidia-smi names it, and
{"ok": true, "device": {...}}. Needs one CUDA device and nvcc; no network.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

CHANNELS = 2048
BLOCK_LEN = 192000          # 4 s at 48 kHz
FS = 48000.0
N_BINS = 2048               # PFB bins of the fleet (BENCH_FLEET_r05 shape)
KERNEL_SOURCES = {
    "fused_frontend": ("sondetpu_torch/csrc/frontend.cu",
                       "sondetpu/pallas/frontend.py:278"),
    "corr": ("sondetpu_torch/csrc/corr.cu", "sondetpu/pallas/corr.py:32"),
    "rs_clean": ("sondetpu_torch/csrc/syndrome.cu",
                 "sondetpu/pallas/syndrome.py:38"),
    "pfb_fir_stream": ("sondetpu_torch/csrc/pfb.cu",
                       "sondetpu/pallas/pfb.py:169"),
    "pfb_fir_timemajor": ("sondetpu_torch/csrc/pfb.cu",
                          "sondetpu/pallas/pfb.py:89"),
    "pfb_dft": ("sondetpu_torch/csrc/pfb_dft.cu",
                "sondetpu/pallas/pfb.py:312"),
    "fused_dualtone_frontend": ("sondetpu_torch/csrc/dualtone.cu",
                                "sondetpu/pallas/frontend.py:513"),
    "fused_afsk_frontend": ("sondetpu_torch/csrc/afsk.cu",
                            "sondetpu/pallas/frontend.py:666"),
    "fused_demod_fir": ("sondetpu_torch/csrc/demod_fir.cu",
                        "sondetpu/pallas/frontend.py:75"),
    "lane_fir": ("sondetpu_torch/csrc/lane_fir.cu",
                 "tools/exp_chanfilt.py:51"),
}
# AFSK families: (mark Hz, space Hz, boxcar win = fs / baud)
AFSK_TONES = {"imet4": (1200.0, 2200.0, 40), "c50": (2400.0, 4800.0, 20)}
# carriers of the fleet path: (bin, family, serial the decoder reports)
FLEET_CARRIERS = ((1, "rs41", "S1234567"), (6, "m10", "910-2-12345"),
                  (9, "dfm", "1234567"))


def check(ok, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of fn() in ms over ``reps`` runs, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def rs41_planes(serial: str, n_blocks: int, seed: int):
    """int16 (i, q) planes [n_blocks * BLOCK_LEN] of back-to-back RS41
    frames with complex noise of std 0.1 per component (the JAX package's
    bench signal), quantized to cs16."""
    from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth

    n = n_blocks * BLOCK_LEN
    n_frames = int(np.ceil(n / (FS / 4800.0) / 2560)) + 1
    iq = RS41Modulator().modulate(
        [RS41Truth(serial=serial, frame_no=i) for i in range(n_frames)],
        fs=FS)[:n]
    rng = np.random.default_rng(seed)
    noisy = iq + (rng.normal(size=n) + 1j * rng.normal(size=n)
                  ).astype(np.complex64) * 0.1
    qi = np.clip(noisy.real * 32767, -32768, 32767).astype(np.int16)
    qq = np.clip(noisy.imag * 32767, -32768, 32767).astype(np.int16)
    return qi, qq


def phase_env(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    # the plain twins must not round to TF32 where they are compared
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase_build():
    from sondetpu_torch.kernels import cuda

    t0 = time.perf_counter()
    path = cuda.build()
    cuda.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": cuda.build_seconds,
          "library": os.path.relpath(path), "flags": " ".join(cuda.NVCC_FLAGS)})


def phase_kernels(torch, dev):
    """Each kernel against its twin at the main path's shapes."""
    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels.corr import corr_kernel, corr_plain
    from sondetpu_torch.kernels.frontend import (HALO, fused_frontend,
                                                 fused_frontend_plain)
    from sondetpu_torch.kernels.syndrome import (rs_clean_flags_kernel,
                                                 rs_clean_plain)
    from sondetpu_torch.sondes.rs41 import (SPEC, RS41Modulator, RS41Truth)

    rng = np.random.default_rng(0)
    results = {}

    # K1: the fused front end at decim 2 (the RS41 shape) and decim 1.
    # Tolerance: kernel and twin round the same operations in the same
    # order; only the order of the block-DC sum differs.
    k1_tol = 1e-5
    errs, k1_ms, k1_plain_ms = [], None, None
    for decim, c, n in ((2, CHANNELS, BLOCK_LEN), (1, 256, 48000)):
        i, q = (torch.from_numpy(rng.normal(size=(c, n)).astype(np.float32)
                                 ).to(dev) for _ in range(2))
        ti, tq = (torch.from_numpy(rng.normal(size=(c, HALO)).astype(
            np.float32)).to(dev) for _ in range(2))
        ct = design_lowpass(5000.0, FS, 41)
        mt = design_lowpass(2640.0, FS / decim, 41)
        scale = float(np.float32(FS / decim / (2 * np.pi * 2400.0)))
        got = fused_frontend(i, q, ti, tq, ct, mt, scale, decim, True)
        want = fused_frontend_plain(i, q, ti, tq, ct, mt, scale, decim, True)
        torch.cuda.synchronize()
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[3] - want[3]).abs().max()))
        tails_exact = bool(torch.equal(got[1], want[1])
                           and torch.equal(got[2], want[2]))
        check(tails_exact, "fused_frontend: carried tails differ")
        check(torch.isfinite(got[0]).all(), "fused_frontend: non-finite")
        check(err <= k1_tol, f"fused_frontend decim {decim}: err {err}")
        errs.append(err)
        entry = {"phase": "kernel", "name": "fused_frontend", "decim": decim,
                 "shape": [c, n], "max_abs_err": err, "tol": k1_tol}
        if decim == 2:
            k1_ms = cuda_ms(torch, lambda: fused_frontend(
                i, q, ti, tq, ct, mt, scale, decim, True), 20)
            k1_plain_ms = cuda_ms(torch, lambda: fused_frontend_plain(
                i, q, ti, tq, ct, mt, scale, decim, True), 3)
            entry.update(ms=k1_ms, plain_ms=k1_plain_ms)
        emit(entry)
        del i, q, ti, tq, got, want
    results["fused_frontend"] = (max(errs), k1_ms, k1_plain_ms)

    # K2: the correlator on the RS41 chip ring [2048, 2560 + 19200]
    buf = torch.from_numpy(rng.normal(size=(CHANNELS, 2560 + 19200)).astype(
        np.float32)).to(dev)
    tmpl = torch.from_numpy(SPEC.sync_chip_template()).to(dev)
    got = corr_kernel(buf, tmpl)
    want = corr_plain(buf, tmpl)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    k2_tol = 1e-6   # same operations in the same order: expected 0
    check(err <= k2_tol, f"corr: err {err}")
    ms = cuda_ms(torch, lambda: corr_kernel(buf, tmpl), 50)
    plain_ms = cuda_ms(torch, lambda: corr_plain(buf, tmpl), 5)
    emit({"phase": "kernel", "name": "corr", "shape": list(buf.shape),
          "max_abs_err": err, "tol": k2_tol, "ms": ms, "plain_ms": plain_ms})
    results["corr"] = (err, ms, plain_ms)
    del buf, got, want

    # K3: RS syndrome flags on 2048 x 9 frame rows, clean and corrupted
    mod = RS41Modulator()
    base = np.stack([mod.build_frame(RS41Truth(frame_no=k))
                     for k in range(64)])
    rows = CHANNELS * 9
    frames = base[rng.integers(0, 64, size=rows)]
    bad = rng.random(rows) < 0.5
    for r in np.nonzero(bad)[0]:
        pos = rng.choice(np.arange(8, 320), size=rng.integers(1, 4),
                         replace=False)
        frames[r, pos] ^= rng.integers(1, 256, size=pos.size).astype(np.uint8)
    fr = torch.from_numpy(frames).to(dev).reshape(CHANNELS, 9, 320)
    layout = SPEC.extra["rs"]
    got = rs_clean_flags_kernel(fr, layout)
    want = rs_clean_plain(fr, layout)
    torch.cuda.synchronize()
    truth = torch.from_numpy(~bad).to(dev).reshape(CHANNELS, 9)
    mismatches = int((got != want).sum())
    check(mismatches == 0, f"rs_clean: {mismatches} rows differ from twin")
    check(torch.equal(got, truth), "rs_clean: verdicts differ from truth")
    ms = cuda_ms(torch, lambda: rs_clean_flags_kernel(fr, layout), 50)
    plain_ms = cuda_ms(torch, lambda: rs_clean_plain(fr, layout), 5)
    emit({"phase": "kernel", "name": "rs_clean", "rows": rows,
          "clean_rows": int((~bad).sum()), "max_abs_err": 0.0, "tol": 0,
          "ms": ms, "plain_ms": plain_ms})
    results["rs_clean"] = (0.0, ms, plain_ms)
    return results


def phase_main_path(torch, dev):
    """The RS41 kernel path at 2048 channels through DecoderSession."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    n_blocks = 4
    cfg = PipelineConfig(sonde="rs41", channels=CHANNELS, block_len=BLOCK_LEN,
                         use_pallas=True, compute_dtype="f32",
                         input_dtype="i16")
    qi, qq = rs41_planes("S1234567", n_blocks, seed=0)
    row_i = torch.from_numpy(qi).to(dev)
    row_q = torch.from_numpy(qq).to(dev)
    blocks = [(row_i[None, b * BLOCK_LEN:(b + 1) * BLOCK_LEN]
               .expand(CHANNELS, -1).contiguous(),
               row_q[None, b * BLOCK_LEN:(b + 1) * BLOCK_LEN]
               .expand(CHANNELS, -1).contiguous()) for b in range(n_blocks)]
    pipe = Pipeline(cfg, dev)
    sess = DecoderSession(cfg, dev, pipeline=pipe)
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    for planes in blocks:
        sess.process_block(planes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.launches)
    m = sess.metrics
    check(m.frames_decoded > 0, "main path: no frames decoded")
    check(m.frames_decoded % CHANNELS == 0,
          f"main path: {m.frames_decoded} decoded frames do not split evenly "
          "over identical channels")
    check(sorted(sess.telemetry) == list(range(CHANNELS)),
          "main path: channels without telemetry")
    ref = sess.telemetry[0].to_dict()
    check(ref.get("serial") == "S1234567", f"main path: telemetry {ref}")
    # compared as JSON text: NaN fields (uncalibrated PTU) compare equal
    ref_text = json.dumps(ref, sort_keys=True)
    check(all(json.dumps(sess.telemetry[ch].to_dict(), sort_keys=True)
              == ref_text for ch in range(CHANNELS)),
          "main path: telemetry differs between identical channels")
    for name in ("fused_frontend", "corr", "rs_clean"):
        check(launches[name] > 0, f"main path: kernel {name} was not "
              "launched")
    emit({"phase": "main_path", "channels": CHANNELS, "block_len": BLOCK_LEN,
          "blocks": n_blocks, "frames_raw": m.frames_raw,
          "frames_decoded": m.frames_decoded,
          "frames_per_channel": m.frames_decoded // CHANNELS,
          "serial": ref.get("serial"), "lat": ref.get("lat"),
          "lon": ref.get("lon"), "alt": ref.get("alt"),
          "launches": launches, "wall_seconds_first_blocks": wall})
    return pipe, blocks, launches


def phase_distinct(torch, dev):
    """8 channels, three serials: the card's run equals the CPU run of the
    same pipeline (plain twins) byte for byte, and each channel decodes
    its own serial."""
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    serials = ["S1234567", "T7654321", "R0420042"]
    c, n_blocks = 8, 3
    sig = [rs41_planes(s, n_blocks, seed=k + 1) for k, s in enumerate(serials)]
    qi = np.stack([sig[ch % 3][0] for ch in range(c)])
    qq = np.stack([sig[ch % 3][1] for ch in range(c)])
    cfg = PipelineConfig(sonde="rs41", channels=c, block_len=BLOCK_LEN,
                         use_pallas=True, compute_dtype="f32",
                         input_dtype="i16")
    gpu, cpu = Pipeline(cfg, dev), Pipeline(cfg, "cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    sess = DecoderSession(cfg, dev, pipeline=gpu)
    frames = 0
    for b in range(n_blocks):
        sl = slice(b * BLOCK_LEN, (b + 1) * BLOCK_LEN)
        sg, og = gpu.step(sg, (qi[:, sl], qq[:, sl]))
        sc, oc = cpu.step(sc, (qi[:, sl], qq[:, sl]))
        vg, vc = og.frame_valid.cpu(), oc.frame_valid
        check(torch.equal(vg, vc), f"block {b}: validity differs from CPU")
        check(torch.equal(og.frames.cpu()[vg], oc.frames[vc]),
              f"block {b}: frame bytes differ from CPU")
        check(torch.equal(og.rs_clean.cpu(), oc.rs_clean),
              f"block {b}: RS verdicts differ from CPU")
        frames += int(vg.sum())
        sess.process_block((qi[:, sl], qq[:, sl]))
    for ch in range(c):
        got = sess.telemetry.get(ch)
        check(got is not None and got.serial == serials[ch % 3],
              f"channel {ch}: telemetry {got}")
    emit({"phase": "distinct_serials", "channels": c, "blocks": n_blocks,
          "valid_frames": frames, "frames_decoded": sess.metrics.frames_decoded,
          "serials": serials, "matches_cpu": True})


def phase_step(torch, pipe, blocks, phase: str = "step"):
    """Steady-state step time at 2048 channels x 4 s."""
    torch.cuda.reset_peak_memory_stats()
    state = pipe.init_state()
    for planes in blocks[:2]:                   # warm-up
        state, out = pipe.step(state, planes)
    torch.cuda.synchronize()
    times = []
    for k in range(12):
        t0 = time.perf_counter()
        state, out = pipe.step(state, blocks[k % len(blocks)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step = statistics.median(times)
    secs = BLOCK_LEN / FS
    emit({"phase": phase, "sonde": pipe.config.sonde,
          "channels": CHANNELS, "block_seconds": secs,
          "steps": len(times), "step_ms_median": step * 1e3,
          "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
          "realtime_channels": CHANNELS * secs / step,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})


def fleet_family(k: int) -> str:
    """bench.py's fleet channel map: ~60% rs41, ~30% m10, the rest dfm."""
    return "rs41" if k % 10 < 6 else ("m10" if k % 10 < 9 else "dfm")


def narrowband(family: str, serial: str, n: int, fs: float) -> np.ndarray:
    """complex64 [n] at rate fs: back-to-back frames of ``family`` from the
    port's modulator, carrying ``serial``."""
    from sondetpu_torch.sondes.dfm import DFMModulator, DFMTruth
    from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
    from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth

    if family == "rs41":
        k = int(np.ceil(n / (fs / 4800.0) / 2560)) + 1
        iq = RS41Modulator().modulate(
            [RS41Truth(serial=serial, frame_no=i) for i in range(k)], fs=fs)
    elif family == "m10":
        k = int(np.ceil(n / (fs / 9600.0) / 1648)) + 1
        iq = M10Modulator().modulate(
            [M10Truth(serial=serial, frame_no=8 + i) for i in range(k)], fs=fs)
    else:
        k = int(np.ceil(n / (fs / 2500.0) / 560)) + 1
        iq = DFMModulator().modulate(
            [DFMTruth(serial_num=int(serial), frame_no=2 + i)
             for i in range(k)], fs=fs)
    return iq[:n]


def fleet_blocks(torch, dev, n_blocks: int, seed: int, n_bins: int = N_BINS,
                 block_len: int = BLOCK_LEN):
    """Wideband (i, q) planes [n_bins * block_len] float32 on ``dev``, one
    block at a time: complex noise of std 0.05 per component plus the
    FLEET_CARRIERS, each modulated at 48 kHz by the port's modulator and
    placed as bench.py places its RS41 carrier (zero-order hold x n_bins,
    then a phase ramp to its bin: row r, column j of the block gets
    a[r] * exp(2*pi*i*k*j/n_bins))."""
    n = n_blocks * block_len
    carriers = []
    for k, family, serial in FLEET_CARRIERS:
        iq = narrowband(family, serial, n, FS)
        a = torch.from_numpy(np.stack([iq.real, iq.imag]).astype(
            np.float32)).to(dev)
        ang = 2.0 * np.pi * k * np.arange(n_bins) / n_bins
        ph = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)]).astype(
            np.float32)).to(dev)
        carriers.append((a, ph))
    gen = torch.Generator(device=dev).manual_seed(seed)
    for b in range(n_blocks):
        sl = slice(b * block_len, (b + 1) * block_len)
        wi = 0.05 * torch.randn((block_len, n_bins), generator=gen, device=dev)
        wq = 0.05 * torch.randn((block_len, n_bins), generator=gen, device=dev)
        for a, ph in carriers:
            ar, ai = a[0, sl, None], a[1, sl, None]
            wi += ar * ph[0] - ai * ph[1]
            wq += ar * ph[1] + ai * ph[0]
        yield wi.reshape(-1), wq.reshape(-1)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 when both are all zero)."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale else 0.0


def phase_fleet_kernels(torch, dev):
    """The PFB and dual-tone kernels against their twins at the fleet's
    shapes."""
    from sondetpu_torch.dsp.channelizer import PFBChannelizer
    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels.dualtone import (fused_dualtone_frontend,
                                                 fused_dualtone_plain,
                                                 mixer_tables)
    from sondetpu_torch.kernels.frontend import HALO
    from sondetpu_torch.kernels.pfb import (TPP, pfb_dft, pfb_dft_plain,
                                            pfb_fir_plain, pfb_fir_stream,
                                            pfb_fir_timemajor)

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    results = {}
    hcol = PFBChannelizer(N_BINS, dev)._hcol_t
    m = BLOCK_LEN

    # K4: same products and sums in the same order as the twin: expected 0
    fir_tol = 1e-6
    x_i, x_q, t_i, t_q = randn(m, N_BINS), randn(m, N_BINS), \
        randn(8, N_BINS), randn(8, N_BINS)
    got = pfb_fir_stream(x_i, x_q, t_i, t_q, hcol)
    want = pfb_fir_plain(torch.cat([t_i, x_i]), torch.cat([t_q, x_q]), hcol)
    torch.cuda.synchronize()
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[1] - want[1]).abs().max()))
    check(err <= fir_tol, f"pfb_fir_stream: err {err}")
    del got, want
    ms = cuda_ms(torch, lambda: pfb_fir_stream(x_i, x_q, t_i, t_q, hcol), 20)
    plain_ms = cuda_ms(torch, lambda: pfb_fir_plain(
        torch.cat([t_i, x_i]), torch.cat([t_q, x_q]), hcol), 3)
    emit({"phase": "kernel", "name": "pfb_fir_stream", "shape": [m, N_BINS],
          "max_abs_err": err, "tol": fir_tol, "ms": ms, "plain_ms": plain_ms})
    results["pfb_fir_stream"] = (err, ms, plain_ms)

    # K5: a short block (m = 4) and the full block, pre-concatenated
    errs = []
    for rows in (4, m):
        vv_i = torch.cat([t_i, x_i[:rows]])
        vv_q = torch.cat([t_q, x_q[:rows]])
        got = pfb_fir_timemajor(vv_i, vv_q, hcol)
        want = pfb_fir_plain(vv_i, vv_q, hcol)
        torch.cuda.synchronize()
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
        check(err <= fir_tol, f"pfb_fir_timemajor m={rows}: err {err}")
        errs.append(err)
        del got, want
        entry = {"phase": "kernel", "name": "pfb_fir_timemajor",
                 "shape": [TPP + rows, N_BINS], "max_abs_err": err,
                 "tol": fir_tol}
        if rows == m:
            ms = cuda_ms(torch, lambda: pfb_fir_timemajor(vv_i, vv_q, hcol),
                         20)
            plain_ms = cuda_ms(torch, lambda: pfb_fir_plain(vv_i, vv_q, hcol),
                               3)
            entry.update(ms=ms, plain_ms=plain_ms)
        emit(entry)
        del vv_i, vv_q
    results["pfb_fir_timemajor"] = (max(errs), ms, plain_ms)
    del x_i, x_q, t_i, t_q
    torch.cuda.empty_cache()

    # K6: radix-2 FFT in f32 against torch.fft (cuFFT), both f32: the
    # error is relative to max |y|
    dft_tol = 1e-4
    errs = []
    for rows, nb in ((m, N_BINS), (4096, 16)):
        u_i, u_q = randn(rows, nb), randn(rows, nb)
        got = pfb_dft(u_i, u_q)
        want = pfb_dft_plain(u_i, u_q)
        torch.cuda.synchronize()
        rel = max(rel_err(got[0], want[0]), rel_err(got[1], want[1]))
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
        check(rel <= dft_tol, f"pfb_dft N={nb}: err {rel} of max|y|")
        errs.append(err)
        del got, want
        entry = {"phase": "kernel", "name": "pfb_dft", "shape": [rows, nb],
                 "max_abs_err": err, "max_err_over_max_abs_y": rel,
                 "tol_over_max_abs_y": dft_tol}
        if nb == N_BINS:
            ms = cuda_ms(torch, lambda: pfb_dft(u_i, u_q), 20)
            plain_ms = cuda_ms(torch, lambda: pfb_dft_plain(u_i, u_q), 5)
            entry.update(ms=ms, plain_ms=plain_ms)
        emit(entry)
        del u_i, u_q
    results["pfb_dft"] = (max(errs), ms, plain_ms)
    torch.cuda.empty_cache()

    # K7: the m10 group's shape (chanfilt skipped, nb 5) and a 256-channel
    # block with the chanfilt and the AFC sums. Metric: same operations in
    # the same order (expected 0); dc and rotation sums differ only in the
    # order of summation, so they are held relative to their largest value
    met_tol, sum_tol = 1e-6, 1e-5
    taps = design_lowpass(0.45 * FS, FS, 41)
    errs = []
    for c, n, skip, afc in ((616, m, True, False), (256, 48000, False, True)):
        args = (randn(c, n), randn(c, n), randn(c, HALO), randn(c, HALO))
        tabs = tuple(torch.from_numpy(t).to(dev)
                     for t in mixer_tables(n, 12000.0 / FS))
        got = fused_dualtone_frontend(*args, taps, *tabs, 5, afc, skip)
        want = fused_dualtone_plain(*args, taps, *tabs, 5, afc, skip)
        torch.cuda.synchronize()
        err = float((got[0] - want[0]).abs().max())
        sums_err = max(rel_err(got[k], want[k]) for k in (3, 4, 5))
        check(err <= met_tol, f"dualtone {c}x{n}: metric err {err}")
        check(sums_err <= sum_tol, f"dualtone {c}x{n}: sums err {sums_err}")
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              "dualtone: carried tails differ")
        errs.append(err)
        del got, want
        entry = {"phase": "kernel", "name": "fused_dualtone_frontend",
                 "shape": [c, n], "skip_chanfilt": skip, "want_afc": afc,
                 "max_abs_err": err, "tol": met_tol,
                 "sums_rel_err": sums_err, "sums_tol": sum_tol}
        if c == 616:
            ms = cuda_ms(torch, lambda: fused_dualtone_frontend(
                *args, taps, *tabs, 5, afc, skip), 20)
            plain_ms = cuda_ms(torch, lambda: fused_dualtone_plain(
                *args, taps, *tabs, 5, afc, skip), 3)
            entry.update(ms=ms, plain_ms=plain_ms)
            k7 = (ms, plain_ms)
        emit(entry)
        del args, tabs
    results["fused_dualtone_frontend"] = (max(errs), *k7)
    torch.cuda.empty_cache()
    return results


def phase_pfb_stream(torch, dev):
    """The 2048-bin channelizer over blocks shorter than its history
    (pfb_fir_timemajor, the tail carried through a concatenation) equals
    one call on the whole stream (pfb_fir_stream): the same arithmetic, so
    the outputs must be equal exactly."""
    from sondetpu_torch.dsp.channelizer import PFBChannelizer
    from sondetpu_torch.kernels import cuda

    pfb = PFBChannelizer(N_BINS, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    short, n_short = 4 * N_BINS, 6              # 4 rows < tpp = 8
    x_i, x_q = (torch.randn(short * n_short, generator=gen, device=dev)
                for _ in range(2))
    torch.cuda.synchronize()
    cuda.reset_launches()
    st = pfb.init_state()
    ys_i, ys_q = [], []
    for b in range(n_short):
        st, y_i, y_q = pfb(st, x_i[b * short:(b + 1) * short],
                           x_q[b * short:(b + 1) * short])
        ys_i.append(y_i)
        ys_q.append(y_q)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    _, w_i, w_q = pfb(pfb.init_state(), x_i, x_q)
    same = (torch.equal(torch.cat(ys_i, dim=1), w_i)
            and torch.equal(torch.cat(ys_q, dim=1), w_q))
    check(same, "pfb_stream: short blocks differ from one long block")
    check(launches["pfb_fir_timemajor"] == n_short,
          f"pfb_stream: pfb_fir_timemajor launched "
          f"{launches['pfb_fir_timemajor']} times")
    emit({"phase": "pfb_stream", "bins": N_BINS, "block_samples": short,
          "blocks": n_short, "equal_to_one_block": same,
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


def phase_fleet_path(torch, dev, n_bins: int = N_BINS,
                     block_len: int = BLOCK_LEN, n_blocks: int = 4):
    """FleetSession.process_wideband at n_bins x block_len, pipelined, f32,
    every group on the kernel path."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession

    chans = [FleetChannel(pfb_bin=k, sonde=fleet_family(k))
             for k in range(n_bins)]
    fleet = FleetSession(chans, n_bins, dev, fs_chan=FS, block_len=block_len,
                         pipelined=True)
    groups = {s: [len(idxs), sess.config.channels]
              for s, (idxs, sess) in fleet.groups.items()}
    blocks = fleet_blocks(torch, dev, n_blocks, seed=3, n_bins=n_bins,
                          block_len=block_len)
    last = None
    times, updates = [], 0
    torch.cuda.synchronize()
    cuda.reset_launches()
    for wi, wq in blocks:
        t0 = time.perf_counter()
        updates += fleet.process_wideband((wi, wq))
        times.append(time.perf_counter() - t0)
        last = (wi, wq)
    updates += fleet.flush()
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    telem = fleet.telemetry
    for k, family, serial in FLEET_CARRIERS:
        got = telem.get(k)
        check(got is not None and got.serial == serial,
              f"fleet_path: channel {k} ({family}) telemetry {got}")
    for name in ("fused_frontend", "corr", "rs_clean", "pfb_fir_stream",
                 "pfb_dft", "fused_dualtone_frontend"):
        check(launches[name] > 0, f"fleet_path: kernel {name} was not "
              "launched")
    emit({"phase": "fleet_path", "bins": n_bins, "block_len": block_len,
          "blocks": n_blocks, "groups": groups, "updates": updates,
          "channels_with_telemetry": len(telem),
          "carriers": {str(k): {f: telem[k].to_dict()[f] for f in
                                ("serial", "lat", "lon", "alt")}
                       for k, _, _ in FLEET_CARRIERS},
          "process_wideband_seconds": times, "launches": launches})
    return fleet, last, launches


def phase_fleet_distinct(torch, dev, n_bins: int = 16, n_blocks: int = 3):
    """A 16-bin fleet, two channels per family with their own serials and
    noise, built at the wideband rate: the card equals the CPU (twins)."""
    from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
    from sondetpu_torch.runtime.pipeline import unpack_block_output
    from sondetpu_torch.sondes.modulate import freq_shift

    plan = ((1, "rs41", "S1234567"), (3, "rs41", "T7654321"),
            (5, "m10", "910-2-12345"), (9, "m10", "A05-3-54321"),
            (12, "dfm", "1234567"), (14, "dfm", "7654321"))
    fs_wide = n_bins * FS
    w = n_bins * int(FS)
    n = n_blocks * w
    wide = np.zeros(n, np.complex64)
    for i, (k, family, serial) in enumerate(plan):
        center = (k if k < n_bins / 2 else k - n_bins) * FS
        iq = freq_shift(narrowband(family, serial, n, fs_wide),
                        center / fs_wide)
        rng = np.random.default_rng(10 + i)
        wide += iq + (0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
                      ).astype(np.complex64)
    chans = [FleetChannel(pfb_bin=k, sonde=f) for k, f, _ in plan]
    gpu = FleetSession(chans, n_bins, dev, fs_chan=FS, block_len=int(FS))
    cpu = FleetSession(chans, n_bins, "cpu", fs_chan=FS, block_len=int(FS))
    valid, weak_same, weak_total = {}, 0, 0
    for b in range(n_blocks):
        x = wide[b * w:(b + 1) * w]
        wi = torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
        wq = torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
        pg, fg = gpu.step(wi.to(dev), wq.to(dev))
        pc, fc = cpu.step(wi, wq)
        hg, hc = pg.cpu().numpy(), pc.numpy()
        off = 0
        for (sonde, _, sess), frg, frc in zip(gpu._order, fg, fc):
            cfg = sess.config
            nbytes = cfg.channels * cfg.packed_row_bytes
            ug, uc = (unpack_block_output(h[off:off + nbytes], cfg.k_slots,
                                          cfg.wire_ncols, cfg.chase_total)
                      for h in (hg, hc))
            off += nbytes
            v = uc[1]
            check(np.array_equal(ug[1], v),
                  f"fleet_distinct block {b} {sonde}: validity differs")
            check(torch.equal(frg.cpu()[torch.from_numpy(v)],
                              frc[torch.from_numpy(v)]),
                  f"fleet_distinct block {b} {sonde}: frame bytes differ")
            valid[sonde] = valid.get(sonde, 0) + int(v.sum())
            if cfg.chase_m:
                for ch, k in zip(*np.nonzero(v)):
                    weak_total += 1
                    weak_same += set(ug[4][ch, k]) == set(uc[4][ch, k])
        gpu._consume((pg, fg))
        cpu._consume((pc, fc))
    tg, tc = gpu.telemetry, cpu.telemetry
    for i, (k, family, serial) in enumerate(plan):
        check(i in tg and tg[i].serial == serial,
              f"fleet_distinct: channel {i} ({family}) telemetry "
              f"{tg.get(i)}")
        check(json.dumps(tg[i].to_dict(), sort_keys=True)
              == json.dumps(tc[i].to_dict(), sort_keys=True),
              f"fleet_distinct: channel {i} telemetry differs from the CPU")
    check(all(valid.get(f, 0) > 0 for f in ("rs41", "m10", "dfm")),
          f"fleet_distinct: valid frames per group {valid}")
    emit({"phase": "fleet_distinct", "bins": n_bins, "blocks": n_blocks,
          "valid_frames": valid, "matches_cpu": True,
          "serials": [s for _, _, s in plan],
          "m10_weak_sets_equal": [weak_same, weak_total]})


def phase_fleet_step(torch, fleet, wi, wq):
    """The fleet's device step and its session reading at the path's
    shape."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):                          # warm-up
        fleet.step(wi, wq)
    torch.cuda.synchronize()
    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        fleet.step(wi, wq)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    wall = []
    for _ in range(6):
        t0 = time.perf_counter()
        fleet.process_wideband((wi, wq))
        wall.append(time.perf_counter() - t0)
    fleet.flush()
    step = statistics.median(times)
    secs = fleet.block_len / FS
    emit({"phase": "fleet_step", "bins": fleet.n_bins, "block_seconds": secs,
          "steps": len(times), "step_ms_median": step * 1e3,
          "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
          "realtime_channels": fleet.n_bins * secs / step,
          "max_memory_allocated_bytes": peak,
          "process_wideband_ms_median": statistics.median(wall) * 1e3,
          "process_wideband_ms": [t * 1e3 for t in wall]})


def afsk_planes(family: str, n: int, seed: int, noise: float = 0.04,
                k: int = 0):
    """int16 (i, q) planes [n] of back-to-back ``family`` frames from the
    port's modulator (truth set ``k``: imet4 lat 40 + k, temp -58 + k; c50
    serial 12345 + k, lat 46.8 + k), with complex noise of std ``noise``
    per component, quantized to cs16."""
    from sondetpu_torch.sondes.c50 import C50Modulator, C50Truth
    from sondetpu_torch.sondes.imet4 import IMET4Modulator, IMET4Truth

    if family == "imet4":
        count = n // 20800 + 2                  # 20800 samples per truth
        iq = IMET4Modulator().modulate(
            [IMET4Truth(frame_no=1 + i, lat=40.0 + k, temp=-58.0 + k)
             for i in range(count)], fs=FS)
    else:
        count = n // 10080 + 2                  # 10080 samples per truth
        iq = C50Modulator().modulate(
            [C50Truth(serial_num=12345 + k, frame_no=1 + i, lat=46.8 + k)
             for i in range(count)], fs=FS)
    iq = iq[:n]
    rng = np.random.default_rng(seed)
    noisy = iq + (rng.normal(size=n) + 1j * rng.normal(size=n)
                  ).astype(np.complex64) * noise
    qi = np.clip(noisy.real * 32767, -32768, 32767).astype(np.int16)
    qq = np.clip(noisy.imag * 32767, -32768, 32767).astype(np.int16)
    return qi, qq


def phase_afsk_kernels(torch, dev):
    """K8 for both AFSK families and K1 at decim 1 with the identity
    matched filter, against their twins at the AFSK path's shape."""
    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels.afsk import (afsk_tables, fused_afsk_frontend,
                                             fused_afsk_frontend_plain)
    from sondetpu_torch.kernels.frontend import (HALO, fused_frontend,
                                                 fused_frontend_plain)

    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    c, n = CHANNELS, BLOCK_LEN
    results = {}
    # K8: the same operations in the same order as the twin: expected 0
    k8_tol = 1e-6
    audio, atail = randn(c, n), randn(c, HALO)
    k8 = {}
    for family, (fm, fsp, win) in AFSK_TONES.items():
        tabs = [torch.from_numpy(t).to(dev)
                for t in afsk_tables(n, fm / FS, fsp / FS)]
        got = fused_afsk_frontend(audio, atail, tabs, win)
        want = fused_afsk_frontend_plain(audio, atail, tabs, win)
        torch.cuda.synchronize()
        err = float((got[0] - want[0]).abs().max())
        check(torch.isfinite(got[0]).all(), "afsk: non-finite soft")
        check(err <= k8_tol, f"afsk {family}: err {err}")
        check(torch.equal(got[1], want[1]), "afsk: carried tail differs")
        del got, want
        ms = cuda_ms(torch, lambda: fused_afsk_frontend(audio, atail, tabs,
                                                        win), 20)
        plain_ms = cuda_ms(torch, lambda: fused_afsk_frontend_plain(
            audio, atail, tabs, win), 3)
        emit({"phase": "kernel", "name": "fused_afsk_frontend",
              "family": family, "win": win, "shape": [c, n],
              "max_abs_err": err, "tol": k8_tol, "tail_exact": True,
              "ms": ms, "plain_ms": plain_ms})
        k8[family] = (err, ms, plain_ms)
    results["fused_afsk_frontend"] = (
        max(e for e, _, _ in k8.values()), k8["imet4"][1], k8["imet4"][2])
    results["fused_afsk_frontend_c50"] = k8["c50"]
    del audio, atail
    torch.cuda.empty_cache()

    # K1 at decim 1 with the identity matched filter: only the order of
    # the block-DC sum differs from the twin
    k1_tol = 1e-5
    i, q, ti, tq = randn(c, n), randn(c, n), randn(c, HALO), randn(c, HALO)
    ct = design_lowpass(10000.0, FS, 41)
    delta = np.zeros(41, np.float32)
    delta[-1] = 1.0
    scale = float(np.float32(FS / (2 * np.pi * 3000.0)))
    got = fused_frontend(i, q, ti, tq, ct, delta, scale, 1, True)
    want = fused_frontend_plain(i, q, ti, tq, ct, delta, scale, 1, True)
    torch.cuda.synchronize()
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[3] - want[3]).abs().max()))
    check(err <= k1_tol, f"fused_frontend decim 1 identity: err {err}")
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          "fused_frontend decim 1: carried tails differ")
    del got, want
    ms = cuda_ms(torch, lambda: fused_frontend(i, q, ti, tq, ct, delta,
                                               scale, 1, True), 20)
    plain_ms = cuda_ms(torch, lambda: fused_frontend_plain(
        i, q, ti, tq, ct, delta, scale, 1, True), 3)
    emit({"phase": "kernel", "name": "fused_frontend", "decim": 1,
          "matched_taps": "identity", "shape": [c, n], "max_abs_err": err,
          "tol": k1_tol, "ms": ms, "plain_ms": plain_ms})
    results["fused_frontend_decim1"] = (err, ms, plain_ms)
    del i, q, ti, tq
    torch.cuda.empty_cache()
    return results


def phase_unpathed_kernels(torch, dev):
    """K9 and K10, which no pipeline path runs, against their twins; their
    launch counts come from this phase."""
    from sondetpu_torch.dsp.fir import conv1d, design_lowpass
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.frontend import (fused_demod_fir,
                                                 fused_demod_fir_plain)
    from sondetpu_torch.kernels.lane_fir import lane_fir, lane_fir_plain

    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    torch.cuda.synchronize()
    cuda.reset_launches()
    results = {}
    # K9 at RS41's processing-rate shape. Tolerance: kernel and twin round
    # the discriminator and the FIR alike; the block-mean DC is summed in
    # another order than torch.mean, which moves outputs of magnitude ~10
    # by a few ulp
    k9_tol = 2e-5
    c, n = CHANNELS, BLOCK_LEN // 2
    i, q = randn(c, n), randn(c, n)
    prev, atail = randn(c, 2), randn(c, 40)
    taps = design_lowpass(2640.0, FS / 2, 41)
    scale = float(np.float32(FS / 2 / (2 * np.pi * 2400.0)))
    got = fused_demod_fir(i, q, prev, atail, taps, scale, True)
    want = fused_demod_fir_plain(i, q, prev, atail, taps, scale, True)
    torch.cuda.synchronize()
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[1] - want[1]).abs().max()))
    check(torch.isfinite(got[0]).all(), "demod_fir: non-finite")
    check(err <= k9_tol, f"demod_fir: err {err}")
    del got, want
    ms = cuda_ms(torch, lambda: fused_demod_fir(i, q, prev, atail, taps,
                                                scale, True), 20)
    plain_ms = cuda_ms(torch, lambda: fused_demod_fir_plain(
        i, q, prev, atail, taps, scale, True), 3)
    emit({"phase": "kernel", "name": "fused_demod_fir", "shape": [c, n],
          "max_abs_err": err, "tol": k9_tol, "ms": ms, "plain_ms": plain_ms})
    results["fused_demod_fir"] = (err, ms, plain_ms)
    del i, q, prev, atail
    torch.cuda.empty_cache()

    # K10 at the experiment's shapes: the same operations in the same order
    # as the twin, so exact
    h = design_lowpass(0.1, 1.0, 41)
    for c, n in ((306, 96000), (102, 96000), (616, 96000), (CHANNELS,
                                                              BLOCK_LEN)):
        x = randn(c, n + 40)
        got, want = lane_fir(x, h), lane_fir_plain(x, h)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err == 0.0, f"lane_fir [{c}, {n}]: err {err}")
        entry = {"phase": "kernel", "name": "lane_fir", "shape": [c, n],
                 "max_abs_err": err, "tol": 0}
        del got, want
        if c == CHANNELS:
            ms = cuda_ms(torch, lambda: lane_fir(x, h), 20)
            plain_ms = cuda_ms(torch, lambda: lane_fir_plain(x, h), 3)
            conv_ms = cuda_ms(torch, lambda: conv1d(x, h), 3)
            entry.update(ms=ms, plain_ms=plain_ms, conv1d_ms=conv_ms)
            results["lane_fir"] = (err, ms, plain_ms)
        emit(entry)
        del x
    torch.cuda.synchronize()
    launches = {k: cuda.launches[k] for k in ("fused_demod_fir", "lane_fir")}
    torch.cuda.empty_cache()
    return results, launches


def phase_plain_correlation(torch, dev):
    """The plain syncword correlation (the dual-tone and AFSK paths') on the
    card divides by L: on +/-1 chips every window sum s is an exact integer,
    so each output must be float32(s / L) correctly rounded, not
    s * float32(1/L). m10's template (L = 80) over one 4 s block of its
    chips, imet4's three (L = 20) over one of theirs, at 2048 channels; the
    first 64 rows also equal the CPU."""
    from sondetpu_torch.dsp.fir import conv1d
    from sondetpu_torch.sondes import imet4, m10
    from sondetpu_torch.sync.correlator import correlate_syncword

    gen = torch.Generator(device=dev).manual_seed(6)
    templates = [("m10", m10.SPEC.sync_chip_template(), 38400)]
    templates += [(f"imet4-{k}", t, 4800) for k, t in enumerate(
        [imet4.SPEC.sync_chip_template()]
        + [imet4.SPEC.sync_chip_template(bits=np.asarray(b))
           for b in imet4.SPEC.extra["alt_sync_bits"]])]
    out = {}
    for name, tmpl, n_chips in templates:
        L = len(tmpl)
        chips = (torch.randint(0, 2, (CHANNELS, n_chips + L - 1),
                               generator=gen, device=dev) * 2 - 1).float()
        got = correlate_syncword(chips, tmpl)
        sums = conv1d(chips, tmpl)
        # float64 division rounded once more to float32 is the correctly
        # rounded float32 quotient (53 >= 2 * 24 + 2 bits)
        want = (sums.double() / L).float()
        bad = int((got != want).sum())
        check(bad == 0, f"plain correlation {name}: {bad} outputs are not "
              f"s / {L} correctly rounded")
        cpu = correlate_syncword(chips[:64].cpu(), tmpl)
        check(torch.equal(got[:64].cpu(), cpu),
              f"plain correlation {name}: the card differs from the CPU")
        recip = int((sums * float(np.float32(1.0 / L)) != want).sum())
        out[name] = {"L": L, "shape": list(chips.shape),
                     "outputs_where_reciprocal_differs": recip}
        del chips, got, sums, want
    # at 2048 channels each L = 20 buffer holds ~190 window sums of +/-18
    check(all(v["outputs_where_reciprocal_differs"] > 0 for v in out.values()),
          f"plain correlation: a check cannot tell the two roundings apart "
          f"({out})")
    emit({"phase": "plain_correlation", "templates": out,
          "divides_by_l": True})


def phase_afsk_path(torch, dev, family: str, n_blocks: int):
    """One AFSK family through DecoderSession at 2048 channels x 4 s, the
    same signal on every channel."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    cfg = PipelineConfig(sonde=family, channels=CHANNELS,
                         block_len=BLOCK_LEN, use_pallas=True,
                         compute_dtype="f32", input_dtype="i16")
    qi, qq = afsk_planes(family, n_blocks * BLOCK_LEN, seed=7)
    row_i = torch.from_numpy(qi).to(dev)
    row_q = torch.from_numpy(qq).to(dev)
    blocks = [(row_i[None, b * BLOCK_LEN:(b + 1) * BLOCK_LEN]
               .expand(CHANNELS, -1).contiguous(),
               row_q[None, b * BLOCK_LEN:(b + 1) * BLOCK_LEN]
               .expand(CHANNELS, -1).contiguous()) for b in range(n_blocks)]
    pipe = Pipeline(cfg, dev)
    sess = DecoderSession(cfg, dev, pipeline=pipe)
    torch.cuda.synchronize()
    cuda.reset_launches()
    block_seconds = []
    for planes in blocks:
        t0 = time.perf_counter()
        sess.process_block(planes)
        block_seconds.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    m = sess.metrics
    check(m.frames_decoded > 0, f"{family} path: no frames decoded")
    check(m.frames_decoded % CHANNELS == 0,
          f"{family} path: {m.frames_decoded} decoded frames do not split "
          "evenly over identical channels")
    check(sorted(sess.telemetry) == list(range(CHANNELS)),
          f"{family} path: channels without telemetry")
    t = sess.telemetry[0]
    ref = t.to_dict()
    ref_text = json.dumps(ref, sort_keys=True)
    check(all(json.dumps(sess.telemetry[ch].to_dict(), sort_keys=True)
              == ref_text for ch in range(CHANNELS)),
          f"{family} path: telemetry differs between identical channels")
    if family == "imet4":
        o3 = (float(t.aux_data[3:-3]) if t.aux_data.startswith("O3=")
              and t.aux_data.endswith("mPa") else None)
        check(t.serial == "" and abs(t.lat - 40.0) <= 1e-5
              and abs(t.alt - 22000.0) <= 0.5 and abs(t.temp + 58.0) <= 0.01
              and o3 is not None and abs(o3 - 3.2) <= 0.05,
              f"imet4 path: telemetry {ref}")
    else:
        check(t.serial == "C50-12345" and abs(t.lat - 46.8) <= 1e-5
              and abs(t.temp + 15.0) <= 0.02, f"c50 path: telemetry {ref}")
    for name in ("fused_frontend", "fused_afsk_frontend"):
        check(launches[name] > 0, f"{family} path: kernel {name} was not "
              "launched")
    check(launches["corr"] == 0, f"{family} path: the correlator kernel ran "
          "(the AFSK path correlates with the plain correlation)")
    emit({"phase": "afsk_path", "sonde": family, "channels": CHANNELS,
          "block_len": BLOCK_LEN, "blocks": n_blocks,
          "k_slots": cfg.k_slots, "frames_raw": m.frames_raw,
          "frames_decoded": m.frames_decoded,
          "frames_per_channel": m.frames_decoded // CHANNELS,
          "telemetry": {f: ref.get(f) for f in
                        ("serial", "lat", "lon", "alt", "temp", "aux_data")},
          "process_block_seconds": block_seconds,
          "launches": {k: v for k, v in launches.items() if v}})
    return pipe, blocks, launches


def phase_afsk_distinct(torch, dev, n_blocks: int = 3):
    """Per family, 8 channels carrying four distinct truths: the card
    equals the CPU (twins) on validity, valid frame bytes and telemetry,
    and each channel reports its own truth."""
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    c = 8
    out = {}
    for family in AFSK_TONES:
        sig = [afsk_planes(family, n_blocks * BLOCK_LEN, seed=20 + k, k=k)
               for k in range(4)]
        qi = np.stack([sig[ch % 4][0] for ch in range(c)])
        qq = np.stack([sig[ch % 4][1] for ch in range(c)])
        cfg = PipelineConfig(sonde=family, channels=c, block_len=BLOCK_LEN,
                             use_pallas=True, compute_dtype="f32",
                             input_dtype="i16")
        gpu, cpu = Pipeline(cfg, dev), Pipeline(cfg, "cpu")
        sg, sc = gpu.init_state(), cpu.init_state()
        gsess = DecoderSession(cfg, dev, pipeline=gpu)
        csess = DecoderSession(cfg, "cpu", pipeline=cpu)
        frames = 0
        for b in range(n_blocks):
            sl = slice(b * BLOCK_LEN, (b + 1) * BLOCK_LEN)
            sg, og = gpu.step(sg, (qi[:, sl], qq[:, sl]))
            sc, oc = cpu.step(sc, (qi[:, sl], qq[:, sl]))
            vg, vc = og.frame_valid.cpu(), oc.frame_valid
            check(torch.equal(vg, vc),
                  f"{family} block {b}: validity differs from CPU")
            check(torch.equal(og.frames.cpu()[vg], oc.frames[vc]),
                  f"{family} block {b}: frame bytes differ from CPU")
            frames += int(vg.sum())
            gsess.process_block((qi[:, sl], qq[:, sl]))
            csess.process_block((qi[:, sl], qq[:, sl]))
        for ch in range(c):
            tg, tc = gsess.telemetry.get(ch), csess.telemetry.get(ch)
            check(tg is not None and tc is not None
                  and json.dumps(tg.to_dict(), sort_keys=True)
                  == json.dumps(tc.to_dict(), sort_keys=True),
                  f"{family} channel {ch}: telemetry differs from the CPU")
            k = ch % 4
            if family == "imet4":
                check(abs(tg.lat - (40.0 + k)) <= 1e-5,
                      f"imet4 channel {ch}: telemetry {tg.to_dict()}")
            else:
                check(tg.serial == f"C50-{12345 + k}",
                      f"c50 channel {ch}: telemetry {tg.to_dict()}")
        out[family] = {"valid_frames": frames,
                       "frames_decoded": gsess.metrics.frames_decoded}
    emit({"phase": "afsk_distinct", "channels": c, "blocks": n_blocks,
          "families": out, "matches_cpu": True})


def main() -> int:
    import torch

    smi = phase_env(torch)
    dev = torch.device("cuda", 0)
    phase_build()
    kres = phase_kernels(torch, dev)
    kres.update(phase_fleet_kernels(torch, dev))
    kres.update(phase_afsk_kernels(torch, dev))
    phase_plain_correlation(torch, dev)
    unpathed, unpathed_launches = phase_unpathed_kernels(torch, dev)
    kres.update(unpathed)
    pipe, blocks, rs41_launches = phase_main_path(torch, dev)
    phase_distinct(torch, dev)
    phase_step(torch, pipe, blocks)
    del pipe, blocks
    torch.cuda.empty_cache()
    # each kernel's launches come from the run of the path that drives it
    launches = {k: rs41_launches[k] for k in ("corr", "rs_clean")}
    launches["pfb_fir_timemajor"] = phase_pfb_stream(
        torch, dev)["pfb_fir_timemajor"]
    fleet, (wi, wq), fleet_launches = phase_fleet_path(torch, dev)
    for k in ("pfb_fir_stream", "pfb_dft", "fused_dualtone_frontend"):
        launches[k] = fleet_launches[k]
    phase_fleet_distinct(torch, dev)
    phase_fleet_step(torch, fleet, wi, wq)
    del fleet, wi, wq
    torch.cuda.empty_cache()

    afsk_launches = {}
    for family, n_blocks in (("imet4", 3), ("c50", 2)):
        pipe, blocks, afsk_launches[family] = phase_afsk_path(
            torch, dev, family, n_blocks)
        phase_step(torch, pipe, blocks, phase="afsk_step")
        del pipe, blocks
        torch.cuda.empty_cache()
    phase_afsk_distinct(torch, dev)
    # K1 and K8 as launched by the imet4 path's own run; K9 and K10 have no
    # pipeline path, so theirs come from the kernels phase
    for k in ("fused_frontend", "fused_afsk_frontend"):
        launches[k] = afsk_launches["imet4"][k]
    launches.update(unpathed_launches)
    launches_from = {k: "imet4 afsk_path" for k in ("fused_frontend",
                                                   "fused_afsk_frontend")}
    launches_from.update({k: "rs41 main_path" for k in ("corr", "rs_clean")})
    launches_from.update({k: "fleet_path" for k in (
        "pfb_fir_stream", "pfb_dft", "fused_dualtone_frontend")})
    launches_from["pfb_fir_timemajor"] = "pfb_stream"
    launches_from.update({k: "kernels phase (no pipeline path)"
                          for k in unpathed_launches})
    check("jax" not in sys.modules, "the port imported jax")
    table = []
    for name in KERNEL_SOURCES:
        check(launches[name] > 0, f"kernel {name}: no launches")
        table.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
            "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
            "launches_from": launches_from[name],
            "max_abs_err": kres[name][0], "ms": kres[name][1],
            "plain_ms": kres[name][2]})
    table[0].update(
        launches_by_path={"rs41": rs41_launches["fused_frontend"],
                          "fleet": fleet_launches["fused_frontend"],
                          "imet4": afsk_launches["imet4"]["fused_frontend"],
                          "c50": afsk_launches["c50"]["fused_frontend"]},
        decim1_identity_ms=kres["fused_frontend_decim1"][1],
        decim1_identity_plain_ms=kres["fused_frontend_decim1"][2],
        decim1_identity_max_abs_err=kres["fused_frontend_decim1"][0])
    k8 = next(e for e in table if e["name"] == "fused_afsk_frontend")
    k8.update(c50_launches=afsk_launches["c50"]["fused_afsk_frontend"],
              win20_ms=kres["fused_afsk_frontend_c50"][1],
              win20_plain_ms=kres["fused_afsk_frontend_c50"][2])
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
