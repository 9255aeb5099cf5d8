#!/usr/bin/env python3
"""Smoke run of sondetpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero
before the result line:

1. env: torch/CUDA versions, the card's name and power limit, TF32 off.
2. build: nvcc builds the kernels of sondetpu_torch/csrc.
3. kernels: each CUDA kernel against its plain torch twin on the card, at
   the main path's shapes (2048 channels x 192000 samples), with the
   tolerance stated beside it, and both timed with CUDA events.
4. main_path: the RS41 kernel path through DecoderSession at 2048 channels
   x 4 s blocks: decoded telemetry checked, each kernel's launch count
   read from that run alone; then an 8-channel run with three serials,
   held byte for byte to the same pipeline on the CPU (plain twins).
5. step: steady-state step time, the real-time channels it implies, and
   peak device memory.

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
KERNEL_SOURCES = {
    "fused_frontend": ("sondetpu_torch/csrc/frontend.cu",
                       "sondetpu/pallas/frontend.py:278"),
    "corr": ("sondetpu_torch/csrc/corr.cu", "sondetpu/pallas/corr.py:32"),
    "rs_clean": ("sondetpu_torch/csrc/syndrome.cu",
                 "sondetpu/pallas/syndrome.py:38"),
}


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
    for name, count in launches.items():
        check(count > 0, f"main path: kernel {name} was not launched")
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


def phase_step(torch, pipe, blocks):
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
    emit({"phase": "step", "channels": CHANNELS, "block_seconds": secs,
          "steps": len(times), "step_ms_median": step * 1e3,
          "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
          "realtime_channels": CHANNELS * secs / step,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})


def main() -> int:
    import torch

    smi = phase_env(torch)
    dev = torch.device("cuda", 0)
    phase_build()
    kres = phase_kernels(torch, dev)
    pipe, blocks, launches = phase_main_path(torch, dev)
    phase_distinct(torch, dev)
    phase_step(torch, pipe, blocks)
    check("jax" not in sys.modules, "the port imported jax")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1], "launches": launches[name],
         "max_abs_err": kres[name][0], "ms": kres[name][1],
         "plain_ms": kres[name][2]} for name in KERNEL_SOURCES]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
