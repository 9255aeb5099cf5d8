#!/usr/bin/env python3
"""Smoke run of sondetpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # env, build and step profiles only
    python3 chip_smoke.py --tune       # env, build, K2/K7/K10/K9 per R, K3 per F
    python3 chip_smoke.py --plain-fir  # env, build, the plain filter, plain steps
    python3 chip_smoke.py --profile-pfb  # env, build, the PFB's bodies split
    python3 chip_smoke.py --profile-k7   # env, build, K7's chanfilt split
    python3 chip_smoke.py --profile-k1 [VARIANT ...]  # K1's bodies split
    python3 chip_smoke.py --dualtone-steps DIR ...  # ims100/mrzn1 steps
    python3 chip_smoke.py --m10-steps DIR ...  # m10's bf16 fallback steps

Phases, each printing one JSON line; any failure raises and exits non-zero
before the result line:

1. env: torch/CUDA versions, the card's name and power limit, TF32 off.
2. build: nvcc builds the kernels of sondetpu_torch/csrc, and the host's
   C++ compiler the port's native FEC.
3. kernels: each CUDA kernel against its plain torch twin on the card, at
   the shapes its path gives it (the RS41 path: 2048 channels x 192000
   samples; the fleet: 2048 PFB bins x 4 s, m10 group 616 x 192000; the
   AFSK paths and ims100's K7 with its channel filter: 2048 x 192000),
   with the tolerance stated beside it, timed
   with CUDA events around runs of back-to-back launches beside its twin,
   its bound (bytes or operations, from this run's shapes) and, where one
   PyTorch call computes the same function, that call. The fused front end
   runs every body: decim 2 and 1, lowpass and identity matched taps, 41
   taps and a run-time count, and edge shapes, each bit-equal to its twin
   before the block DC. The correlator runs every body (sign and
   separately rounded templates at L 64, 32 and a run-time length, the
   long-template body, edge shapes) and the dual-tone front end every body
   (compiled nb 5 and run-time nb without the channel filter; with it, 41
   taps and nb 20 compiled in and both at run time; AFC, channel counts
   that are not a multiple of its eight rows, misaligned planes), each
   equal to its twin. The
   RS syndrome flag runs both bodies (384 and 512 columns) on RS41's 320-
   and rs41x's 518-byte frames (both timed), one row, row counts that are
   not a multiple of a block's frames, frames off 4-byte alignment and a
   61-byte layout, equal to its twin and to the truth. The two kernels no
   path runs are held to theirs too: the r4 demod+FIR front end (two
   launches) at RS41's processing-rate shape, 33 taps (the run-time body),
   a block no tile divides, one row and a block of T - 1 samples, each
   with the DC (within 2e-5) and without it (bit-equal), two runs
   bit-equal, timed whole and launch by launch beside its bound and the
   two-pass floor; the lane experiment's FIR in both bodies and on edge
   shapes. plain_correlation holds the plain correlation kernel (K10's
   second entry, every route's correlation but the fused front end's) to
   the plain formula bit for bit in each body, float32 and bfloat16, timed
   at m10's fleet ring, and checks that it divides by L. plain_fir holds
   the plain-op front end's filter (K10's third entry, apply_windows on
   the card) to window_sum bit for bit in each body, float32 and
   bfloat16, timed at the RS41 plain step's two filter shapes.
4. main_path: the RS41 kernel path through DecoderSession at 2048 channels
   x 4 s blocks: decoded telemetry checked, each kernel's and body's
   launch count read from that run alone; then an 8-channel run with three
   serials, held byte for byte to the same pipeline on the CPU (plain
   twins) and its telemetry to the CPU session's.
5. step: steady-state step time, the real-time channels it implies, and
   peak device memory.
6. rs41x_path: the same path on rs41x's 518-byte extended frames with an
   ozone reading (2 blocks): serial and ozone aux on every channel, K3's
   launches read from that run alone; then rs41x_distinct, 8 channels with
   three serials and readings, card against CPU as in 4.
6b. plain_path: the plain-op RS41 step (use_pallas=False, bench.py's
    default shape; the JAX bench's default in bf16) through DecoderSession
    at 2048 channels x 4 s, 3 blocks in bf16 and in f32: serial S1234567
    and the same telemetry on every channel, no hand kernel launched but
    the plain correlation once a step and the plain filter three times (the
    two channel-filter planes, the matched filter), the chip ring in the
    compute dtype; each with its steady step (plain_step)
    beside the card's name and power limit. Then plain_distinct, 8 channels
    of RS41 with three serials in bf16, card against CPU as in 4; one
    rs41x block in bf16 at 2048 channels; and 8 channels of dfm (three
    serials, its rational sps) in bf16, card against CPU.
7. pfb_stream: the 2048-bin channelizer fed blocks shorter than its
   history (the pfb_fir_timemajor path) equals one long block.
8. fleet_path: FleetSession.process_wideband at 2048 bins x 4 s (1230
   rs41, 614 m10, 204 dfm channels), 4 blocks with rs41, m10 and dfm
   carriers in bins 1, 6 and 9: their serials decoded, every kernel of the
   path launched (m10's plain correlation twice a step, L 80 and 64).
9. fleet_distinct: a 16-bin fleet with two channels per family, on the
   card and on the CPU (twins): validity, valid frame bytes and telemetry
   equal.
10. fleet_step: the fleet's device step, the real-time channels it
    implies, peak device memory, and process_wideband with readback and
    host decode.
11. afsk_path: imet4 (3 blocks) and c50 (2 blocks) through DecoderSession
    at 2048 channels x 4 s: the truth's telemetry on every channel, the
    front end's identity body, the AFSK tone kernel and the plain
    correlation (imet4's three templates, c50's one) launched, the
    correlator not; then each family's steady-state device step
    (afsk_step).
12. afsk_distinct: 8 channels of each family with four distinct truths, on
    the card and on the CPU (twins): validity, valid frame bytes and
    telemetry equal.
13. session_workers, ddc_afc_path, fleet_offgrid, afc_drift: the RS41
    session with 0 and 8 host workers; RS41 at 2048 channels off the
    centre with fine_offsets and afc; a 16-bin off-grid fleet with afc
    against the CPU; the AFC cases of tests/test_afc.py on 64 channels.
14. ims100_path (3 blocks) and mrzn1_path (2 blocks): the kernel path at
    2048 channels x 4 s, one signal from the family's modulator on every
    channel (noise std 0.04): the truth's serial and telemetry on every
    channel, K7's chanfilt_t41_nb20 body and the plain correlation once a
    step and no other kernel; then the
    steady step (ims100_step, mrzn1_step), the midpoint DC alone on one
    block's metric and peak device memory.
15. dualtone_distinct: ims100 and mrzn1, 8 channels with four truths, with
    and without afc, card against CPU (twins): validity, valid frame bytes
    and telemetry equal.
16. plain_dualtone: m10, ims100 and mrzn1 on the plain-op step
    (use_pallas=False) in f32 and bf16, 8 channels with four truths, card
    against CPU, no hand kernel but the plain correlation and the plain
    filter; then the
    2048-channel m10 bf16 plain step
    (plain_dualtone_step) and its peak memory.
17. bf16 kernels (in the kernel phase): every K1 and K7 body on bfloat16
    planes and tails, bit-equal to the float32 body on the widened input,
    K1's four walking bodies also on kernels/frontend.py:WALK_EDGE_CASES
    (every row start offset mod 16, misaligned planes, one channel, blocks
    shorter than a tile and of a tile and one sample, walks of 3 and 8);
    K4 and K5 in bf16 equal to their twin run in bfloat16 as int16 bit
    patterns, at the fleet's shape and on the edge-value planes of
    sondetpu_torch/kernels/pfb_cases.py (ties, subnormals, overflow near bfloat16's
    largest value, signed zeros) and an odd N at a ragged m; K6 on
    bfloat16 u within one bfloat16 step at max|y| plus 1e-4 of max|y| of
    the float32 FFT, at the full block, at m that no 16-row cluster tile
    divides (1003, 5, 9) and on misaligned planes; K1 (decim 1 lowpass,
    decim 1 identity, decim 2, each beside its float32 body's time), K7
    (skip_nb5, chanfilt_t41_nb20, and the run-time chanfilt
    body at ims100's shape) and K4-K6 timed in bf16 beside their
    bound at the bytes they move (K4/K5's library call: a bf16 depthwise
    F.conv1d).
18. pfb_stream (bf16) and fleet_path_bf16: the 2048-bin fleet in bf16
    (bench.py's fleet default, use_pallas left at None: every group on its
    kernel route), 3 blocks: the carriers decode, the PFB's and K7's bf16
    bodies once a step; fleet_bf16_step; then a 16-bin bf16 fleet with
    rs41, m10, imet4, c50 and dfm carriers, card against CPU.
19. plain_afsk_path: imet4 and c50 on the jnp AFSK front end
    (use_pallas=False, the JAX CLI's default, f32) at 2048 channels x 4 s,
    2 blocks: the truth on every channel, no hand kernel but the plain
    correlation and the plain filter; plain_afsk_step;
    plain_afsk_distinct, 8 channels with four truths, card against CPU.
20. ims100_bf16 and m10_fallback_bf16: ims100 on K7's
    chanfilt_t41_nb20_bf16 body,
    and m10's FM fallback (a block of 4 s + 5 samples) on K1's
    decim1_t41_bf16 body with K2 on the widened bfloat16 ring, at 2048
    channels, i16, use_pallas=True, bf16: the truth on every channel and
    only those bodies (and ims100's plain correlation); each one's bf16
    and f32 steps in turns and peaks.
21. gates: use_pallas=True where the original's gates send the config to
    its jnp path (rs41 at 12 channels, m10 at 200-sample blocks: no hand
    kernel but the plain correlation) or to K7 with linear_interp (ims100 at 48.1 kHz), card against
    CPU block by block and in telemetry.
22. cli_full_width: the port's command line (sondetpu_torch.cli.main, in
    this process) decodes a cs16 file of one rs41 channel tiled to 2048
    rows (bench.py's shape, device dequant, 3 blocks of 4 s) at its
    default (the plain-op step in f32, no kernel but the plain
    correlation) and with use_pallas (K1,
    K2, K3 once a block): S1234567 on every channel; each run's session
    rate and the shares of its wall time in the host's file read and tile
    and in the JSONL sink, beside DecoderSession.process_block's session
    rate on the same host planes.
23. cli_wideband: decode --wideband --bins 2048 of a cs16 capture (2 blocks
    of 1 s, fleet_blocks' carriers in bins 1, 6 and 9 and an rs41 carrier
    3150 Hz off bin 12) with bench.py's channel map and use_pallas, from
    the file and with --stream (the native reader): every carrier decoded,
    the JSONL of both equal, K4, K6, K7, K1, K2, K3 and m10's plain
    correlation launched; then
    cli_checkpoint_fleet: block 1 with --checkpoint, block 2 with --resume,
    the JSONL of the uninterrupted run.
24. cli_narrowband: each of the eight families on one channel, card against
    CPU (JSONL, GPX and PTU byte-equal), and on the card --stream against
    the file, --rate 50000 against the same frames at 48 kHz (JSONL
    equal), a cs8 file
    with device dequant (card against CPU), --sonde auto, --afc with the
    carrier off by 3 kHz (1 kHz for ims100, mrzn1; card against CPU), and
    --channels 8 with use_pallas (card against CPU, kernels launched, the
    plain correlation once a template a step on m10's, ims100's, mrzn1's,
    imet4's and c50's routes).
25. cli_checkpoint: an rs41 session of 64 channels in f32 and in bf16 (no
    ml_dtypes loaded) saved after block 1 by --checkpoint and resumed by
    --resume equals the uninterrupted run; the JAX package's checkpoint in
    tests/data, restored on the card and run on, equals the JAX run.
26. fer: the port's fer_sweep on the card against the CPU at the seed and
    frame counts of tests/test_torch_fer.py, every family on the plain path
    (one channel) and the kernel path (8 channels): decoded-unit sets and
    points equal, but imet4's packet 124 in the kernel path's clean run,
    a last-ulp tie that the card and the JAX package's kernels break one
    way and the CPU twins the other (FER_TIE; phase_fer says why).

27. scan (inside cli_wideband, on its capture, which is bandlimited:
    wide_blocks' polyphase interpolator in noise of std 1, where
    fleet_blocks' zero-order hold leaves an image of each carrier in the
    bins beside it): ``scan --fs-wide`` at its defaults finds the four
    carriers once each and classifies each as its family in its bin (K4
    and K6 once a probe block, no other kernel but the probe sessions'
    plain correlation).
28. autofleet: AutoFleet at 2048 bins x 1-s blocks (the original's
    defaults, rescan_blocks 3, probe_blocks 2, drop_idle_blocks 2), 8
    blocks made one at a time on the card: carriers present from block 0,
    one 3150 Hz off bin 12, one launched at 3 s and one stopped at 2.5 s;
    the tracked list and each serial, the stopped carrier dropped, K4 and
    K6 once a fleet step and once a probe block, no other kernel but the
    plain correlation; each block's wall and each
    rescan's PSD ms, classification s and rebuild s.
29. autofleet_cpu: ``decode --wideband --bins 16 --auto``, card against
    CPU (JSONL equal) at the default and with use_pallas and --afc (K1-K3,
    K7, K8 in the groups); the JAX package's AutoFleet checkpoint
    (tests/data) run on on the card to the JAX continuation.
30. fleet_unfused: a 16-bin fleet, fused=False against the fused step on
    the card, block by block (updates, telemetry, launches equal).
31. mesh_session: RS41 at 2048 channels x 4 s (cs16, the kernel route in
    f32) on a 4-way mesh on the one card (sondetpu_torch.parallel): the
    sharded step's packed buffer torch.equal to the unsharded step's, the
    mesh session's telemetry to the unsharded session's, K1-K3 four times
    a step; step and block times sharded and unsharded in turns; the
    plain-op bf16 step at 64 channels on an 8-way mesh against the CPU.
32. mesh_fleet: the fused mesh fleet at 2048 bins x 1 s with bench.py's
    map on a 2-way mesh, 56 channels on their kernel routes on a 4-way
    mesh (K1-K3, K7), each against the unsharded fused fleet, and 16 rs41
    + 1 m10 (an _mp_local group) on an 8-way mesh against the CPU.
33. mesh_processes: two processes in a gloo group on the one card
    (tests/torch_mp_worker.py): each decodes only its own channels, sees
    every channel through the fan-in, equal summed metrics, no per-block
    host upload in the fleet; RS41 at 2048 channels x 4 s, 1024 a
    process; the fan-in's time per call.
34. time_parallel: time_parallel_fir and time_parallel_frontend at
    [2048, 192000] on a 4-way mesh against the serial chain on the card
    and the CPU.
35. dryrun_multichip(4, cuda:0).
36. library: the public DSP, timing, coding and physics API
    (sondetpu_torch.dsp, .sync, .physics) on the card at the sizes users
    run: fir_filter, fir_apply, polyphase_decimate, agc_apply,
    afsk_discriminate at [2048, 192000], fm_demod and fm_apply on
    complex64 at that shape, rational_resample 48 -> 50 kHz on 1024 rows
    (a 7.37 GB gather), symbol_sample at [2048, 96000] sps 5, gardner_scan
    at [2048, 24000] with 4800 symbols, the coding functions on [2048,
    2560] bits and the physics on 1e6 values: each against the port's CPU
    result on its first rows within tests/test_torch_library.py's limits
    (exact for the coding functions and symbol_sample's valid), fir_apply
    and fm_apply over 4 chunks torch.equal to the unchunked call, each
    timed by CUDA events; no hand kernel launched.
37. oracle: python -m sondetpu_torch.bench.oracle --selftest on the card
    and on the CPU (in this process): every family ok, every expected
    frame bit-exact, the card's report equal to the CPU's.
Shards on one card run in turn: the mesh phases' times show the cost of
sharding, never scaling. An NCCL group needs a card per rank.

At the end no module of jax or of the JAX package (sondetpu) may be loaded.
With --profile, ptxas reports the registers of the redesigned kernels'
bodies and torch.profiler reads the device kernels of three steady steps
of the RS41, imet4, c50 and ims100 paths, of the bf16 plain RS41 and m10
steps and of the 2048-bin fleet instead (no result line). With --tune, K2,
K7, K10 and K9
are rebuilt with other outputs per thread (-DSONDETPU_CORR_R,
-DSONDETPU_DUALTONE_R, -DSONDETPU_LANE_FIR_R, -DSONDETPU_DEMOD_FIR_R) and
K3 with other frames per warp (-DSONDETPU_RS_CLEAN_F), and timed at the
paths' shapes (no result line). With --profile-pfb, the PFB's bodies (K4
in bf16 and f32, K6's n2048 body in bf16 and f32) are rebuilt with
-DSONDETPU_PFB_PROFILE bits that leave out their arithmetic, loads or
stores, and timed at [192000, 2048] beside torch.fft.fft (no result line).
With --profile-k7, K7 is rebuilt with -DSONDETPU_DUALTONE_PROFILE bits that
leave out its channel filter, its mix and boxcars or its stores, and its
channel-filter bodies are timed at ims100's shape (no result line). With
--profile-k1 [VARIANT ...], K1 is rebuilt with -DSONDETPU_FRONTEND_PROFILE
bits that leave out its channel filter, discriminator, matched FIR, stores
of filt or (walking bodies) the wait for or the staging of a tile, and its
compiled bodies are timed at [2048, 192000], as the path calls them and
without the DC pass, and the walking body at other walks (no result
line). With --dualtone-steps DIR ..., the ims100 and mrzn1 kernel-path
steps are timed for each checkout named, in that order, each in a process
of its own, and with --m10-steps DIR ... m10's FM fallback steps in bf16
and f32 (no result line).
The last lines are the kernel table (each kernel's launches from its
path's run, per step on each path, in each command-line run, on the
scan, AutoFleet and unfused-fleet paths and on the mesh paths; K4's and K5's library column is
a depthwise F.conv1d), the card
as nvidia-smi names it,
and {"ok": true, "device": {...}}. Needs one CUDA device, nvcc and a C++
compiler; no network.
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
# the card's peaks for the bound of each kernel (NVIDIA's H100 SXM data
# sheet): device memory, and FP32 outside the tensor cores at 67 TFLOP/s,
# which counts an FMA as two; the kernels round every product and sum on its
# own, so each is one operation at half that rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
# 32-bit integer logic (LOP3): 64 a clock per SM, 132 SMs at the 1.98 GHz
# boost clock (NVIDIA's H100 SXM data sheet and CUDA's throughput table)
INT_LOGIC_OPS_PER_S = 64 * 132 * 1.98e9
# the FM discriminator per output: 4 products and 2 sums, fast_atan2's
# division, 5 polynomial steps of a product and a sum, 4 more, the scale
DISC_OPS = 23
K1_DC_TOL = 1e-5   # K1's block DC is summed in another order than the twin's
K9_TOL = 2e-5      # K9's block mean is too, on outputs of magnitude ~10
# AFSK families: (mark Hz, space Hz, boxcar win = fs / baud)
AFSK_TONES = {"imet4": (1200.0, 2200.0, 40), "c50": (2400.0, 4800.0, 20)}
# the ozone reading of the rs41x path's extended frames, mPa
RS41X_O3 = 2.25
# K3's layouts beside RS41's: (frame bytes, RS layout). 61 bytes (not a
# multiple of 4) with one 8-root codeword, 64 columns; 267 bytes with two
# interleaved 32-root codewords, 512 columns (the c512 body)
EDGE_LAYOUTS = {
    "odd61": (61, {"data_start": 9, "parity_start": 1, "nroots": 8,
                   "interleave": 1, "fcr": 0, "prim": 0x11D}),
    "c512": (267, {"data_start": 66, "parity_start": 2, "nroots": 32,
                   "interleave": 2, "fcr": 0, "prim": 0x11D}),
}
# carriers of the fleet path: (bin, family, serial the decoder reports)
FLEET_CARRIERS = ((1, "rs41", "S1234567"), (6, "m10", "910-2-12345"),
                  (9, "dfm", "1234567"))
# the DDC path's 16 carrier offsets, Hz, channel ch carrying ch % 16: off
# any grid, over +/-8 kHz (the RS41 channel filter passes 5 kHz), and how
# far the AFC-tracked frequency may end from its offset
DDC_OFFSETS = tuple(float(f) for f in np.linspace(-7950.0, 7950.0, 16))
DDC_AFC_HZ = 50.0
# carriers of the off-grid fleet: (family, serial, centre Hz) at 48 kHz bins
OFFGRID_CARRIERS = (("rs41", "S1234567", 1 * FS + 3150.0),
                    ("m10", "910-2-12345", 5 * FS - 1420.0),
                    ("dfm", "1234567", -4 * FS + 4275.0))
# the tracked frequency, card against CPU: K1's block DC and K7's rotation
# sums are summed in another order than their twins (within 1e-5), which
# moves the loop by ~beta * dev * 1e-5 a block; CUDA's cosf and sinf are
# 2 ulp against the CPU's 1
FLEET_AFC_HZ = 0.25


def check(ok, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def plain_route_bodies(cfg, steps: int) -> dict:
    """The launches by body in ``steps`` steps of a pipeline of ``cfg`` of
    the two kernels that stand in for plain ops. The plain correlation: one
    a template a step (the syncword, then its alternates, as ``Pipeline``
    lists them), of the body its length names, on every route but the
    fused front end's, which correlates with K2. On the plain-op route the
    plain filter too, one a filter a step: the channel filter's two planes
    (unless the dual-tone gate skips it), then the matched filter, the
    dual-tone boxcar over its four planes or the AFSK boxcar's four."""
    from sondetpu_torch.kernels.lane_fir import plain_corr_body, plain_fir_body
    from sondetpu_torch.runtime.pipeline import (_afsk_params,
                                                 _dualtone_gates, _route)

    route = _route(cfg)
    if route == "fused":
        return {}
    spec = cfg.spec
    lengths = [len(spec.sync_chip_template())]
    if spec.extra.get("alt_syncword"):
        lengths.append(len(spec.sync_chip_template(
            spec.extra["alt_syncword"])))
    lengths += [len(spec.sync_chip_template(bits=np.asarray(b)))
                for b in spec.extra.get("alt_sync_bits", ())]
    out = {}

    def add(key, n):
        out[key] = out.get(key, 0) + n * steps

    for length in lengths:
        add("plain_corr:" + plain_corr_body(length), 1)
    if route is None:
        if not _dualtone_gates(cfg)[1]:
            add("plain_fir:" + plain_fir_body(cfg.ntaps, cfg.decim), 2)
        if spec.modulation == "afsk":
            add("plain_fir:" + plain_fir_body(_afsk_params(cfg)[0], 1), 4)
        else:
            add("plain_fir:" + plain_fir_body(cfg.ntaps, 1), 1)
    return out


def kernel_launches(bodies: dict) -> dict:
    """Launches by kernel of launches by "kernel:body"."""
    out = {}
    for key, n in bodies.items():
        kernel = key.split(":")[0]
        out[kernel] = out.get(kernel, 0) + n
    return out


def plain_kernels_only(launches, cfg, steps: int) -> bool:
    """True when the plain correlation and the plain filter are the only
    hand kernels in ``launches``, as often as :func:`plain_route_bodies`
    says."""
    return ({k: v for k, v in launches.items() if v}
            == kernel_launches(plain_route_bodies(cfg, steps)))


def cuda_ms(torch, fn, reps: int) -> float:
    """Device time of one fn() in ms: ``reps`` runs after one warm-up run,
    in up to 5 rounds of back-to-back runs between two CUDA events, each
    round behind one more run that keeps the card busy while the host
    queues the first timed one; the median of the rounds' means. Back to
    back, the host enqueues the next run while the card executes this one,
    so a kernel of a fraction of a millisecond is not timed with its
    wrapper's host work."""
    fn()
    torch.cuda.synchronize()
    rounds = min(reps, 5)
    per = max(1, reps // rounds)
    times = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        fn()
        s.record()
        for _ in range(per):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per)
    return statistics.median(times)


def rs41_planes(serial: str, n_blocks: int, seed: int, o3_mpa=None):
    """int16 (i, q) planes [n_blocks * BLOCK_LEN] of back-to-back RS41
    frames with complex noise of std 0.1 per component (the JAX package's
    bench signal), quantized to cs16. With ``o3_mpa`` the frames are
    rs41x's 518-byte extended frames carrying that ozone reading."""
    from sondetpu_torch.sondes.rs41 import (RS41Modulator, RS41Truth,
                                            RS41XModulator)

    n = n_blocks * BLOCK_LEN
    ext = o3_mpa is not None
    bits = 518 * 8 if ext else 2560
    n_frames = int(np.ceil(n / (FS / 4800.0) / bits)) + 1
    iq = (RS41XModulator() if ext else RS41Modulator()).modulate(
        [RS41Truth(serial=serial, frame_no=i, o3_mpa=o3_mpa)
         for i in range(n_frames)], fs=FS)[:n]
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
    """nvcc builds the kernels; the host's C++ compiler the port's native
    FEC."""
    from sondetpu_torch.fec import native
    from sondetpu_torch.kernels import cuda

    t0 = time.perf_counter()
    path = cuda.build()
    cuda.library()
    t1 = time.perf_counter()
    fec_path = native.build()
    check(native.available(), "the port's native FEC does not load")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": cuda.build_seconds,
          "library": os.path.relpath(path), "flags": " ".join(cuda.NVCC_FLAGS),
          "fec_library": os.path.relpath(fec_path),
          "fec_seconds": time.perf_counter() - t1})


def bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes the function must move (each input read once, each output written
    once) over device memory's rate and its operations over the FP32 rate
    for single-rounded operations."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bound_bytes": nbytes, "bound_ops": nops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def frontend_inputs(torch, dev, gen, c, n, decim, ntaps, identity):
    """K1's arguments: seeded planes and tails on the card, a lowpass
    channel filter of ntaps, and matched taps that are the exact delay
    [0, ..., 0, 1] (the AFSK path's) or a lowpass (RS41's)."""
    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels.frontend import HALO

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    ct = design_lowpass(5000.0, FS, ntaps)
    if identity:
        mt = np.zeros(ntaps, np.float32)
        mt[-1] = 1.0
    else:
        mt = design_lowpass(2640.0, FS / decim, ntaps)
    scale = float(np.float32(FS / decim / (2 * np.pi * 2400.0)))
    return (randn(c, n), randn(c, n), randn(c, HALO), randn(c, HALO), ct, mt,
            scale, decim)


def frontend_bound(args):
    """K1 as the path calls it (dc_block on): per output the channel filter
    (2 planes x T products and sums), the discriminator, the matched FIR
    unless its taps are the delay, the DC sum and its subtraction."""
    from sondetpu_torch.kernels.frontend import is_delay_taps

    i, q, ti, tq, ct, mt, _, decim = args
    c, n = i.shape
    T = len(ct)
    outs = c * (n // decim)
    per = 4 * T + DISC_OPS + (0 if is_delay_taps(mt) else 2 * T) + 2
    return bound(nbytes(i, q) + 2 * nbytes(ti, tq) + 4 * outs + 4 * c,
                 outs * per)


def check_frontend(torch, args, label: str):
    """K1 before the block DC is bit-equal to its twin (dc_block off), the
    DC within K1_DC_TOL, the carried tails equal, and the body the host
    picks is the one launched. Returns the DC error."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.frontend import (frontend_body,
                                                 fused_frontend,
                                                 fused_frontend_plain,
                                                 is_delay_taps)

    *planes, ct, mt, scale, decim = args
    cuda.reset_launches()
    got = fused_frontend(*planes, ct, mt, scale, decim, False)
    want = fused_frontend_plain(*planes, ct, mt, scale, decim, False)
    torch.cuda.synchronize()
    body = "fused_frontend:" + frontend_body(decim, len(ct),
                                             is_delay_taps(mt))
    check(cuda.body_launches == {body: 1},
          f"fused_frontend {label}: bodies {cuda.body_launches}, "
          f"expected {body}")
    check(torch.isfinite(got[0]).all(), f"fused_frontend {label}: non-finite")
    check(torch.equal(got[0], want[0]),
          f"fused_frontend {label}: not bit-equal to its twin before the DC "
          f"(max err {float((got[0] - want[0]).abs().max())})")
    dc_err = float((got[3] - want[3]).abs().max())
    check(dc_err <= K1_DC_TOL, f"fused_frontend {label}: dc err {dc_err}")
    check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
          f"fused_frontend {label}: carried tails differ")
    return dc_err, body


def phase_frontend(torch, dev):
    """K1 in every body against its twin: the RS41 shape (decim 2) and the
    AFSK shape (decim 1, identity matched taps), both timed; decim 1 with a
    lowpass; the run-time-T body (T = 33); and edge shapes (one channel,
    blocks that are not a multiple of the tile)."""
    from sondetpu_torch.kernels.frontend import (fused_frontend,
                                                 fused_frontend_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = (  # label, channels, samples, decim, taps, identity, timed
        ("rs41", CHANNELS, BLOCK_LEN, 2, 41, False, True),
        ("afsk", CHANNELS, BLOCK_LEN, 1, 41, True, True),
        ("decim1-lowpass", CHANNELS, BLOCK_LEN, 1, 41, False, True),
        ("decim2-identity", 8, 48006, 2, 41, True, False),
        ("runtime-t33", 256, 48000, 2, 33, False, False),
        ("runtime-t33-decim1", 256, 48000, 1, 33, False, False),
        ("runtime-t33-identity", 256, 48000, 1, 33, True, False),
        ("runtime-t33-decim2-identity", 8, 48000, 2, 33, True, False),
        ("edge-c1-decim2", 1, 48006, 2, 41, False, False),
        ("edge-c1-identity", 1, 30001, 1, 41, True, False),
        ("edge-c3-decim1", 3, 30001, 1, 41, False, False))
    results, bodies = {}, set()
    for label, c, n, decim, ntaps, ident, timed in cases:
        args = frontend_inputs(torch, dev, gen, c, n, decim, ntaps, ident)
        dc_err, body = check_frontend(torch, args, label)
        bodies.add(body)
        entry = {"phase": "kernel", "name": "fused_frontend", "case": label,
                 "shape": [c, n], "decim": decim, "taps": ntaps,
                 "identity_matched_taps": ident, "body": body,
                 "equal_before_dc": True, "dc_abs_err": dc_err,
                 "dc_tol": K1_DC_TOL}
        if timed:
            # as the path calls it: the block DC subtracted
            got = fused_frontend(*args[:7], decim, True)
            want = fused_frontend_plain(*args[:7], decim, True)
            torch.cuda.synchronize()
            err = max(float((got[0] - want[0]).abs().max()), dc_err)
            check(err <= K1_DC_TOL, f"fused_frontend {label}: err {err}")
            del got, want
            entry.update(
                max_abs_err=err, tol=K1_DC_TOL,
                ms=cuda_ms(torch, lambda: fused_frontend(
                    *args[:7], decim, True), 20),
                plain_ms=cuda_ms(torch, lambda: fused_frontend_plain(
                    *args[:7], decim, True), 3),
                library_ms=None, **frontend_bound(args))
            results[label] = entry
        emit(entry)
        del args
        torch.cuda.empty_cache()
    check(len(bodies) == 8, f"fused_frontend: bodies launched {bodies}")
    results.update(phase_frontend_bf16(torch, dev, gen, cases, results))
    return results


def check_bf16_equals_widened(torch, name, label, body, fn, planes):
    """A kernel on bfloat16 planes and tails gives bit for bit what it gives
    on the same values widened to float32 (every output but the carried
    tails, which are the bfloat16 input), and launches ``body`` for that.
    Returns the bfloat16 outputs."""
    from sondetpu_torch.kernels import cuda

    cuda.reset_launches()
    got = fn(*planes)
    bodies = dict(cuda.body_launches)
    want = fn(*(p.float() for p in planes))
    torch.cuda.synchronize()
    check(bodies == {body: 1}, f"{name} {label} bf16: bodies {bodies}, "
          f"expected {body}")
    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.bfloat16:
            check(torch.equal(g, planes[0][:, -g.shape[1]:]) if k == 1
                  else torch.equal(g, planes[1][:, -g.shape[1]:]),
                  f"{name} {label} bf16: carried tails are not the input")
        else:
            check(torch.equal(g, w), f"{name} {label} bf16: output {k} not "
                  "bit-equal to the float32 body on the widened input")
    return got


def phase_frontend_bf16(torch, dev, gen, cases, f32_results):
    """K1 on bfloat16 planes and tails in every body (the _bf16 bodies):
    bit-equal to the float32 kernel on the widened input, DC included (the
    same sums in the same order); the RS41 shape, the decim-1 lowpass
    shape (m10's FM fallback in bf16, the path that reads bfloat16 into K1)
    and the decim-1 identity shape timed beside their bound at 2 bytes a
    sample and their float32 body's time (``f32_results``); then the four
    walking bodies (41 taps) on WALK_EDGE_CASES (phase_frontend_walk)."""
    from sondetpu_torch.kernels.frontend import (frontend_body,
                                                 fused_frontend,
                                                 fused_frontend_plain,
                                                 is_delay_taps)

    results, bodies = {}, set()
    for label, c, n, decim, ntaps, ident, timed in cases:
        args = frontend_inputs(torch, dev, gen, c, n, decim, ntaps, ident)
        planes = [a.to(torch.bfloat16) for a in args[:4]]
        ct, mt, scale = args[4:7]
        del args
        body = "fused_frontend:" + frontend_body(decim, ntaps,
                                                 is_delay_taps(mt), True)

        def k1(*p, dc=True):
            return fused_frontend(*p, ct, mt, scale, decim, dc)

        check_bf16_equals_widened(torch, "fused_frontend", label, body, k1,
                                  planes)
        bodies.add(body)
        entry = {"phase": "kernel", "name": "fused_frontend", "case": label,
                 "dtype": "bf16", "shape": [c, n], "decim": decim,
                 "taps": ntaps, "body": body,
                 "equal_to_f32_on_widened_input": True}
        if timed:
            got = k1(*planes)
            want = fused_frontend_plain(*planes, ct, mt, scale, decim, True)
            torch.cuda.synchronize()
            err = max(float((got[0] - want[0]).abs().max()),
                      float((got[3] - want[3]).abs().max()))
            check(err <= K1_DC_TOL, f"fused_frontend {label} bf16: err {err}")
            entry.update(
                max_abs_err=err, tol=K1_DC_TOL,
                ms=cuda_ms(torch, lambda: k1(*planes), 20),
                plain_ms=cuda_ms(torch, lambda: fused_frontend_plain(
                    *planes, ct, mt, scale, decim, True), 3),
                library_ms=None, f32_body_ms=f32_results[label]["ms"],
                **frontend_bound(planes + [ct, mt, scale, decim]))
            results[f"{label}_bf16"] = entry
        emit(entry)
        del planes
        torch.cuda.empty_cache()
    check(len(bodies) == 8, f"fused_frontend bf16: bodies launched {bodies}")
    phase_frontend_walk(torch, dev)
    return results


def phase_frontend_walk(torch, dev):
    """K1's four walking bodies (41 taps on bfloat16 planes) on
    kernels/frontend.py:WALK_EDGE_CASES (every row start offset mod 16,
    planes 2 bytes past a 16-byte boundary, one channel, a block shorter
    than a tile and one of a tile and one sample, walks of 3 and of 8
    tiles): filt and dc bit-equal to the float32 body on the widened
    input, the tails the input. One JSON line."""
    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels import frontend as kfront
    from sondetpu_torch.kernels.pfb_cases import misaligned

    rng = np.random.default_rng(18)
    ct = design_lowpass(5000.0, FS, 41)
    chosen = kfront.frontend_walk
    done = []
    try:
        for edge, (rows, n1, shifted, walk) in kfront.WALK_EDGE_CASES.items():
            for decim in (1, 2):
                n = n1 * decim
                planes = [torch.from_numpy(rng.normal(size=s).astype(
                    np.float32)).to(dev, torch.bfloat16)
                    for s in ((rows, n), (rows, n), (rows, kfront.HALO),
                              (rows, kfront.HALO))]
                if shifted:
                    planes = [misaligned(p) for p in planes]
                    check(planes[0].data_ptr() % 16 == 2,
                          f"fused_frontend walk {edge}: planes aligned")
                kfront.frontend_walk = chosen if walk is None else (
                    lambda c, tiles, sms, w=walk: w)
                for ident in (False, True):
                    if ident:
                        mt = np.zeros(41, np.float32)
                        mt[-1] = 1.0
                    else:
                        mt = design_lowpass(2640.0, FS / decim, 41)
                    scale = float(np.float32(FS / decim
                                             / (2 * np.pi * 2400.0)))
                    label = f"{edge}-decim{decim}" + ("-identity" * ident)
                    body = "fused_frontend:" + kfront.frontend_body(
                        decim, 41, ident, True)
                    check_bf16_equals_widened(
                        torch, "fused_frontend", label, body,
                        lambda *p: kfront.fused_frontend(*p, ct, mt, scale,
                                                         decim, True),
                        planes)
                    done.append(label)
                del planes
    finally:
        kfront.frontend_walk = chosen
    emit({"phase": "kernel", "name": "fused_frontend", "case": "walk_edges",
          "dtype": "bf16", "cases": done,
          "equal_to_f32_on_widened_input": True})


def corr_cases(rng):
    """K2's cases: (label, channels, buffer, template, timed). The RS41
    chip ring (sign body, L 64, timed), the same shape with a template that
    is not +/-1 (the separately rounded body, timed), the fleet's dfm group
    (sign, L 32), run-time lengths of either kind, a template above 64
    taps, and edge shapes (one channel, buffers that are neither a multiple
    of the tile nor of four)."""
    from sondetpu_torch.sondes import dfm, m10
    from sondetpu_torch.sondes.rs41 import SPEC

    def signs(L):
        return (rng.integers(0, 2, L) * 2 - 1).astype(np.float32)

    rs41_t = SPEC.sync_chip_template()
    return (
        ("rs41", CHANNELS, 2560 + 19200, rs41_t, True),
        ("rounded-l64", CHANNELS, 2560 + 19200,
         rng.normal(size=64).astype(np.float32), True),
        ("dfm", 208, 10560, dfm.SPEC.sync_chip_template(), False),
        ("rounded-l32", 64, 10560, rng.normal(size=32).astype(np.float32),
         False),
        ("sign-runtime-l48", 64, 9000, signs(48), False),
        ("rounded-runtime-l20", 64, 9000,
         rng.normal(size=20).astype(np.float32), False),
        ("long-l80", 64, 40048, m10.SPEC.sync_chip_template(), False),
        ("long-l300", 16, 9001, rng.normal(size=300).astype(np.float32),
         False),
        ("edge-c1", 1, 4099, rs41_t, False),
        ("edge-c3-l32", 3, 3871, signs(32), False),
        ("edge-c5-mixed", 5, 5003,
         np.where(rng.random(64) < 0.5, signs(64), 0.5).astype(np.float32),
         False))


def corr_bound(buf, L: int, sign: bool):
    """K2's bound for the body that runs, beside both bodies' counts: per
    output L fused multiply-adds and the scale (sign body) or L products
    and L sums and the scale (separately rounded)."""
    c, n = buf.shape
    outs = c * (n - L + 1)
    ops = {"sign_body_ops": outs * (L + 1),
           "rounded_body_ops": outs * (2 * L + 1)}
    return dict(ops, **bound(nbytes(buf) + 4 * L + 4 * outs,
                             ops["sign_body_ops" if sign else
                                 "rounded_body_ops"]))


def phase_kernels(torch, dev):
    """K2 in every body and K3 (phase_syndrome) against their twins at the
    RS41 path's shapes."""
    import torch.nn.functional as F

    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.corr import (corr_body, corr_kernel,
                                             corr_plain, is_sign_template)

    rng = np.random.default_rng(0)
    results = {}

    # K2: every product and sum rounded as the twin's, or (sign body) one
    # exact product per fused multiply-add: torch.equal in every case
    bodies = set()
    for label, c, n, t, timed in corr_cases(rng):
        buf = torch.from_numpy(rng.normal(size=(c, n)).astype(
            np.float32)).to(dev)
        tmpl = torch.from_numpy(t).to(dev)
        L, sign = len(t), is_sign_template(t)
        body = "corr:" + corr_body(L, sign)
        cuda.reset_launches()
        got = corr_kernel(buf, tmpl)
        want = corr_plain(buf, tmpl)
        torch.cuda.synchronize()
        check(cuda.body_launches == {body: 1},
              f"corr {label}: bodies {cuda.body_launches}, expected {body}")
        check(torch.isfinite(got).all(), f"corr {label}: non-finite")
        check(torch.equal(got, want),
              f"corr {label}: not equal to its twin (max err "
              f"{float((got - want).abs().max())})")
        bodies.add(body)
        entry = {"phase": "kernel", "name": "corr", "case": label,
                 "shape": [c, n], "L": L, "sign_template": sign,
                 "body": body, "max_abs_err": 0.0, "tol": 0}
        if timed:
            # the library's one call: conv1d (cuDNN, TF32 off) of the
            # scaled template
            w = (tmpl / L)[None, None, :]
            entry.update(
                ms=cuda_ms(torch, lambda: corr_kernel(buf, t), 50),
                plain_ms=cuda_ms(torch, lambda: corr_plain(buf, tmpl), 5),
                library_ms=cuda_ms(torch, lambda: F.conv1d(
                    buf[:, None, :], w), 20),
                **corr_bound(buf, L, sign))
            results[label] = entry
        emit(entry)
        del buf, got, want
    check(len(bodies) == 7, f"corr: bodies launched {bodies}")
    torch.cuda.empty_cache()
    results["corr"] = results.pop("rs41")
    results["corr_rounded_l64"] = results.pop("rounded-l64")

    results.update(phase_syndrome(torch, dev, rng))
    return results


def corrupt_rows(rng, frames, covered):
    """XOR 1-3 random bytes of ``covered`` into about half the rows (fewer
    errors than the code's distance, so each such row is dirty). Returns
    (frames, clean truth)."""
    bad = rng.random(len(frames)) < 0.5
    for r in np.nonzero(bad)[0]:
        pos = rng.choice(covered, size=rng.integers(1, 4), replace=False)
        frames[r, pos] ^= rng.integers(1, 256, size=pos.size).astype(np.uint8)
    return frames, ~bad


def syndrome_frames(rng, name: str, rows: int):
    """K3's inputs: (frames [rows, fb] uint8, clean truth [rows], RS
    layout). rs41 and rs41x: 64 distinct frames of the port's modulator
    (320 and 518 bytes); the EDGE_LAYOUTS: random data with each codeword's
    parity from the RS encoder. About half the rows are corrupted."""
    from sondetpu_torch.fec.rs import ReedSolomon
    from sondetpu_torch.sondes.rs41 import SPEC, RS41Modulator, RS41Truth

    if name in ("rs41", "rs41x"):
        ext = name == "rs41x"
        base = np.stack([RS41Modulator().build_frame(RS41Truth(frame_no=k),
                                                     extended=ext)
                         for k in range(64)])
        fb = base.shape[1]
        return (*corrupt_rows(rng, base[rng.integers(0, 64, size=rows)],
                              np.arange(8, fb)), SPEC.extra["rs"])
    fb, layout = EDGE_LAYOUTS[name]
    ds, ps, nroots, ilv = (layout[k] for k in ("data_start", "parity_start",
                                               "nroots", "interleave"))
    nrs = (fb - ds) // ilv
    frames = rng.integers(0, 256, size=(rows, fb)).astype(np.uint8)
    rs = ReedSolomon(nroots, layout["fcr"], layout["prim"])
    covered = []
    for i in range(ilv):
        data = ds + ilv * np.arange(nrs) + i
        parity = ps + nroots * i + np.arange(nroots)
        frames[:, parity] = rs.encode(frames[:, data])[:, nrs:]
        covered += [data, parity]
    return (*corrupt_rows(rng, frames, np.concatenate(covered)), layout)


def phase_syndrome(torch, dev, rng):
    """K3 against its twin and the truth, in both bodies: RS41's 2048 x 9
    rows of 320 bytes and rs41x's of 518 (both timed), one row, row counts
    that are not a multiple of a block's frames, frames that are not
    4-byte aligned in memory, a 61-byte layout (64 columns) and a 512-column
    layout."""
    from sondetpu_torch.fec.syndrome import layout_matrix
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.syndrome import (BODY_COLUMNS,
                                                 rs_clean_flags_kernel,
                                                 rs_clean_plain,
                                                 syndrome_body)

    rows = CHANNELS * 9
    cases = (  # label, frames, rows, byte offset in memory, timed
        ("rs41", "rs41", rows, 0, True), ("rs41x", "rs41x", rows, 0, True),
        ("rows-1", "rs41", 1, 0, False),
        ("rows-67-rs41x", "rs41x", 67, 0, False),
        ("unaligned-rs41", "rs41", 1000, 1, False),
        ("unaligned-rs41x", "rs41x", 1001, 3, False),
        ("odd61", "odd61", 1000, 0, False), ("c512", "c512", 1001, 0, False))
    results, bodies = {}, set()
    for label, name, r, offset, timed in cases:
        frames, truth, layout = syndrome_frames(rng, name, r)
        fb = frames.shape[1]
        flat = torch.zeros(r * fb + offset, dtype=torch.uint8, device=dev)
        fr = flat[offset:].view(r, fb)
        fr.copy_(torch.from_numpy(frames))
        ncols = layout_matrix(fb, layout).shape[1]
        body = "rs_clean:" + syndrome_body(ncols)
        cuda.reset_launches()
        got = rs_clean_flags_kernel(fr, layout)
        want = rs_clean_plain(fr, layout)
        torch.cuda.synchronize()
        check(cuda.body_launches == {body: 1},
              f"rs_clean {label}: bodies {cuda.body_launches}, expected "
              f"{body}")
        check(torch.equal(got, want), f"rs_clean {label}: "
              f"{int((got != want).sum())} rows differ from the twin")
        check(torch.equal(got.cpu(), torch.from_numpy(truth)),
              f"rs_clean {label}: verdicts differ from the truth")
        bodies.add(body)
        entry = {"phase": "kernel", "name": "rs_clean", "case": label,
                 "rows": r, "frame_bytes": fb, "columns": ncols,
                 "data_ptr_mod_4": fr.data_ptr() % 4, "body": body,
                 "clean_rows": int(truth.sum()), "max_abs_err": 0.0,
                 "tol": 0}
        if timed:
            # the bound as PR 5 set it: frame bytes, and 12 packed-word
            # XORs per set bit; beside it the column-parity form's LOP3
            # (rows x padded columns x words) at the integer logic rate
            width = BODY_COLUMNS[syndrome_body(ncols)]
            lop3 = r * width * -(-fb // 4)
            entry.update(
                ms=cuda_ms(torch, lambda: rs_clean_flags_kernel(fr, layout),
                           50),
                plain_ms=cuda_ms(torch, lambda: rs_clean_plain(fr, layout),
                                 5),
                library_ms=None, lop3=lop3,
                lop3_ms_at_integer_rate=lop3 / INT_LOGIC_OPS_PER_S * 1e3,
                **bound(frames.nbytes + r,
                        12 * int(np.unpackbits(frames).sum())))
            results[label] = entry
        emit(entry)
        del flat, fr, got, want
    check(bodies == {f"rs_clean:{b}" for b in BODY_COLUMNS},
          f"rs_clean: bodies launched {bodies}")
    results["rs_clean"] = results.pop("rs41")
    results["rs_clean_rs41x"] = results.pop("rs41x")
    return results


def phase_main_path(torch, dev, sonde: str = "rs41", n_blocks: int = 4,
                    dtype=None):
    """The RS41 kernel path at 2048 channels through DecoderSession; with
    sonde "rs41x", the same path on 518-byte extended frames carrying an
    ozone reading of RS41X_O3 mPa (K3's second shape). With ``dtype``
    ("f32" or "bf16"), the plain-op step instead (use_pallas=False, in that
    compute dtype), which launches no hand kernel but the plain
    correlation's, once a step, and the plain filter's, three times."""
    from sondetpu_torch.fec import native
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    ext = sonde == "rs41x"
    plain = dtype is not None
    label = (f"plain {sonde} {dtype} path" if plain
             else "rs41x path" if ext else "main path")
    cfg = PipelineConfig(sonde=sonde, channels=CHANNELS, block_len=BLOCK_LEN,
                         use_pallas=not plain, compute_dtype=dtype or "f32",
                         input_dtype="i16")
    check(cfg.spec.frame_bytes == (518 if ext else 320),
          f"{label}: frames of {cfg.spec.frame_bytes} bytes")
    qi, qq = rs41_planes("S1234567", n_blocks, seed=0,
                         o3_mpa=RS41X_O3 if ext else None)
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
    bodies = dict(cuda.body_launches)
    m = sess.metrics
    check(native.available(), f"{label}: the port's native FEC is not "
          "loaded")
    check(m.frames_decoded > 0, f"{label}: no frames decoded")
    check(m.frames_decoded % CHANNELS == 0,
          f"{label}: {m.frames_decoded} decoded frames do not split evenly "
          "over identical channels")
    check(sorted(sess.telemetry) == list(range(CHANNELS)),
          f"{label}: channels without telemetry")
    ref = sess.telemetry[0].to_dict()
    check(ref.get("serial") == "S1234567", f"{label}: telemetry {ref}")
    if ext:
        check(ref.get("aux_data") == f"O3={RS41X_O3:.2f}mPa",
              f"{label}: no ozone reading in {ref}")
    # compared as JSON text: NaN fields (uncalibrated PTU) compare equal
    ref_text = json.dumps(ref, sort_keys=True)
    check(all(json.dumps(sess.telemetry[ch].to_dict(), sort_keys=True)
              == ref_text for ch in range(CHANNELS)),
          f"{label}: telemetry differs between identical channels")
    if plain:
        check(plain_kernels_only(launches, cfg, n_blocks),
              f"{label}: hand kernels launched {launches}")
        check(sess.state.chipbuf.dtype == (torch.bfloat16 if dtype == "bf16"
                                           else torch.float32),
              f"{label}: chip ring in {sess.state.chipbuf.dtype}")
    else:
        for name in ("fused_frontend", "corr", "rs_clean"):
            check(launches[name] > 0, f"{label}: kernel {name} was not "
                  "launched")
        # RS41's matched filter is a lowpass: the general decim-2 body; its
        # syncword template is 64 chips of +/-1: the correlator's sign
        # body; its 384 syndrome columns: K3's c384 body
        check(bodies == {"fused_frontend:decim2_t41": n_blocks,
                         "corr:sign_l64": n_blocks,
                         "rs_clean:c384": n_blocks},
              f"{label}: bodies {bodies}")
    emit({"phase": ("plain_path" if plain else "rs41x_path" if ext
                    else "main_path"), "sonde": sonde,
          "use_pallas": cfg.use_pallas, "compute_dtype": cfg.compute_dtype,
          "channels": CHANNELS, "block_len": BLOCK_LEN, "blocks": n_blocks,
          "frame_bytes": cfg.spec.frame_bytes, "k_slots": cfg.k_slots,
          "frames_raw": m.frames_raw, "frames_decoded": m.frames_decoded,
          "frames_per_channel": m.frames_decoded // CHANNELS,
          "serial": ref.get("serial"), "lat": ref.get("lat"),
          "lon": ref.get("lon"), "alt": ref.get("alt"),
          "aux_data": ref.get("aux_data"),
          "launches": {k: v for k, v in launches.items() if v},
          "body_launches": bodies, "process_block_seconds": block_seconds})
    return pipe, blocks, {"launches": launches, "bodies": bodies,
                          "steps": n_blocks}


def dfm_planes(serial: str, n_blocks: int, seed: int):
    """int16 (i, q) planes [n_blocks * BLOCK_LEN] of back-to-back DFM frames
    carrying ``serial``, complex noise of std 0.1 per component, cs16."""
    n = n_blocks * BLOCK_LEN
    iq = narrowband("dfm", serial, n, FS)
    rng = np.random.default_rng(seed)
    noisy = iq + (rng.normal(size=n) + 1j * rng.normal(size=n)
                  ).astype(np.complex64) * 0.1
    return tuple(np.clip(x * 32767, -32768, 32767).astype(np.int16)
                 for x in (noisy.real, noisy.imag))


def phase_distinct(torch, dev, sonde: str = "rs41", dtype=None):
    """8 channels, three serials (rs41x: each with its own ozone reading):
    the card's pipeline equals the CPU's (plain twins) byte for byte on
    validity, valid frames and RS verdicts, the card's session equals the
    CPU's telemetry, and each channel decodes its own serial. With
    ``dtype``, the plain-op step in that compute dtype (rs41 or dfm), which
    launches no hand kernel on the card but the plain correlation's."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    ext = sonde == "rs41x"
    serials = (["1234567", "1235678", "7654321"] if sonde == "dfm"
               else ["S1234567", "T7654321", "R0420042"])
    o3 = [RS41X_O3 + k for k in range(3)] if ext else [None] * 3
    c, n_blocks = 8, 3
    sig = [dfm_planes(s, n_blocks, seed=k + 1) if sonde == "dfm"
           else rs41_planes(s, n_blocks, seed=k + 1, o3_mpa=o3[k])
           for k, s in enumerate(serials)]
    qi = np.stack([sig[ch % 3][0] for ch in range(c)])
    qq = np.stack([sig[ch % 3][1] for ch in range(c)])
    cfg = PipelineConfig(sonde=sonde, channels=c, block_len=BLOCK_LEN,
                         use_pallas=dtype is None,
                         compute_dtype=dtype or "f32", input_dtype="i16")
    gpu, cpu = Pipeline(cfg, dev), Pipeline(cfg, "cpu")
    torch.cuda.synchronize()
    cuda.reset_launches()
    sg, sc = gpu.init_state(), cpu.init_state()
    gsess = DecoderSession(cfg, dev, pipeline=gpu)
    csess = DecoderSession(cfg, "cpu", pipeline=cpu)
    frames = 0
    for b in range(n_blocks):
        sl = slice(b * BLOCK_LEN, (b + 1) * BLOCK_LEN)
        sg, og = gpu.step(sg, (qi[:, sl], qq[:, sl]))
        sc, oc = cpu.step(sc, (qi[:, sl], qq[:, sl]))
        check(og.frames.shape[-1] == cfg.spec.frame_bytes,
              f"{sonde} block {b}: frames of {og.frames.shape[-1]} bytes")
        vg, vc = og.frame_valid.cpu(), oc.frame_valid
        check(torch.equal(vg, vc), f"{sonde} block {b}: validity differs "
              "from CPU")
        check(torch.equal(og.frames.cpu()[vg], oc.frames[vc]),
              f"{sonde} block {b}: frame bytes differ from CPU")
        check(torch.equal(og.rs_clean.cpu(), oc.rs_clean),
              f"{sonde} block {b}: RS verdicts differ from CPU")
        frames += int(vg.sum())
        gsess.process_block((qi[:, sl], qq[:, sl]))
        csess.process_block((qi[:, sl], qq[:, sl]))
    for ch in range(c):
        got, want = gsess.telemetry.get(ch), csess.telemetry.get(ch)
        check(got is not None and got.serial == serials[ch % 3],
              f"{sonde} channel {ch}: telemetry {got}")
        check(want is not None and json.dumps(got.to_dict(), sort_keys=True)
              == json.dumps(want.to_dict(), sort_keys=True),
              f"{sonde} channel {ch}: telemetry differs from the CPU")
        if ext:
            check(got.aux_data == f"O3={o3[ch % 3]:.2f}mPa",
                  f"{sonde} channel {ch}: aux {got.aux_data!r}")
    if dtype is not None:
        # two steps a block on the card: the pipeline's and the session's
        check(plain_kernels_only(cuda.launches, cfg, 2 * n_blocks),
              f"plain {sonde} {dtype}: hand kernels launched {cuda.launches}")
    emit({"phase": ("plain_distinct" if dtype is not None
                    else "rs41x_distinct" if ext else "distinct_serials"),
          "sonde": sonde, "use_pallas": cfg.use_pallas,
          "compute_dtype": cfg.compute_dtype,
          "channels": c, "blocks": n_blocks,
          "frame_bytes": cfg.spec.frame_bytes, "valid_frames": frames,
          "frames_decoded": gsess.metrics.frames_decoded,
          "serials": serials, "aux": [t for t in o3 if t is not None],
          "matches_cpu": True})


def phase_step(torch, pipe, blocks, phase: str = "step", smi=None):
    """Steady-state step time at 2048 channels x 4 s (the median of 12
    unprofiled steps) and peak device memory."""
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
          "use_pallas": pipe.config.use_pallas,
          "compute_dtype": pipe.config.compute_dtype,
          "channels": CHANNELS, "block_seconds": secs,
          "steps": len(times), "step_ms_median": step * 1e3,
          "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
          "realtime_channels": CHANNELS * secs / step,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          **({"nvidia_smi": smi} if smi else {})})
    return step * 1e3


def fleet_family(k: int) -> str:
    """bench.py's fleet channel map: ~60% rs41, ~30% m10, the rest dfm."""
    return "rs41" if k % 10 < 6 else ("m10" if k % 10 < 9 else "dfm")


def narrowband(family: str, serial: str, n: int, fs: float) -> np.ndarray:
    """complex64 [n] at rate fs: back-to-back frames of ``family`` from the
    port's modulator, carrying ``serial`` (the serial its decoder reports;
    imet4 sends none, "" here, and reports lat 40)."""
    from sondetpu_torch.sondes.c50 import C50Modulator, C50Truth
    from sondetpu_torch.sondes.dfm import DFMModulator, DFMTruth
    from sondetpu_torch.sondes.imet4 import IMET4Modulator, IMET4Truth
    from sondetpu_torch.sondes.ims100 import IMS100Modulator, IMS100Truth
    from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
    from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth

    secs = n / fs
    if family == "imet4":
        iq = IMET4Modulator().modulate(
            [IMET4Truth(frame_no=1 + i, lat=40.0)
             for i in range(int(secs / 0.43) + 2)], fs=fs)
    elif family == "c50":
        iq = C50Modulator().modulate(
            [C50Truth(serial_num=int(serial[4:]), frame_no=1 + i)
             for i in range(int(secs / 0.21) + 2)], fs=fs)
    elif family == "ims100":
        iq = IMS100Modulator().modulate(
            [IMS100Truth(serial=serial, frame_no=2 + i)
             for i in range(int(secs / 0.24) + 2)], fs=fs)
    elif family == "rs41":
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
                 block_len: int = BLOCK_LEN, carriers=FLEET_CARRIERS):
    """Wideband (i, q) planes [n_bins * block_len] float32 on ``dev``, one
    block at a time: complex noise of std 0.05 per component plus the
    ``carriers`` ((bin, family, serial) or (bin, family, serial, offset
    Hz)), each modulated at 48 kHz by the port's modulator, shifted by its
    offset, and placed as bench.py places its RS41 carrier (zero-order hold
    x n_bins, then a phase ramp to its bin: row r, column j of the block
    gets a[r] * exp(2*pi*i*k*j/n_bins))."""
    from sondetpu_torch.sondes.modulate import freq_shift

    n = n_blocks * block_len
    placed = []
    for k, family, serial, *offset in carriers:
        iq = narrowband(family, serial, n, FS)
        if offset:
            iq = freq_shift(iq, offset[0] / FS)
        a = torch.from_numpy(np.stack([iq.real, iq.imag]).astype(
            np.float32)).to(dev)
        ang = 2.0 * np.pi * k * np.arange(n_bins) / n_bins
        ph = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)]).astype(
            np.float32)).to(dev)
        placed.append((a, ph))
    gen = torch.Generator(device=dev).manual_seed(seed)
    for b in range(n_blocks):
        sl = slice(b * block_len, (b + 1) * block_len)
        wi = 0.05 * torch.randn((block_len, n_bins), generator=gen, device=dev)
        wq = 0.05 * torch.randn((block_len, n_bins), generator=gen, device=dev)
        for a, ph in placed:
            ar, ai = a[0, sl, None], a[1, sl, None]
            wi += ar * ph[0] - ai * ph[1]
            wq += ar * ph[1] + ai * ph[0]
        yield wi.reshape(-1), wq.reshape(-1)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 when both are all zero)."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale else 0.0


def pfb_fir_library(torch, t_i, t_q, x_i, x_q, hcol,
                    dtype=None) -> dict:
    """K4's and K5's library call: one depthwise ``F.conv1d`` (groups=N,
    TF32 off) of the time-major planes with their carried tail, both planes
    as a batch of two, each column filtered by its branch's taps; with
    ``dtype`` bfloat16, on the planes and taps rounded to bfloat16 (cuDNN's
    bfloat16 convolution, beside the bf16 body). It computes the branch FIR
    without K4's one-row shift of column 0, so it is held to the twin on
    the other columns only (``library_err``, its sum order and roundings
    differ). The planes are stacked beforehand; the call takes their
    transposed view."""
    import torch.nn.functional as F

    from sondetpu_torch.kernels.pfb import pfb_fir_plain

    dtype = dtype or torch.float32
    n = hcol.shape[1]
    planes = torch.stack([torch.cat([t_i, x_i]), torch.cat([t_q, x_q])])
    w = hcol.flip(0).t().contiguous().unsqueeze(1).to(dtype)   # [N, 1, tpp]
    want = pfb_fir_plain(planes[0], planes[1], hcol, dtype)[0].float()
    planes = planes.to(dtype)

    def call():
        return F.conv1d(planes.transpose(1, 2), w, groups=n)

    got = call()
    err = float((got[0, 1:, :want.shape[0]].t().float()
                 - want[:, 1:]).abs().max())
    del got, want
    out = {"library_ms": cuda_ms(torch, call, 5), "library_err": err,
           "library_call": "F.conv1d(groups=N) on the transposed "
                           "time-major planes, column shift excluded"}
    del planes
    torch.cuda.empty_cache()
    return out


def phase_fleet_kernels(torch, dev):
    """The PFB and dual-tone kernels against their twins at the fleet's
    shapes."""
    from sondetpu_torch.dsp.channelizer import PFBChannelizer
    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.dualtone import (dualtone_body,
                                                 fused_dualtone_frontend,
                                                 fused_dualtone_plain,
                                                 mixer_tables)
    from sondetpu_torch.kernels.frontend import HALO
    from sondetpu_torch.kernels.pfb import (TPP, pfb_dft, pfb_dft_plain,
                                            pfb_fir_plain, pfb_fir_stream,
                                            pfb_fir_timemajor)
    from sondetpu_torch.kernels.pfb_cases import misaligned

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
    # per output a product and a sum per tap but the first
    fir_ops = 2 * TPP - 1
    library = pfb_fir_library(torch, t_i, t_q, x_i, x_q, hcol)
    entry = {"phase": "kernel", "name": "pfb_fir_stream", "shape": [m, N_BINS],
             "max_abs_err": err, "tol": fir_tol,
             "ms": cuda_ms(torch, lambda: pfb_fir_stream(
                 x_i, x_q, t_i, t_q, hcol), 20),
             "plain_ms": cuda_ms(torch, lambda: pfb_fir_plain(
                 torch.cat([t_i, x_i]), torch.cat([t_q, x_q]), hcol), 3),
             **library,
             **bound(2 * nbytes(x_i, x_q) + nbytes(t_i, t_q, hcol),
                     2 * m * N_BINS * fir_ops)}
    emit(entry)
    results["pfb_fir_stream"] = entry

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
            entry.update(
                ms=cuda_ms(torch, lambda: pfb_fir_timemajor(
                    vv_i, vv_q, hcol), 20),
                plain_ms=cuda_ms(torch, lambda: pfb_fir_plain(
                    vv_i, vv_q, hcol), 3),
                **library,
                **bound(nbytes(vv_i, vv_q, hcol) + 2 * 4 * rows * N_BINS,
                        2 * rows * N_BINS * fir_ops))
            k5 = entry
        emit(entry)
        del vv_i, vv_q
    results["pfb_fir_timemajor"] = dict(k5, max_abs_err=max(errs))
    del x_i, x_q, t_i, t_q
    torch.cuda.empty_cache()

    # K6: the FFT in f32 against torch.fft (cuFFT), both f32: the error is
    # relative to max |y|. N = 2048 runs the register-pass body (the full
    # block, and a block that is not a multiple of its 8 rows), N = 16 the
    # radix-2 body
    dft_tol = 1e-4
    errs = []
    for rows, nb in ((m, N_BINS), (1003, N_BINS), (4096, 16)):
        u_i, u_q = randn(rows, nb), randn(rows, nb)
        cuda.reset_launches()
        got = pfb_dft(u_i, u_q)
        want = pfb_dft_plain(u_i, u_q)
        torch.cuda.synchronize()
        body = "pfb_dft:" + ("n2048" if nb == 2048 else "radix2")
        check(cuda.body_launches == {body: 1},
              f"pfb_dft N={nb}: bodies {cuda.body_launches}")
        rel = max(rel_err(got[0], want[0]), rel_err(got[1], want[1]))
        err = max(float((got[0] - want[0]).abs().max()),
                  float((got[1] - want[1]).abs().max()))
        check(rel <= dft_tol, f"pfb_dft N={nb}: err {rel} of max|y|")
        errs.append(err)
        del got, want
        entry = {"phase": "kernel", "name": "pfb_dft", "shape": [rows, nb],
                 "body": body, "max_abs_err": err,
                 "max_err_over_max_abs_y": rel,
                 "tol_over_max_abs_y": dft_tol}
        if rows == m:
            # the library's one call: cuFFT along the branch axis, written
            # time-major (K6 also transposes to channel-major)
            z = torch.complex(u_i, u_q)
            entry.update(
                ms=cuda_ms(torch, lambda: pfb_dft(u_i, u_q), 20),
                plain_ms=cuda_ms(torch, lambda: pfb_dft_plain(u_i, u_q), 5),
                library_ms=cuda_ms(torch, lambda: torch.fft.fft(z, dim=-1),
                                   20),
                **bound(2 * nbytes(u_i, u_q) + 4 * nb,
                        rows * 5 * nb * int(np.log2(nb))))
            del z
            k6 = entry
        emit(entry)
        del u_i, u_q
    results["pfb_dft"] = dict(k6, max_abs_err=max(errs))
    torch.cuda.empty_cache()
    results.update(phase_pfb_bf16(torch, dev, randn, hcol))

    # K7 in every body. Metric: the same operations in the same order as
    # the twin, so torch.equal; the dc and rotation sums differ only in the
    # order of summation, so they are held relative to their largest value
    sum_tol = 1e-5
    k7_taps = {41: design_lowpass(0.45 * FS, FS, 41),
               33: design_lowpass(0.45 * FS, FS, 33)}
    # label, channels, samples, skip chanfilt, AFC, nb, timed, taps; ims100
    # (and mrzn1: the same K7 arguments) runs chanfilt_t41_nb20, which the
    # cases after it hold on edge shapes, and the run-time chanfilt body
    # (other taps or nb) at ims100's shape too
    cases = (
        ("m10", 616, m, True, False, 5, True, 41),
        ("ims100", CHANNELS, m, False, False, 20, True, 41),
        ("ims100-nb19", CHANNELS, m, False, False, 19, True, 41),
        ("chanfilt-afc", 256, 48000, False, True, 5, False, 41),
        ("chanfilt", 64, 48000, False, False, 7, False, 41),
        ("skip-afc", 256, 48000, True, True, 5, False, 41),
        ("runtime-nb7", 64, 48000, True, False, 7, False, 41),
        ("runtime-nb7-afc", 64, 48000, True, True, 7, False, 41),
        ("edge-c13", 13, 30001, True, False, 5, False, 41),
        ("edge-c5-chanfilt-afc", 5, 30001, False, True, 3, False, 41),
        ("edge-c1-nb7", 1, 1003, True, False, 7, False, 41),
        ("nb20-afc", 256, 48000, False, True, 20, False, 41),
        ("nb20-edge-c13", 13, 30001, False, False, 20, False, 41),
        ("nb20-edge-c5-afc", 5, 30001, False, True, 20, False, 41),
        ("nb20-edge-c1", 1, 1003, False, False, 20, False, 41),
        ("nb20-misaligned-afc", 9, 30001, False, True, 20, False, 41),
        ("t33-nb20", 64, 48000, False, False, 20, False, 33),
        ("nb21-afc-edge-c13", 13, 30001, False, True, 21, False, 41))
    bodies = set()
    for label, c, n, skip, afc, nb, timed, ntaps in cases:
        taps = k7_taps[ntaps]
        args = (randn(c, n), randn(c, n), randn(c, HALO), randn(c, HALO))
        if "misaligned" in label:
            args = tuple(misaligned(a) for a in args)
        tabs = tuple(torch.from_numpy(t).to(dev)
                     for t in mixer_tables(n, 12000.0 / FS))
        body = "fused_dualtone_frontend:" + dualtone_body(nb, skip, afc,
                                                          ntaps=ntaps)
        cuda.reset_launches()
        got = fused_dualtone_frontend(*args, taps, *tabs, nb, afc, skip)
        want = fused_dualtone_plain(*args, taps, *tabs, nb, afc, skip)
        torch.cuda.synchronize()
        check(cuda.body_launches == {body: 1},
              f"dualtone {label}: bodies {cuda.body_launches}, "
              f"expected {body}")
        check(torch.isfinite(got[0]).all(), f"dualtone {label}: non-finite")
        check(torch.equal(got[0], want[0]),
              f"dualtone {label}: metric not equal to its twin (max err "
              f"{float((got[0] - want[0]).abs().max())})")
        sums_err = max(rel_err(got[k], want[k]) for k in (3, 4, 5))
        check(sums_err <= sum_tol, f"dualtone {label}: sums err {sums_err}")
        check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
              f"dualtone {label}: carried tails differ")
        bodies.add(body)
        del got, want
        entry = {"phase": "kernel", "name": "fused_dualtone_frontend",
                 "case": label, "shape": [c, n], "skip_chanfilt": skip,
                 "want_afc": afc, "nb": nb, "body": body, "max_abs_err": 0.0,
                 "tol": 0, "sums_rel_err": sums_err, "sums_tol": sum_tol}
        if timed:
            # per position: the channel filter of both planes unless it is
            # skipped (2 x 41 products and sums), the +/-dev mix of both
            # planes (12), the nb-tap boxcars of four planes and their
            # scale (4 (nb + 1)), the metric (10), its DC sum (1): 47 for
            # m10's nb = 5, 271 for ims100's channel filter and nb = 20; a
            # fused chain, no single library call
            ops = (0 if skip else 4 * len(taps)) + 12 + 4 * (nb + 1) + 11
            entry.update(
                ms=cuda_ms(torch, lambda: fused_dualtone_frontend(
                    *args, taps, *tabs, nb, afc, skip), 20),
                plain_ms=cuda_ms(torch, lambda: fused_dualtone_plain(
                    *args, taps, *tabs, nb, afc, skip), 3),
                library_ms=None, ops_per_position=ops,
                **bound(nbytes(*args, *tabs) + nbytes(*args[2:]) + 4 * c * n,
                        c * n * ops))
            results[{"m10": "fused_dualtone_frontend",
                     "ims100": "fused_dualtone_frontend_chanfilt"}.get(
                label, f"fused_dualtone_frontend_{label}")] = entry
        emit(entry)
        del args, tabs
    check(len(bodies) == 8, f"dualtone: bodies launched {bodies}")
    torch.cuda.empty_cache()
    # K7 on bfloat16 planes and tails in every body: bit-equal to the
    # float32 body on the widened input, the m10 and ims100 shapes timed at
    # 2 bytes a sample
    bodies = set()
    for label, c, n, skip, afc, nb, timed, ntaps in cases:
        taps = k7_taps[ntaps]
        planes = [randn(*s).to(torch.bfloat16)
                  for s in ((c, n), (c, n), (c, HALO), (c, HALO))]
        if "misaligned" in label:
            planes = [misaligned(p) for p in planes]
        tabs = tuple(torch.from_numpy(t).to(dev)
                     for t in mixer_tables(n, 12000.0 / FS))
        body = "fused_dualtone_frontend:" + dualtone_body(nb, skip, afc, True,
                                                          ntaps)

        def k7(*p):
            return fused_dualtone_frontend(*p, taps, *tabs, nb, afc, skip)

        check_bf16_equals_widened(torch, "dualtone", label, body, k7, planes)
        bodies.add(body)
        entry = {"phase": "kernel", "name": "fused_dualtone_frontend",
                 "case": label, "dtype": "bf16", "shape": [c, n],
                 "skip_chanfilt": skip, "want_afc": afc, "nb": nb,
                 "body": body, "equal_to_f32_on_widened_input": True}
        if timed:
            got = k7(*planes)
            want = fused_dualtone_plain(*planes, taps, *tabs, nb, afc, skip)
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]),
                  f"dualtone {label} bf16: metric not equal to its twin")
            ops = (0 if skip else 4 * len(taps)) + 12 + 4 * (nb + 1) + 11
            entry.update(
                max_abs_err=0.0, tol=0,
                ms=cuda_ms(torch, lambda: k7(*planes), 20),
                plain_ms=cuda_ms(torch, lambda: fused_dualtone_plain(
                    *planes, taps, *tabs, nb, afc, skip), 3),
                library_ms=None, ops_per_position=ops,
                **bound(nbytes(*planes, *tabs) + nbytes(*planes[2:])
                        + 4 * c * n, c * n * ops))
            results[{"m10": "fused_dualtone_frontend_bf16",
                     "ims100": "fused_dualtone_frontend_chanfilt_bf16"}.get(
                label, f"fused_dualtone_frontend_{label}_bf16")] = entry
        emit(entry)
        del planes, tabs
    check(len(bodies) == 8, f"dualtone bf16: bodies launched {bodies}")
    torch.cuda.empty_cache()
    return results


def phase_pfb_bf16(torch, dev, randn, hcol):
    """The PFB kernels in bfloat16 at the fleet's shape: K4 and K5 (body
    bf16: float32 planes rounded to bfloat16 on the read, every product and
    sum rounded to bfloat16, bfloat16 out) torch.equal to their twin run in
    bfloat16; K6 on bfloat16 u (float32 transform, one rounding on the
    store) within one bfloat16 step at max|y| plus 1e-4 of max|y| of the
    float32 FFT of the widened u. Each timed beside its bound at the bytes
    it moves (K4/K5 read 4 and write 2 bytes a sample, K6 2 and 2)."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.pfb import (TPP, pfb_dft, pfb_dft_plain,
                                            pfb_fir_plain, pfb_fir_stream,
                                            pfb_fir_timemajor)

    from sondetpu_torch.kernels.pfb_cases import misaligned

    bf = torch.bfloat16
    m = BLOCK_LEN
    results = {}
    check_pfb_bf16_edges(torch, dev, randn, hcol)
    x_i, x_q, t_i, t_q = randn(m, N_BINS), randn(m, N_BINS), \
        randn(8, N_BINS), randn(8, N_BINS)
    cuda.reset_launches()
    got = pfb_fir_stream(x_i, x_q, t_i, t_q, hcol, bf)
    bodies = dict(cuda.body_launches)
    want = pfb_fir_plain(torch.cat([t_i, x_i]), torch.cat([t_q, x_q]), hcol,
                         bf)
    torch.cuda.synchronize()
    check(bodies == {"pfb_fir_stream:bf16": 1},
          f"pfb_fir_stream bf16: bodies {bodies}")
    check(got[0].dtype == bf and bits_equal(torch, got, want),
          "pfb_fir_stream bf16: not equal to its twin in bfloat16")
    fir_ops = 2 * TPP - 1
    library = pfb_fir_library(torch, t_i, t_q, x_i, x_q, hcol, bf)
    results["pfb_fir_stream_bf16"] = entry = {
        "phase": "kernel", "name": "pfb_fir_stream", "dtype": "bf16",
        "shape": [m, N_BINS], "body": "bf16", "max_abs_err": 0.0, "tol": 0,
        "ms": cuda_ms(torch, lambda: pfb_fir_stream(x_i, x_q, t_i, t_q, hcol,
                                                    bf), 20),
        "plain_ms": cuda_ms(torch, lambda: pfb_fir_plain(
            torch.cat([t_i, x_i]), torch.cat([t_q, x_q]), hcol, bf), 3),
        **library,
        **bound(nbytes(x_i, x_q, t_i, t_q, hcol) + nbytes(*got),
                2 * m * N_BINS * fir_ops)}
    emit(entry)
    u_i, u_q = got
    del got, want
    for rows in (4, m):
        vv_i = torch.cat([t_i, x_i[:rows]])
        vv_q = torch.cat([t_q, x_q[:rows]])
        got = pfb_fir_timemajor(vv_i, vv_q, hcol, bf)
        want = pfb_fir_plain(vv_i, vv_q, hcol, bf)
        torch.cuda.synchronize()
        check(bits_equal(torch, got, want),
              f"pfb_fir_timemajor bf16 m={rows}: not equal to its twin")
        entry = {"phase": "kernel", "name": "pfb_fir_timemajor",
                 "dtype": "bf16", "shape": [TPP + rows, N_BINS],
                 "body": "bf16", "max_abs_err": 0.0, "tol": 0}
        if rows == m:
            entry.update(
                ms=cuda_ms(torch, lambda: pfb_fir_timemajor(
                    vv_i, vv_q, hcol, bf), 20),
                plain_ms=cuda_ms(torch, lambda: pfb_fir_plain(
                    vv_i, vv_q, hcol, bf), 3),
                **library,
                **bound(nbytes(vv_i, vv_q, hcol) + nbytes(*got),
                        2 * rows * N_BINS * fir_ops))
            results["pfb_fir_timemajor_bf16"] = entry
        emit(entry)
        del vv_i, vv_q, got, want
    del x_i, x_q
    torch.cuda.empty_cache()
    errs = []
    # K6: the full block, m that no 16-row cluster tile divides (1003; 5:
    # one tile whose second block has no rows; 9: one row), planes whose
    # bulk copies cannot start (misaligned by 2 bytes), and N = 16
    for rows, nb, skew in ((m, N_BINS, False), (1003, N_BINS, False),
                           (5, N_BINS, False), (9, N_BINS, False),
                           (1003, N_BINS, True), (4096, 16, False)):
        ui, uq = ((u_i, u_q) if rows == m else
                  (randn(rows, nb).to(bf), randn(rows, nb).to(bf)))
        if skew:
            ui, uq = (misaligned(v) for v in (ui, uq))
        cuda.reset_launches()
        y = pfb_dft(ui, uq)
        bodies = dict(cuda.body_launches)
        ref = pfb_dft_plain(ui.float(), uq.float())
        torch.cuda.synchronize()
        body = "pfb_dft:" + ("n2048" if nb == 2048 else "radix2") + "_bf16"
        check(bodies == {body: 1}, f"pfb_dft bf16 N={nb}: bodies {bodies}")
        top = max(float(ref[0].abs().max()), float(ref[1].abs().max()))
        tol = 2.0 ** (np.floor(np.log2(top)) - 7) + 1e-4 * top
        err = max(float((y[0].float() - ref[0]).abs().max()),
                  float((y[1].float() - ref[1]).abs().max()))
        check(y[0].dtype == bf and err <= tol,
              f"pfb_dft bf16 N={nb}: err {err} beyond {tol}")
        errs.append(err / top)
        entry = {"phase": "kernel", "name": "pfb_dft", "dtype": "bf16",
                 "shape": [rows, nb], "body": body, "misaligned": skew,
                 "max_abs_err": err, "tol": tol,
                 "max_err_over_max_abs_y": err / top}
        if rows == m:
            # the library's one call: cuFFT of the same values, widened
            # (it takes no bfloat16)
            z = torch.complex(ui.float(), uq.float())
            entry.update(
                ms=cuda_ms(torch, lambda: pfb_dft(ui, uq), 20),
                plain_ms=cuda_ms(torch, lambda: pfb_dft_plain(
                    ui.float(), uq.float()), 5),
                library_ms=cuda_ms(torch, lambda: torch.fft.fft(z, dim=-1),
                                   20),
                **bound(2 * nbytes(ui, uq) + 4 * nb,
                        rows * 5 * nb * int(np.log2(nb))))
            del z
            results["pfb_dft_bf16"] = entry
        emit(entry)
        del ui, uq, y, ref
    del u_i, u_q
    torch.cuda.empty_cache()
    return results


def bits_equal(torch, got, want) -> bool:
    """Each plane of ``got`` equal to ``want``'s as int16 bit patterns (a
    flushed subnormal or a lost signed zero shows; so does a NaN)."""
    return all(a.dtype == b.dtype == torch.bfloat16
               and torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(got, want))


def check_pfb_bf16_edges(torch, dev, randn, hcol, m: int = 1003):
    """K4 and K5's bf16 body bit-equal (int16 patterns) to the twin in
    bfloat16 on the edge-value planes of sondetpu_torch/kernels/pfb_cases.py (exact
    ties, subnormals, sums that overflow near bfloat16's largest value,
    signed zeros) at 2048 columns and a ragged m, and on normal planes at
    an odd N (2047: the paired columns' scalar loads and stores)."""
    from sondetpu_torch.kernels.pfb import (pfb_fir_plain, pfb_fir_stream,
                                            pfb_fir_timemajor)

    from sondetpu_torch.kernels.pfb_cases import (BF16_EDGE_CASES,
                                                  bf16_edge_planes)

    from sondetpu_torch.dsp.channelizer import PFBChannelizer

    bf = torch.bfloat16
    cases = [(c, N_BINS) for c in BF16_EDGE_CASES] + [(None, N_BINS - 1)]
    for case, n in cases:
        if case is None:
            vv_i, vv_q = randn(8 + m, n), randn(8 + m, n)
            h = PFBChannelizer(n, dev)._hcol_t
        else:
            vi, vq, taps = bf16_edge_planes(case, 8 + m, n, 16)
            vv_i, vv_q = (torch.from_numpy(v).to(dev) for v in (vi, vq))
            h = hcol if taps is None else torch.from_numpy(taps).to(dev)
        want = pfb_fir_plain(vv_i, vv_q, h, bf)
        got = pfb_fir_stream(vv_i[8:], vv_q[8:], vv_i[:8], vv_q[:8], h, bf)
        check(bits_equal(torch, got, want),
              f"pfb_fir_stream bf16 {case or 'odd N'}: not equal to its twin")
        got = pfb_fir_timemajor(vv_i, vv_q, h, bf)
        check(bits_equal(torch, got, want),
              f"pfb_fir_timemajor bf16 {case or 'odd N'}: not equal to its "
              "twin")
    emit({"phase": "kernel", "name": "pfb_fir_stream", "dtype": "bf16",
          "edge_cases": [c or f"odd N {n}" for c, n in cases], "rows": m,
          "bit_equal": True})


def phase_pfb_stream(torch, dev, dtype: str = "f32"):
    """The 2048-bin channelizer (in ``dtype``) over blocks shorter than its
    history (pfb_fir_timemajor, the tail carried through a concatenation)
    equals one call on the whole stream (pfb_fir_stream): the same
    arithmetic, so the outputs must be equal exactly."""
    from sondetpu_torch.dsp.channelizer import PFBChannelizer
    from sondetpu_torch.kernels import cuda

    pfb = PFBChannelizer(N_BINS, dev, dtype)
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
    bodies = dict(cuda.body_launches)
    _, w_i, w_q = pfb(pfb.init_state(), x_i, x_q)
    same = (torch.equal(torch.cat(ys_i, dim=1), w_i)
            and torch.equal(torch.cat(ys_q, dim=1), w_q))
    check(same, "pfb_stream: short blocks differ from one long block")
    check(launches["pfb_fir_timemajor"] == n_short
          and bodies.get("pfb_fir_timemajor:" + dtype) == n_short,
          f"pfb_stream: pfb_fir_timemajor launched "
          f"{launches['pfb_fir_timemajor']} times")
    check(y_i.dtype == (torch.bfloat16 if dtype == "bf16"
                        else torch.float32), f"pfb_stream: y in {y_i.dtype}")
    emit({"phase": "pfb_stream", "dtype": dtype, "bins": N_BINS,
          "block_samples": short,
          "blocks": n_short, "equal_to_one_block": same,
          "launches": {k: v for k, v in launches.items() if v}})
    return {"launches": launches, "bodies": bodies, "steps": n_short}


def phase_fleet_path(torch, dev, n_bins: int = N_BINS,
                     block_len: int = BLOCK_LEN, n_blocks: int = 4,
                     compute_dtype: str = "f32"):
    """FleetSession.process_wideband at n_bins x block_len, pipelined, in
    ``compute_dtype`` with the default use_pallas (every group on the
    kernel path). In bf16 (bench.py's fleet default) the PFB runs its bf16
    bodies and the m10 group K7's, the rs41 and dfm groups stay float32."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession

    bf = "_bf16" if compute_dtype == "bf16" else ""
    chans = [FleetChannel(pfb_bin=k, sonde=fleet_family(k))
             for k in range(n_bins)]
    fleet = FleetSession(chans, n_bins, dev, fs_chan=FS, block_len=block_len,
                         pipelined=True, compute_dtype=compute_dtype)
    check({s: sess.config.compute_dtype for s, (_, sess)
           in fleet.groups.items()}
          == {"rs41": "f32", "m10": compute_dtype, "dfm": "f32"},
          f"fleet_path {compute_dtype}: group dtypes")
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
    bodies = dict(cuda.body_launches)
    telem = fleet.telemetry
    for k, family, serial in FLEET_CARRIERS:
        got = telem.get(k)
        check(got is not None and got.serial == serial,
              f"fleet_path: channel {k} ({family}) telemetry {got}")
    for name in ("fused_frontend", "corr", "rs_clean", "pfb_fir_stream",
                 "pfb_dft", "fused_dualtone_frontend"):
        check(launches[name] > 0, f"fleet_path: kernel {name} was not "
              "launched")
    check(bodies.get("pfb_dft:n2048" + bf) == launches["pfb_dft"]
          and bodies.get("pfb_fir_stream:" + (bf[1:] or "f32"))
          == launches["pfb_fir_stream"],
          f"fleet_path: PFB bodies {bodies}")
    # the correlator's sign bodies (rs41 L 64, dfm L 32) and the m10
    # front end's compiled nb = 5 body, once per step each; m10's plain
    # correlation, its syncword (L 80) and its alternate (L 64), once each
    steps = launches["pfb_dft"]
    check(bodies.get("corr:sign_l64") == steps
          and bodies.get("corr:sign_l32") == steps
          and launches["corr"] == 2 * steps
          and bodies.get("rs_clean:c384") == steps == launches["rs_clean"]
          and bodies.get("fused_dualtone_frontend:skip_nb5" + bf) == steps
          == launches["fused_dualtone_frontend"]
          and bodies.get("plain_corr:t80") == steps
          and bodies.get("plain_corr:t64") == steps
          and launches["plain_corr"] == 2 * steps,
          f"fleet_path: correlator, K3, dual-tone and plain correlation "
          f"bodies {bodies}")
    emit({"phase": "fleet_path" + bf, "bins": n_bins, "block_len": block_len,
          "compute_dtype": compute_dtype,
          "blocks": n_blocks, "groups": groups, "updates": updates,
          "channels_with_telemetry": len(telem),
          "carriers": {str(k): {f: telem[k].to_dict()[f] for f in
                                ("serial", "lat", "lon", "alt")}
                       for k, _, _ in FLEET_CARRIERS},
          "process_wideband_seconds": times, "launches": launches,
          "body_launches": bodies})
    return fleet, last, {"launches": launches, "bodies": bodies,
                         "steps": n_blocks}


FLEET_DISTINCT_PLAN = ((1, "rs41", "S1234567"), (3, "rs41", "T7654321"),
                       (5, "m10", "910-2-12345"), (9, "m10", "A05-3-54321"),
                       (12, "dfm", "1234567"), (14, "dfm", "7654321"))
# the bf16 16-bin fleet adds the AFSK families (imet4 reports no serial)
FLEET_AFSK_PLAN = ((1, "rs41", "S1234567"), (5, "m10", "910-2-12345"),
                   (7, "imet4", ""), (10, "c50", "C50-12345"),
                   (12, "dfm", "1234567"))


def phase_fleet_distinct(torch, dev, n_bins: int = 16, n_blocks: int = 3,
                         plan=FLEET_DISTINCT_PLAN,
                         compute_dtype: str = "f32"):
    """A 16-bin fleet, the ``plan``'s carriers with their own serials and
    noise, built at the wideband rate, in ``compute_dtype``: the card
    equals the CPU (twins) in validity, frame bytes, m10's weak-bit sets
    and telemetry."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
    from sondetpu_torch.runtime.pipeline import unpack_block_output
    from sondetpu_torch.sondes.modulate import freq_shift

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
    kw = dict(fs_chan=FS, block_len=int(FS), compute_dtype=compute_dtype)
    gpu = FleetSession(chans, n_bins, dev, **kw)
    cpu = FleetSession(chans, n_bins, "cpu", **kw)
    cuda.reset_launches()
    valid, weak_same, weak_total, ring_equal = {}, 0, 0, {}
    for b in range(n_blocks):
        x = wide[b * w:(b + 1) * w]
        wi = torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
        wq = torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
        pg, fg = gpu.step(wi.to(dev), wq.to(dev))
        pc, fc = cpu.step(wi, wq)
        hg, hc = pg.cpu().numpy(), pc.numpy()
        off = 0
        for (sonde, _, sess), (_, _, csess), frg, frc in zip(
                gpu._order, cpu._order, fg, fc):
            ring_equal.setdefault(sonde, []).append(torch.equal(
                sess.state.chipbuf.cpu(), csess.state.chipbuf))
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
    families = {f for _, f, _ in plan}
    check(all(valid.get(f, 0) > 0 for f in families),
          f"fleet_distinct: valid frames per group {valid}")
    check(weak_total > 0 and weak_same == weak_total,
          f"fleet_distinct: m10 weak-bit sets equal the CPU's for "
          f"{weak_same} of {weak_total} frames (chip rings equal per "
          f"block: {ring_equal})")
    check(all(cuda.launches[k] > 0 for k in
              ["pfb_fir_stream", "pfb_dft", "fused_dualtone_frontend"]
              + ["fused_afsk_frontend"] * ("imet4" in families)),
          f"fleet_distinct: launches {cuda.launches}")
    emit({"phase": "fleet_distinct", "bins": n_bins, "blocks": n_blocks,
          "compute_dtype": compute_dtype, "families": sorted(families),
          "body_launches": dict(cuda.body_launches),
          "valid_frames": valid, "matches_cpu": True,
          "serials": [s for _, _, s in plan],
          "m10_weak_sets_equal": [weak_same, weak_total],
          "chip_rings_equal": ring_equal})


def phase_fleet_step(torch, fleet, wi, wq, smi):
    """The fleet's device step and its session reading at the path's
    shape; then the step of the same fleet with afc=True (every group's
    DDC and AFC loop, seeded on the grid) and without, in turns."""
    from sondetpu_torch.runtime.fleet import FleetSession

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
    afc = FleetSession(fleet.channels, fleet.n_bins, fleet.device,
                       fs_chan=FS, block_len=fleet.block_len, afc=True)
    afc.step(wi, wq)                            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    turns = {"afc": [], "no_afc": []}
    for r in range(6):
        pair = [("afc", afc), ("no_afc", fleet)]
        for key, f in (pair if r % 2 == 0 else pair[::-1]):
            for _ in range(2):
                t0 = time.perf_counter()
                f.step(wi, wq)
                torch.cuda.synchronize()
                turns[key].append((time.perf_counter() - t0) * 1e3)
    afc_peak = torch.cuda.max_memory_allocated()
    del afc
    step = statistics.median(times)
    secs = fleet.block_len / FS
    emit({"phase": "fleet_step", "bins": fleet.n_bins, "block_seconds": secs,
          "steps": len(times), "step_ms_median": step * 1e3,
          "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
          "realtime_channels": fleet.n_bins * secs / step,
          "max_memory_allocated_bytes": peak,
          "process_wideband_ms_median": statistics.median(wall) * 1e3,
          "process_wideband_ms": [t * 1e3 for t in wall],
          "step_ms_median_afc": statistics.median(turns["afc"]),
          "step_ms_median_no_afc": statistics.median(turns["no_afc"]),
          "step_ms_afc": turns["afc"], "step_ms_no_afc": turns["no_afc"],
          "max_memory_allocated_bytes_afc_turns": afc_peak,
          "nvidia_smi": smi})


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
    """K8 against its twin: both AFSK families at the path's shape (timed),
    an edge shape (3 channels, a block that is not a multiple of the tile)
    and a width that takes the run-time body."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.afsk import (afsk_tables, fused_afsk_frontend,
                                             fused_afsk_frontend_plain)
    from sondetpu_torch.kernels.frontend import HALO

    gen = torch.Generator(device=dev).manual_seed(4)
    results = {}
    cases = [(family, CHANNELS, BLOCK_LEN, fm, fsp, win)
             for family, (fm, fsp, win) in AFSK_TONES.items()]
    cases += [("edge", 3, 30001, 1200.0, 2200.0, 40),
              ("runtime-win13", 64, 48000, 2400.0, 4800.0, 13)]
    for label, c, n, fm, fsp, win in cases:
        audio = torch.randn((c, n), generator=gen, device=dev)
        atail = torch.randn((c, HALO), generator=gen, device=dev)
        tabs = [torch.from_numpy(t).to(dev)
                for t in afsk_tables(n, fm / FS, fsp / FS)]
        cuda.reset_launches()
        got = fused_afsk_frontend(audio, atail, tabs, win)
        want = fused_afsk_frontend_plain(audio, atail, tabs, win)
        torch.cuda.synchronize()
        body = "fused_afsk_frontend:" + (
            f"win{win}" if win in (20, 40) else "runtime_win")
        check(cuda.body_launches == {body: 1},
              f"afsk {label}: bodies {cuda.body_launches}")
        check(torch.isfinite(got[0]).all(), f"afsk {label}: non-finite soft")
        # the same operations in the same order as the twin: exact
        check(torch.equal(got[0], want[0]),
              f"afsk {label}: not equal to its twin (max err "
              f"{float((got[0] - want[0]).abs().max())})")
        check(torch.equal(got[1], want[1]), f"afsk {label}: tail differs")
        del got, want
        entry = {"phase": "kernel", "name": "fused_afsk_frontend",
                 "case": label, "win": win, "shape": [c, n], "body": body,
                 "max_abs_err": 0.0, "tol": 0, "tail_exact": True}
        if c == CHANNELS:
            # per output: 4 mixing products, the 4 boxcars' win sums, their
            # scale, the energies (6) and the soft ratio (4); a fused chain,
            # no single library call
            entry.update(
                ms=cuda_ms(torch, lambda: fused_afsk_frontend(
                    audio, atail, tabs, win), 20),
                plain_ms=cuda_ms(torch, lambda: fused_afsk_frontend_plain(
                    audio, atail, tabs, win), 3),
                library_ms=None,
                **bound(2 * nbytes(audio, atail) + nbytes(*tabs),
                        c * n * (18 + 4 * win)))
            results[label] = entry
        emit(entry)
        del audio, atail, tabs
        torch.cuda.empty_cache()
    return results


def check_demod_fir(torch, dev, randn):
    """K9 against its twin: RS41's processing-rate shape, then the run-time
    body (33 taps), a block that no tile divides, one row, and a block of
    T - 1 samples, each with dc_block on and off. With the DC the outputs
    are within K9_TOL of the twin's (the block mean is summed in another
    order than torch.mean, which moves outputs of magnitude ~10 by a few
    ulp); without it they are bit-equal, compared as int32 patterns so that
    a zero's sign counts (a tenth of the carried tail is -0, and row 0
    starts with 100 zero samples); two runs are bit-equal. The path shape
    is timed whole and launch by launch, beside its bound and the two-pass
    floor."""
    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.frontend import (fused_demod_fir,
                                                 fused_demod_fir_plain)

    def bits(t):
        return t.view(torch.int32)

    rs41_taps = design_lowpass(2640.0, FS / 2, 41)
    scale = float(np.float32(FS / 2 / (2 * np.pi * 2400.0)))
    cases = (  # label, channels, block, taps
        ("path", CHANNELS, BLOCK_LEN // 2, rs41_taps),
        ("t33", 64, 24000, design_lowpass(2000.0, FS, 33)),
        ("ragged", 9, 2 * 3840 + 2048 + 7, rs41_taps),
        ("c1", 1, BLOCK_LEN // 2, rs41_taps),
        ("n-t-minus-1", 8, 40, rs41_taps))
    bodies, out = set(), None
    for label, c, n, taps in cases:
        i, q = randn(c, n), randn(c, n)
        prev, atail = randn(c, 2), randn(c, len(taps) - 1)
        atail[:, ::10] = -0.0
        i[0, :100] = 0.0
        q[0, :100] = 0.0
        body = "fused_demod_fir:" + ("t41" if len(taps) == 41
                                     else "runtime_t")
        for dc in (True, False):
            before = dict(cuda.body_launches)
            got = fused_demod_fir(i, q, prev, atail, taps, scale, dc)
            again = fused_demod_fir(i, q, prev, atail, taps, scale, dc)
            want = fused_demod_fir_plain(i, q, prev, atail, taps, scale, dc)
            torch.cuda.synchronize()
            for key in (body, "fused_demod_fir:audio"):
                check(cuda.body_launches.get(key, 0)
                      == before.get(key, 0) + 2,
                      f"demod_fir {label}: bodies {cuda.body_launches}, "
                      f"expected {key}")
            check(all(torch.isfinite(t).all() for t in got),
                  f"demod_fir {label}: non-finite")
            check(all(torch.equal(bits(a), bits(b))
                      for a, b in zip(got, again)),
                  f"demod_fir {label} dc_block={dc}: two runs differ")
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            if dc:
                check(err <= K9_TOL, f"demod_fir {label}: err {err}")
            else:
                check(all(torch.equal(bits(a), bits(b))
                          for a, b in zip(got, want)),
                      f"demod_fir {label}: not bit-equal to its twin "
                      f"without the DC (err {err})")
            entry = {"phase": "kernel", "name": "fused_demod_fir",
                     "case": label, "dc_block": dc, "shape": [c, n],
                     "taps": len(taps), "body": body, "max_abs_err": err,
                     "tol": K9_TOL if dc else 0}
            del got, again, want
            if label == "path" and dc:
                entry.update(time_demod_fir(torch, dev, i, q, prev, atail,
                                            taps, scale))
                out = entry
            emit(entry)
        bodies.add(body)
        del i, q, prev, atail
    check(bodies == {"fused_demod_fir:t41", "fused_demod_fir:runtime_t"},
          f"demod_fir: bodies launched {bodies}")
    torch.cuda.empty_cache()
    return out


def time_demod_fir(torch, dev, i, q, prev, atail, taps, scale, reps=20):
    """K9 as the wrapper calls it, and its twin; each of its two launches'
    device time from torch.profiler over ``reps`` wrapper calls; the bound
    of the function (the planes read once, filt written once: 12 bytes a
    sample), the floor of two passes (20 bytes a sample: the audio written
    and read back), and each launch's own bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.frontend import (fused_demod_fir,
                                                 fused_demod_fir_plain)

    def call():
        return fused_demod_fir(i, q, prev, atail, taps, scale, True)

    ms = cuda_ms(torch, call, reps)
    # the first profiler session of a process can miss a launch while the
    # tracer starts (a run saw 19 of 20): one session on one call first;
    # a later session has also lost one record, so a session whose counts
    # are short is taken again, up to 3 times
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        call()
        torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        launch_ms, seen = {}, []
        for e in prof.key_averages():
            for name in ("demod_audio_kernel", "demod_fir_kernel"):
                if e.device_type == DeviceType.CUDA and name in e.key:
                    check(name not in launch_ms,
                          f"demod_fir: profiler saw {name} twice: {e.key}")
                    seen.append(f"{e.key}: {e.count}")
                    launch_ms[name] = (e.self_device_time_total / 1e3 / reps
                                       if e.count == reps else None)
        if len(launch_ms) == 2 and None not in launch_ms.values():
            break
    check(len(launch_ms) == 2 and None not in launch_ms.values(),
          f"demod_fir: profiler saw {seen} for {reps} calls in each of "
          f"{attempt + 1} sessions")

    c, n = i.shape
    T = len(taps)
    samples = c * n
    # launch 1: the discriminator, the audio and one partial sum per block;
    # launch 2: the DC sum and its subtraction, then the FIR's 2T operations
    partial = 4 * c * cuda.library().sondetpu_demod_audio_parts(n)
    b1 = bound(nbytes(i, q, prev) + 4 * samples + partial,
               samples * (DISC_OPS + 1))
    b2 = bound(8 * samples + partial + 2 * nbytes(atail),
               samples * (2 * T + 1))
    return {"ms": ms,
            "audio_ms": launch_ms["demod_audio_kernel"],
            "fir_ms": launch_ms["demod_fir_kernel"],
            "plain_ms": cuda_ms(torch, lambda: fused_demod_fir_plain(
                i, q, prev, atail, taps, scale, True), 3),
            "library_ms": None,
            **bound(nbytes(i, q, prev) + 2 * nbytes(atail) + 4 * samples,
                    samples * (DISC_OPS + 2 + 2 * T)),
            "two_pass_floor_ms": (nbytes(i, q, prev) + 2 * nbytes(atail)
                                  + 12 * samples) / HBM_BYTES_PER_S * 1e3,
            "audio_bound_ms": b1["bound_ms"], "audio_bound_by": b1["bound_by"],
            "fir_bound_ms": b2["bound_ms"], "fir_bound_by": b2["bound_by"]}


def phase_unpathed_kernels(torch, dev):
    """K9 and K10, which no pipeline path runs, against their twins; their
    launch counts come from this phase."""
    import torch.nn.functional as F

    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.lane_fir import lane_fir, lane_fir_plain

    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    torch.cuda.synchronize()
    cuda.reset_launches()
    results = {"fused_demod_fir": check_demod_fir(torch, dev, randn)}

    # K10 at the experiment's shapes, then edge cases: one tap, 64 taps
    # (the run-time body), an output count that is not a multiple of the
    # tile, rows that are not a multiple of 4 (the 4-byte staging), and a
    # row start off 16 bytes. The same operations in the same order as the
    # twin, so equal bit for bit: compared as int32 patterns, so that a
    # zero's sign counts (a quarter of the inputs are +0, an eighth -0)
    lowpass = design_lowpass(0.1, 1.0, 41)
    cases = (  # label, channels, outputs, taps, first float of the rows
        ("c306", 306, 96000, lowpass, 0), ("c102", 102, 96000, lowpass, 0),
        ("c616", 616, 96000, lowpass, 0),
        ("path", CHANNELS, BLOCK_LEN, lowpass, 0),
        ("t1", 4, 5000, np.float32([-0.75]), 0),
        ("t64", 3, 7001,
         np.random.default_rng(9).normal(size=64).astype(np.float32), 0),
        ("t33-ragged", 5, 3841 * 2 + 7, design_lowpass(0.15, 1.0, 33), 0),
        ("t41-unaligned-rows", 3, 9603, lowpass, 0),
        ("t41-offset", 2, 9600, lowpass, 1))
    bodies = set()
    for label, c, n, h, offset in cases:
        ln = n + len(h) - 1
        flat = randn(c * ln + offset)
        flat[::4] = 0.0
        flat[1::8] = -0.0
        x = flat[offset:].view(c, ln)
        body = "lane_fir:" + ("t41" if len(h) == 41 else "runtime_t")
        before = dict(cuda.body_launches)
        got, want = lane_fir(x, h), lane_fir_plain(x, h)
        torch.cuda.synchronize()
        check(cuda.body_launches.get(body, 0) == before.get(body, 0) + 1,
              f"lane_fir {label}: bodies {cuda.body_launches}, expected "
              f"{body}")
        err = float((got - want).abs().max())
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"lane_fir {label}: not bit-equal to its twin (err {err})")
        bodies.add(body)
        entry = {"phase": "kernel", "name": "lane_fir", "case": label,
                 "shape": [c, n], "taps": len(h), "body": body,
                 "vec_staging": ln % 4 == 0 and x.data_ptr() % 16 == 0,
                 "max_abs_err": err, "tol": 0}
        del got, want
        if label == "path":
            # the library's one call: conv1d (cuDNN, TF32 off)
            w = torch.from_numpy(np.ascontiguousarray(h, np.float32)).to(
                dev)[None, None, :]
            entry.update(
                ms=cuda_ms(torch, lambda: lane_fir(x, h), 20),
                plain_ms=cuda_ms(torch, lambda: lane_fir_plain(x, h), 3),
                library_ms=cuda_ms(torch, lambda: F.conv1d(x[:, None, :], w),
                                   20),
                **bound(nbytes(x) + 4 * c * n, c * n * (2 * len(h) - 1)))
            results["lane_fir"] = entry
        emit(entry)
        del x, flat
    check(bodies == {"lane_fir:t41", "lane_fir:runtime_t"},
          f"lane_fir: bodies launched {bodies}")
    torch.cuda.synchronize()
    launches = {k: cuda.launches[k] for k in ("fused_demod_fir", "lane_fir")}
    torch.cuda.empty_cache()
    return results, launches


def phase_plain_correlation(torch, dev):
    """The plain syncword correlation (every route's but the fused front
    end's) on the card: the kernel (``kernels/lane_fir.py:plain_corr``)
    equals the plain formula, conv1d / L, bit for bit (int32 patterns) in
    each body, float32 and bfloat16 rows, at m10's fleet ring [616, 40048]
    (L = 80 and its alternate's 64, timed beside the formula and the bound)
    and on edge shapes (every family's template length, a run-time length,
    rows not a multiple of 4, a row view off 16 bytes, a zero row against
    an all-negative template). Then it divides by L: on +/-1 chips every
    window sum s is an exact integer, so each output must be float32(s / L)
    correctly rounded, not s * float32(1/L): m10's template (L = 80) over
    one 4 s block of its chips, imet4's three (L = 20) over one of theirs,
    at 2048 channels; the first 64 rows also equal the CPU."""
    from sondetpu_torch.dsp.fir import conv1d
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.lane_fir import (plain_corr, plain_corr_body,
                                                 plain_corr_plain)
    from sondetpu_torch.sondes import imet4, m10
    from sondetpu_torch.sync.correlator import correlate_syncword

    gen = torch.Generator(device=dev).manual_seed(6)
    rng = np.random.default_rng(6)
    results = {}

    def bits(t):
        return t.view(torch.int32)

    def held(label, x, t):
        body = "plain_corr:" + plain_corr_body(len(t))
        before = cuda.body_launches.get(body, 0)
        got, want = plain_corr(x, t), plain_corr_plain(x, t)
        torch.cuda.synchronize()
        check(cuda.body_launches.get(body, 0) == before + 1,
              f"plain_corr {label}: bodies {cuda.body_launches}, expected "
              f"{body}")
        check(torch.equal(bits(got), bits(want)),
              f"plain_corr {label}: not bit-equal to the plain formula "
              f"(err {float((got - want).abs().max())})")
        return body

    m10_t = m10.SPEC.sync_chip_template()
    m10_alt = m10.SPEC.sync_chip_template(m10.SPEC.extra["alt_syncword"])
    c, ln = 616, 40048                       # m10's fleet ring
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = torch.randn((c, ln), generator=gen, device=dev).to(dtype)
        for t in (m10_t, m10_alt):
            L = len(t)
            label = f"m10-fleet-l{L}-{tag}"
            body = held(label, x, t)
            n = ln - L + 1
            entry = {"phase": "kernel", "name": "plain_corr", "case": label,
                     "shape": [c, ln], "taps": L, "body": body,
                     "max_abs_err": 0.0, "tol": 0,
                     "ms": cuda_ms(torch, lambda: plain_corr(x, t), 20),
                     "plain_ms": cuda_ms(torch,
                                         lambda: plain_corr_plain(x, t), 3),
                     **bound(nbytes(x) + 4 * c * n, c * n * (2 * L + 1))}
            results[label] = entry
            emit(entry)
        del x
    sign = {L: (rng.integers(0, 2, size=L) * 2.0 - 1.0).astype(np.float32)
            for L in (16, 20, 24, 32, 64, 80)}
    sign[100] = rng.normal(size=100).astype(np.float32)
    bodies = set()
    for L, t in sign.items():
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for rows, cols, offset in ((5, 3840 * 2 + L + 6, 0),
                                       (3, 4099, 1), (7, 9600, 0)):
                flat = torch.randn(rows * cols + offset, generator=gen,
                                   device=dev)
                flat[::5] = 0.0
                flat[2::9] = -0.0
                x = flat.to(dtype)[offset:].view(rows, cols)
                bodies.add(held(f"l{L}-{tag}-{rows}x{cols}+{offset}", x, t))
            zero = torch.zeros((3, 4000), dtype=dtype, device=dev)
            neg = -np.ones(L, np.float32)
            held(f"zero-row-l{L}-{tag}", zero, neg)
            check(torch.equal(bits(plain_corr(zero, neg)),
                              torch.zeros((3, 4000 - L + 1),
                                          dtype=torch.int32, device=dev)),
                  f"plain_corr zero row l{L} {tag}: not +0")
    check(bodies == {"plain_corr:t80", "plain_corr:t64",
                     "plain_corr:runtime_t"},
          f"plain_corr: bodies launched {bodies}")

    templates = [("m10", m10_t, 38400)]
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
          "divides_by_l": True, "bodies": sorted(bodies)})
    torch.cuda.empty_cache()
    return results


def phase_plain_fir(torch, dev):
    """The plain-op front end's filter on the card: the kernel
    (``kernels/lane_fir.py:plain_fir``, what ``apply_windows`` launches for
    a CUDA tensor) equals ``window_sum``'s eager passes bit for bit (int32
    patterns) at the RS41 plain step's shapes, each timed beside the eager
    passes and the bound: the channel filter [2048, 192040] at stride 2
    (body t41_d2, two a step) and the matched filter [2048, 96040] at
    stride 1 (t41_d1, one a step), float32 and bfloat16 rows with the
    pipeline's own taps; then on edge shapes in every body (run-time tap
    counts, a stride of 3, 300 taps in two chained launches, rows not a
    multiple of 4, a row view off 16 bytes and one with a row stride of
    its own, one output a row)."""
    from sondetpu_torch.dsp.fir import window_sum
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.lane_fir import plain_fir, plain_fir_body
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig

    gen = torch.Generator(device=dev).manual_seed(24)
    rs41 = Pipeline(PipelineConfig(sonde="rs41", channels=8,
                                   block_len=BLOCK_LEN), "cpu")
    results = {}

    def bits(t):
        return t.view(torch.int32)

    def held(label, x, h, stride):
        body = "plain_fir:" + plain_fir_body(len(h), stride)
        before = cuda.body_launches.get(body, 0)
        got, want = plain_fir(x, h, stride), window_sum(x, h, stride)
        torch.cuda.synchronize()
        check(cuda.body_launches.get(body, 0) == before + 1,
              f"plain_fir {label}: bodies {cuda.body_launches}, expected "
              f"{body}")
        check(torch.equal(bits(got), bits(want)),
              f"plain_fir {label}: not bit-equal to window_sum (err "
              f"{float((got - want).abs().max())})")
        return body

    h = rs41.config.ntaps - 1
    for name, taps, stride, ln in (
            ("chanfilt", rs41._chan_taps, 2, BLOCK_LEN + h),
            ("matched", rs41._taps, 1, BLOCK_LEN // 2 + h)):
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = torch.randn((CHANNELS, ln), generator=gen,
                            device=dev).to(dtype)
            label = f"rs41-{name}-{tag}"
            body = held(label, x, taps, stride)
            n = (ln - len(taps)) // stride + 1
            entry = {"phase": "kernel", "name": "plain_fir", "case": label,
                     "shape": [CHANNELS, ln], "taps": len(taps),
                     "stride": stride, "body": body, "max_abs_err": 0.0,
                     "tol": 0,
                     "ms": cuda_ms(torch, lambda: plain_fir(x, taps, stride),
                                   20),
                     "plain_ms": cuda_ms(torch, lambda: window_sum(
                         x, taps, stride), 3),
                     **bound(nbytes(x) + 4 * CHANNELS * n,
                             CHANNELS * n * 2 * len(taps))}
            results[label] = entry
            emit(entry)
            del x
    rng = np.random.default_rng(24)
    bodies = set()
    for ntaps, stride in ((41, 2), (41, 1), (20, 1), (40, 2), (23, 2),
                          (7, 3), (300, 2)):
        taps = rng.normal(size=ntaps).astype(np.float32)
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for rows, cols, offset in ((5, stride * 2 * 3840 + ntaps + 6, 0),
                                       (3, 4099, 1), (7, 9600, 0),
                                       (2, ntaps, 0)):
                flat = torch.randn(rows * cols + offset, generator=gen,
                                   device=dev)
                flat[::5] = 0.0
                flat[2::9] = -0.0
                x = flat.to(dtype)[offset:].view(rows, cols)
                bodies.add(held(f"t{ntaps}-d{stride}-{tag}-{rows}x{cols}"
                                f"+{offset}", x, taps, stride))
            wide = torch.randn((4, 5000), generator=gen, device=dev).to(dtype)
            held(f"t{ntaps}-d{stride}-{tag}-row-stride", wide[:, 3:4003],
                 taps, stride)
    check(bodies == {"plain_fir:t41_d2", "plain_fir:t41_d1",
                     "plain_fir:runtime_t"},
          f"plain_fir: bodies launched {bodies}")
    emit({"phase": "plain_fir", "bodies": sorted(bodies),
          "bit_equal_to_window_sum": True})
    torch.cuda.empty_cache()
    return results


def phase_afsk_path(torch, dev, family: str, n_blocks: int,
                    use_pallas: bool = True):
    """One AFSK family through DecoderSession at 2048 channels x 4 s, the
    same signal on every channel; with use_pallas False the jnp AFSK front
    end (the JAX CLI's default), which launches no hand kernel but the
    plain correlation's and the plain filter's."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    cfg = PipelineConfig(sonde=family, channels=CHANNELS,
                         block_len=BLOCK_LEN, use_pallas=use_pallas,
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
    bodies = dict(cuda.body_launches)
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
    win = AFSK_TONES[family][2]
    if not use_pallas:
        check(pipe._route is None and len(sess.state.aux) == 5
              and sess.state.aux[4].dtype == torch.int32,
              f"plain {family} path: not the jnp AFSK front end")
        check(plain_kernels_only(launches, cfg, n_blocks),
              f"plain {family} path: hand kernels launched {launches}")
    else:
        # the identity matched taps take the front end's identity body; the
        # AFSK path correlates with the plain correlation, not K2
        check(bodies == {"fused_frontend:decim1_t41_identity": n_blocks,
                         f"fused_afsk_frontend:win{win}": n_blocks,
                         **plain_route_bodies(cfg, n_blocks)},
              f"{family} path: bodies {bodies}")
    emit({"phase": "afsk_path" if use_pallas else "plain_afsk_path",
          "sonde": family, "channels": CHANNELS, "use_pallas": use_pallas,
          "block_len": BLOCK_LEN, "blocks": n_blocks,
          "k_slots": cfg.k_slots, "frames_raw": m.frames_raw,
          "frames_decoded": m.frames_decoded,
          "frames_per_channel": m.frames_decoded // CHANNELS,
          "telemetry": {f: ref.get(f) for f in
                        ("serial", "lat", "lon", "alt", "temp", "aux_data")},
          "process_block_seconds": block_seconds,
          "launches": {k: v for k, v in launches.items() if v},
          "body_launches": bodies})
    return pipe, blocks, {"launches": launches, "bodies": bodies,
                          "steps": n_blocks}


def phase_afsk_distinct(torch, dev, n_blocks: int = 3,
                        use_pallas: bool = True):
    """Per family, 8 channels carrying four distinct truths: the card
    equals the CPU (twins) on validity, valid frame bytes and telemetry,
    and each channel reports its own truth; with use_pallas False on the
    jnp AFSK front end, no hand kernel launched but the plain
    correlation and the plain filter."""
    from sondetpu_torch.kernels import cuda
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
                             use_pallas=use_pallas, compute_dtype="f32",
                             input_dtype="i16")
        gpu, cpu = Pipeline(cfg, dev), Pipeline(cfg, "cpu")
        sg, sc = gpu.init_state(), cpu.init_state()
        cuda.reset_launches()
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
        if not use_pallas:
            check(plain_kernels_only(cuda.launches, cfg, 2 * n_blocks),
                  f"plain {family} distinct: launches {cuda.launches}")
        out[family] = {"valid_frames": frames,
                       "frames_decoded": gsess.metrics.frames_decoded}
    emit({"phase": "afsk_distinct" if use_pallas else "plain_afsk_distinct",
          "channels": c, "blocks": n_blocks, "use_pallas": use_pallas,
          "families": out, "matches_cpu": True})


# the dual-tone families on their paths: ims100 and mrzn1 keep K7's
# channel filter (20 kHz channels) and take midpoint DC; m10 skips it.
# m10's four truth sets are these serials
M10_SERIALS = ("910-2-12345", "A05-3-54321", "C12-1-00042", "D03-2-00117")


def dualtone_planes(family: str, n: int, seed: int, noise: float = 0.04,
                    k: int = 0):
    """int16 (i, q) planes [n] of back-to-back ``family`` frames from the
    port's modulator (truth set ``k``: ims100 serial 2136051 + k, lat 35.7
    + k; mrzn1 serial_lo 42 + k, lat 55.8 + k; m10 M10_SERIALS[k]),
    with complex noise of std ``noise`` per component, quantized to
    cs16."""
    from sondetpu_torch.sondes.ims100 import IMS100Modulator, IMS100Truth
    from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
    from sondetpu_torch.sondes.mrzn1 import MRZN1Modulator, MRZN1Truth

    if family == "ims100":
        iq = IMS100Modulator().modulate(
            [IMS100Truth(serial=str(2136051 + k), frame_no=2 + i,
                         lat=35.7 + k) for i in range(n // 11520 + 2)],
            fs=FS)
    elif family == "mrzn1":
        iq = MRZN1Modulator().modulate(
            [MRZN1Truth(serial_lo=42 + k, frame_no=1 + i, lat=55.8 + k)
             for i in range(n // 5120 + 2)], fs=FS)
    else:
        iq = M10Modulator().modulate(
            [M10Truth(serial=M10_SERIALS[k], frame_no=5 + i)
             for i in range(n // 8000 + 2)], fs=FS)
    iq = iq[:n]
    rng = np.random.default_rng(seed)
    noisy = iq + (rng.normal(size=n) + 1j * rng.normal(size=n)
                  ).astype(np.complex64) * noise
    return tuple(np.clip(x * 32767, -32768, 32767).astype(np.int16)
                 for x in (noisy.real, noisy.imag))


def dualtone_truth(family: str, t, k: int = 0) -> bool:
    """The decoded telemetry ``t`` is truth set ``k`` of dualtone_planes."""
    if family == "ims100":
        return (t.serial == str(2136051 + k)
                and abs(t.lat - 35.7 - k) <= 1e-5
                and abs(t.lon - 139.7) <= 1e-5
                and abs(t.alt - 18000.0) <= 0.01
                and abs(t.temp + 60.0) <= 0.01 and abs(t.rh - 8.0) <= 0.01)
    if family == "mrzn1":
        return (t.serial == f"MRZ-{42 + k:03d}"
                and abs(t.lat - 55.8 - k) <= 1e-6
                and abs(t.alt - 9000.0) <= 0.01
                and abs(t.temp + 35.0) <= 0.01)
    return t.serial == M10_SERIALS[k] and abs(t.lat - 52.2) <= 1e-4


def time_midpoint(torch, pipe, planes, reps: int = 5):
    """The midpoint DC alone on the metric of one block: K7 on the
    dequantized planes, then midpoint_dc timed with CUDA events (ms), and
    that call's peak device memory beside the metric's."""
    from sondetpu_torch.kernels.dualtone import fused_dualtone_frontend
    from sondetpu_torch.runtime.pipeline import midpoint_dc

    scale = float(np.float32(1.0 / 32768.0))
    i, q = (p.to(torch.float32) * scale for p in planes)
    st = pipe.init_state()
    met = fused_dualtone_frontend(
        i, q, st.chan_tail_i, st.chan_tail_q, pipe._chan_taps,
        pipe._mix_cos, pipe._mix_sin, pipe._nb,
        skip_chanfilt=pipe._skip_chanfilt)[0]
    del i, q
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: midpoint_dc(met), reps)
    extra = torch.cuda.max_memory_allocated() - base
    return {"midpoint_ms": ms, "midpoint_extra_bytes": extra,
            "metric_bytes": nbytes(met), "metric_shape": list(met.shape)}


def phase_dualtone_path(torch, dev, family: str, n_blocks: int, smi):
    """ims100 or mrzn1 on the kernel path through DecoderSession at 2048
    channels x 4 s, one signal on every channel: the truth's telemetry on
    every channel, K7's channel-filter body and the plain correlation once
    a step and nothing else; then the steady step, the midpoint DC alone
    and peak device memory."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    cfg = PipelineConfig(sonde=family, channels=CHANNELS,
                         block_len=BLOCK_LEN, use_pallas=True,
                         compute_dtype="f32", input_dtype="i16")
    qi, qq = dualtone_planes(family, n_blocks * BLOCK_LEN, seed=9)
    row_i = torch.from_numpy(qi).to(dev)
    row_q = torch.from_numpy(qq).to(dev)
    blocks = [(row_i[None, b * BLOCK_LEN:(b + 1) * BLOCK_LEN]
               .expand(CHANNELS, -1).contiguous(),
               row_q[None, b * BLOCK_LEN:(b + 1) * BLOCK_LEN]
               .expand(CHANNELS, -1).contiguous()) for b in range(n_blocks)]
    pipe = Pipeline(cfg, dev)
    check(pipe._dualtone and pipe._midpoint and not pipe._skip_chanfilt
          and not pipe._plain, f"{family} path: not K7 with its channel "
          "filter and midpoint DC")
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
    bodies = dict(cuda.body_launches)
    m = sess.metrics
    label = f"{family} path"
    check(m.frames_decoded > 0, f"{label}: no frames decoded")
    check(sorted(sess.telemetry) == list(range(CHANNELS)),
          f"{label}: channels without telemetry")
    t = sess.telemetry[0]
    ref = t.to_dict()
    ref_text = json.dumps(ref, sort_keys=True)
    check(all(json.dumps(sess.telemetry[ch].to_dict(), sort_keys=True)
              == ref_text for ch in range(CHANNELS)),
          f"{label}: telemetry differs between identical channels")
    check(dualtone_truth(family, t), f"{label}: telemetry {ref}")
    corr = plain_route_bodies(cfg, n_blocks)
    check(launches["fused_dualtone_frontend"] == n_blocks
          and sum(launches.values()) == n_blocks + sum(corr.values()),
          f"{label}: launches {launches}")
    check(bodies == {"fused_dualtone_frontend:chanfilt_t41_nb20": n_blocks,
                     **corr},
          f"{label}: bodies {bodies}")
    emit({"phase": f"{family}_path", "sonde": family, "channels": CHANNELS,
          "block_len": BLOCK_LEN, "blocks": n_blocks,
          "k_slots": cfg.k_slots,
          "frames_raw": m.frames_raw, "frames_decoded": m.frames_decoded,
          "frames_per_channel": m.frames_decoded / CHANNELS,
          "telemetry": {f: ref.get(f) for f in
                        ("serial", "lat", "lon", "alt", "temp", "rh")},
          "process_block_seconds": block_seconds,
          "launches": {k: v for k, v in launches.items() if v},
          "body_launches": bodies})
    step_ms = phase_step(torch, pipe, blocks, phase=f"{family}_step",
                         smi=smi)
    mid = time_midpoint(torch, pipe, blocks[0])
    emit({"phase": f"{family}_midpoint", "sonde": family,
          "step_ms_median": step_ms, **mid, "nvidia_smi": smi})
    return {"launches": launches, "bodies": bodies, "steps": n_blocks,
            "step_ms": step_ms, **mid}


def distinct_rows(family: str, c: int, n_blocks: int, truths: int):
    """int16 (i, q) [c, n_blocks * BLOCK_LEN]: channel ch carries truth set
    ch % truths of dualtone_planes with its own noise."""
    sig = [dualtone_planes(family, n_blocks * BLOCK_LEN, seed=30 + k, k=k)
           for k in range(truths)]
    return (np.stack([sig[ch % truths][0] for ch in range(c)]),
            np.stack([sig[ch % truths][1] for ch in range(c)]))


def card_equals_cpu(torch, dev, cfg, qi, qq, n_blocks, truths, label):
    """Steps the pipeline and the session on the card and on the CPU over
    the blocks: validity and valid frame bytes equal block by block, the
    telemetry equal and each channel's its truth's. Returns (valid frames,
    frames decoded on the card, launches on the card by body: two a block,
    the pipeline's step and the session's)."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline
    from sondetpu_torch.runtime.session import DecoderSession

    c = cfg.channels
    gpu, cpu = Pipeline(cfg, dev), Pipeline(cfg, "cpu")
    sg, sc = gpu.init_state(), cpu.init_state()
    gsess = DecoderSession(cfg, dev, pipeline=gpu)
    csess = DecoderSession(cfg, "cpu", pipeline=cpu)
    torch.cuda.synchronize()
    cuda.reset_launches()
    frames = 0
    for b in range(n_blocks):
        sl = slice(b * BLOCK_LEN, (b + 1) * BLOCK_LEN)
        sg, og = gpu.step(sg, (qi[:, sl], qq[:, sl]))
        sc, oc = cpu.step(sc, (qi[:, sl], qq[:, sl]))
        vg, vc = og.frame_valid.cpu(), oc.frame_valid
        check(torch.equal(vg, vc), f"{label} block {b}: validity differs "
              "from CPU")
        check(torch.equal(og.frames.cpu()[vg], oc.frames[vc]),
              f"{label} block {b}: frame bytes differ from CPU")
        frames += int(vg.sum())
        gsess.process_block((qi[:, sl], qq[:, sl]))
        csess.process_block((qi[:, sl], qq[:, sl]))
    torch.cuda.synchronize()
    bodies = dict(cuda.body_launches)
    for ch in range(c):
        tg, tc = gsess.telemetry.get(ch), csess.telemetry.get(ch)
        check(tg is not None and tc is not None
              and json.dumps(tg.to_dict(), sort_keys=True)
              == json.dumps(tc.to_dict(), sort_keys=True),
              f"{label} channel {ch}: telemetry differs from the CPU")
        check(dualtone_truth(cfg.sonde, tg, ch % truths),
              f"{label} channel {ch}: telemetry {tg.to_dict()}")
    return frames, gsess.metrics.frames_decoded, bodies


def phase_dualtone_distinct(torch, dev, n_blocks: int = 3):
    """ims100 and mrzn1 on the kernel path, 8 channels carrying four
    truths, with and without afc: the card equals the CPU (twins) on
    validity, valid frame bytes and telemetry, each channel its truth,
    K7's chanfilt_t41_nb20 body (its _afc body with afc) and the plain
    correlation once a step."""
    from sondetpu_torch.runtime.pipeline import PipelineConfig

    c, out = 8, {}
    for family in ("ims100", "mrzn1"):
        qi, qq = distinct_rows(family, c, n_blocks, 4)
        for afc in (False, True):
            cfg = PipelineConfig(sonde=family, channels=c,
                                 block_len=BLOCK_LEN, use_pallas=True,
                                 compute_dtype="f32", input_dtype="i16",
                                 afc=afc)
            label = f"{family}{' afc' if afc else ''}"
            frames, decoded, bodies = card_equals_cpu(
                torch, dev, cfg, qi, qq, n_blocks, 4, label)
            body = ("fused_dualtone_frontend:chanfilt_t41_nb20"
                    + ("_afc" if afc else ""))
            check(bodies == {body: 2 * n_blocks,
                             **plain_route_bodies(cfg, 2 * n_blocks)},
                  f"{label}: bodies {bodies}")
            out[label] = {"valid_frames": frames, "frames_decoded": decoded}
    emit({"phase": "dualtone_distinct", "channels": c, "blocks": n_blocks,
          "block_len": BLOCK_LEN, "runs": out, "matches_cpu": True})


def phase_plain_dualtone(torch, dev, smi, n_blocks: int = 2):
    """The plain-op dual-tone step (use_pallas=False; the JAX CLI's
    default) for m10, ims100 and mrzn1 in f32 and bf16 at 8 channels with
    four truths, card against CPU as in dualtone_distinct, no hand kernel
    launched but the plain correlation; then the 2048-channel m10 bf16
    plain step (one signal on
    every channel): its valid frames, steady step and peak memory."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig

    c, out = 8, {}
    for family in ("m10", "ims100", "mrzn1"):
        qi, qq = distinct_rows(family, c, n_blocks, 4)
        for dtype in ("f32", "bf16"):
            cfg = PipelineConfig(sonde=family, channels=c,
                                 block_len=BLOCK_LEN, use_pallas=False,
                                 compute_dtype=dtype, input_dtype="i16")
            label = f"plain {family} {dtype}"
            frames, decoded, bodies = card_equals_cpu(
                torch, dev, cfg, qi, qq, n_blocks, 4, label)
            check(bodies == plain_route_bodies(cfg, 2 * n_blocks)
                  and plain_kernels_only(cuda.launches, cfg, 2 * n_blocks),
                  f"{label}: hand kernels launched {cuda.launches}")
            out[f"{family}_{dtype}"] = {"valid_frames": frames,
                                        "frames_decoded": decoded}
    emit({"phase": "plain_dualtone", "channels": c, "blocks": n_blocks,
          "block_len": BLOCK_LEN, "runs": out, "matches_cpu": True})
    cfg = PipelineConfig(sonde="m10", channels=CHANNELS, block_len=BLOCK_LEN,
                         use_pallas=False, compute_dtype="bf16",
                         input_dtype="i16")
    qi, qq = dualtone_planes("m10", 3 * BLOCK_LEN, seed=9)
    row_i = torch.from_numpy(qi).to(dev)
    row_q = torch.from_numpy(qq).to(dev)
    blocks = [(row_i[None, b * BLOCK_LEN:(b + 1) * BLOCK_LEN]
               .expand(CHANNELS, -1).contiguous(),
               row_q[None, b * BLOCK_LEN:(b + 1) * BLOCK_LEN]
               .expand(CHANNELS, -1).contiguous()) for b in range(3)]
    pipe = Pipeline(cfg, dev)
    cuda.reset_launches()
    state = pipe.init_state()
    valid = []
    for planes in blocks:
        state, o = pipe.step(state, planes)
        valid.append(int(o.frame_valid.sum()))
    torch.cuda.synchronize()
    check(plain_kernels_only(cuda.launches, cfg, len(blocks)),
          f"plain m10 bf16 2048: hand kernels launched {cuda.launches}")
    check(state.chipbuf.dtype == torch.bfloat16 and valid[-1] > 0
          and valid[-1] % CHANNELS == 0,
          f"plain m10 bf16 2048: valid frames per block {valid}")
    emit({"phase": "plain_dualtone_m10_2048", "valid_frames_per_block": valid})
    phase_step(torch, pipe, blocks, phase="plain_dualtone_step", smi=smi)


def ddc_blocks(torch, dev, n_blocks: int):
    """int16 (i, q) blocks [CHANNELS, BLOCK_LEN] on the card: the RS41
    signal of rs41_planes (one row) moved off the channel centre by each of
    DDC_OFFSETS (rotated in float64 on the card, quantized to cs16 again),
    channel ch carrying offset ch % 16."""
    qi, qq = rs41_planes("S1234567", n_blocks, seed=0)
    n = qi.size
    xi = torch.from_numpy(qi).to(dev, torch.float64)
    xq = torch.from_numpy(qq).to(dev, torch.float64)
    offs = torch.tensor(DDC_OFFSETS, dtype=torch.float64, device=dev)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    cyc = torch.remainder(offs[:, None] * t / FS, 1.0)
    c, s = torch.cos(2.0 * np.pi * cyc), torch.sin(2.0 * np.pi * cyc)
    rot = [torch.round(r).clamp(-32768, 32767).to(torch.int16)
           for r in (xi * c - xq * s, xi * s + xq * c)]
    del cyc, c, s
    rows = torch.arange(CHANNELS, device=dev) % len(DDC_OFFSETS)
    return [tuple(r[:, b * BLOCK_LEN:(b + 1) * BLOCK_LEN].index_select(0, rows)
                  .contiguous() for r in rot) for b in range(n_blocks)]


def alternate_steps(torch, pipes, blocks, rounds: int = 6, per: int = 2):
    """Steady-state step times (ms) of each pipeline on the same blocks,
    taken in turns (a, b, b, a, ...) so that both meet the same card."""
    states = [p.init_state() for p in pipes]
    for k, p in enumerate(pipes):               # warm-up
        for planes in blocks[:2]:
            states[k], _ = p.step(states[k], planes)
    torch.cuda.synchronize()
    times = [[] for _ in pipes]
    for r in range(rounds):
        order = range(len(pipes)) if r % 2 == 0 else reversed(range(len(pipes)))
        for k in order:
            for j in range(per):
                t0 = time.perf_counter()
                states[k], _ = pipes[k].step(states[k],
                                             blocks[(r * per + j) % len(blocks)])
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def phase_ddc_afc_path(torch, dev, main_step_ms, smi, n_blocks: int = 3):
    """The RS41 kernel path at 2048 channels x 4 s with every channel off
    the channel centre (DDC_OFFSETS, beyond the channel filter's 5 kHz
    without the DDC), fine_offsets and the AFC loop on: decoded telemetry
    on every channel, each tracked frequency near its offset, K1-K3
    launched; then the device step with and without the DDC in turns, the
    DDC alone, and peak device memory."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    offsets = tuple(DDC_OFFSETS[ch % len(DDC_OFFSETS)]
                    for ch in range(CHANNELS))
    base = dict(sonde="rs41", channels=CHANNELS, block_len=BLOCK_LEN,
                use_pallas=True, input_dtype="i16")
    cfg = PipelineConfig(**base, fine_offsets=offsets, afc=True)
    blocks = ddc_blocks(torch, dev, n_blocks)
    pipe = Pipeline(cfg, dev)
    sess = DecoderSession(cfg, dev, pipeline=pipe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    block_seconds = []
    for planes in blocks:
        t0 = time.perf_counter()
        sess.process_block(planes)
        block_seconds.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    bodies = dict(cuda.body_launches)
    session_peak = torch.cuda.max_memory_allocated()
    m = sess.metrics
    check(sorted(sess.telemetry) == list(range(CHANNELS)),
          f"ddc_afc_path: {CHANNELS - len(sess.telemetry)} channels without "
          "telemetry")
    ref = sess.telemetry[0].to_dict()
    check(ref.get("serial") == "S1234567", f"ddc_afc_path: telemetry {ref}")
    ref_text = json.dumps(ref, sort_keys=True)
    same = sum(json.dumps(sess.telemetry[ch].to_dict(), sort_keys=True)
               == ref_text for ch in range(CHANNELS))
    check(same == CHANNELS, f"ddc_afc_path: telemetry differs between "
          f"channels ({same} of {CHANNELS} equal channel 0's)")
    dist = np.abs(sess.afc_freqs - np.asarray(offsets, np.float32))
    check(float(dist.max()) <= DDC_AFC_HZ, f"ddc_afc_path: a tracked "
          f"frequency is {float(dist.max())} Hz from its offset")
    for name in ("fused_frontend", "corr", "rs_clean"):
        check(launches[name] == n_blocks,
              f"ddc_afc_path: kernel {name} launched {launches[name]} times")
    check(bodies == {"fused_frontend:decim2_t41": n_blocks,
                     "corr:sign_l64": n_blocks, "rs_clean:c384": n_blocks},
          f"ddc_afc_path: bodies {bodies}")
    # the step with and without the DDC (the same pipeline without
    # fine_offsets and afc), in turns on the same blocks
    plain = Pipeline(PipelineConfig(**base), dev)
    torch.cuda.reset_peak_memory_stats()
    t_ddc, t_plain = alternate_steps(torch, [pipe, plain], blocks)
    step_peak = torch.cuda.max_memory_allocated()
    # the DDC alone on one dequantized block, and what it must move: two
    # float32 planes in, two out
    qs = float(np.float32(1.0 / 32768.0))
    iq = [x.to(torch.float32) * qs for x in blocks[0]]
    st = sess.state
    ddc_ms = cuda_ms(torch, lambda: pipe._downconvert(
        iq[0], iq[1], st.aux[-1], st.aux[-2]), 10)
    ddc_bound_ms = 2 * nbytes(*iq) / HBM_BYTES_PER_S * 1e3
    ddc_med, plain_med = statistics.median(t_ddc), statistics.median(t_plain)
    emit({"phase": "ddc_afc_path", "sonde": "rs41", "channels": CHANNELS,
          "block_len": BLOCK_LEN, "blocks": n_blocks,
          "offsets_hz": list(DDC_OFFSETS), "afc": True,
          "frames_raw": m.frames_raw, "frames_decoded": m.frames_decoded,
          "frames_per_channel": m.frames_decoded / CHANNELS,
          "serial": ref.get("serial"), "lat": ref.get("lat"),
          "afc_hz_from_offset_max": float(dist.max()),
          "afc_hz_from_offset_mean": float(dist.mean()),
          "afc_tol_hz": DDC_AFC_HZ,
          "launches": {k: v for k, v in launches.items() if v},
          "body_launches": bodies, "process_block_seconds": block_seconds,
          "step_ms_median_ddc_afc": ddc_med,
          "step_ms_median_no_ddc": plain_med,
          "step_ms_ddc_afc": t_ddc, "step_ms_no_ddc": t_plain,
          "main_path_step_ms_median": main_step_ms,
          "ddc_cost_ms": ddc_med - plain_med, "ddc_alone_ms": ddc_ms,
          "ddc_bytes_bound_ms": ddc_bound_ms,
          "max_memory_allocated_bytes_session": session_peak,
          "max_memory_allocated_bytes_steps": step_peak, "nvidia_smi": smi})
    return {"launches": launches, "bodies": bodies, "steps": n_blocks}


def afc_signal(case: str):
    """complex64 [n] of one AFC case, as tests/test_afc.py builds it:
    rs41 drifting 1 -> 6.5 kHz (16 frames, cut to whole blocks); imet4
    drifting 0 -> 14 kHz (16 frames, zero-padded to whole blocks); m10 at a
    fixed +800 Hz (30 frames, cut to whole blocks)."""
    from sondetpu_torch.sondes.imet4 import IMET4Modulator, IMET4Truth
    from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
    from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth

    blk = int(FS)
    if case == "rs41":
        iq = RS41Modulator().modulate([RS41Truth(frame_no=i)
                                       for i in range(16)], fs=FS)
        f0, f1, noise, seed = 1000.0, 6500.0, 0.05, 0
    elif case == "imet4":
        iq = IMET4Modulator().modulate([IMET4Truth(frame_no=i)
                                        for i in range(16)], fs=FS)
        f0, f1, noise, seed = 0.0, 14000.0, 0.03, 3
    else:
        iq = M10Modulator().modulate([M10Truth(frame_no=i)
                                      for i in range(30)], fs=FS)
        f0, f1, noise, seed = 800.0, 800.0, 0.05, 0
    n = iq.size
    finst = f0 + (f1 - f0) * np.arange(n) / n
    sig = (iq * np.exp(2j * np.pi * np.cumsum(finst) / FS)).astype(np.complex64)
    rng = np.random.default_rng(seed)
    sig = sig + (noise * (rng.normal(size=n) + 1j * rng.normal(size=n))
                 ).astype(np.complex64)
    if case == "imet4":
        return np.pad(sig, (0, (-n) % blk))
    return sig[:n // blk * blk]


def phase_afc_drift(torch, dev, c: int = 64):
    """The AFC cases of tests/test_afc.py on the kernel path, each signal
    on c channels at 1 s blocks, with afc and without: with it, each
    channel decodes more frames than without by the original's margin
    (rs41 2, imet4 4) and ends with its tracked frequency in the original's
    window; m10 (the dual-tone path) pulls toward +800 Hz and launches K7's
    AFC body."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    blk = int(FS)
    cases = {"rs41": (2, (4000.0, 6500.0), {}),
             "imet4": (4, (9000.0, 14500.0), {"afc_max_hz": 20000.0}),
             "m10": (None, (400.0, 1200.0), {})}
    out, run = {}, None
    for case, (margin, (lo, hi), kw) in cases.items():
        sig = afc_signal(case)
        n_blocks = sig.size // blk
        planes = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
                  for x in (sig.real, sig.imag)]
        decoded = {}
        for afc in ((True, False) if margin is not None else (True,)):
            cfg = PipelineConfig(sonde=case, channels=c, block_len=blk,
                                 use_pallas=True, afc=afc, **kw)
            sess = DecoderSession(cfg, dev)
            torch.cuda.synchronize()
            cuda.reset_launches()
            for b in range(n_blocks):
                sess.process_block(tuple(
                    x[None, b * blk:(b + 1) * blk].expand(c, -1).contiguous()
                    for x in planes))
            torch.cuda.synchronize()
            decoded[afc] = sess.metrics.frames_decoded
            if afc:
                freqs = sess.afc_freqs
                launches = dict(cuda.launches)
                bodies = dict(cuda.body_launches)
        check(((lo < freqs) & (freqs < hi)).all(),
              f"afc_drift {case}: tracked {freqs.min()}..{freqs.max()} Hz, "
              f"outside ({lo}, {hi})")
        if margin is not None:
            check(decoded[True] >= decoded[False] + margin * c,
                  f"afc_drift {case}: {decoded[True]} frames with afc, "
                  f"{decoded[False]} without (margin {margin} a channel)")
        else:
            check(decoded[True] > 0, f"afc_drift {case}: no frames decoded")
            check(bodies.get("fused_dualtone_frontend:skip_nb5_afc")
                  == n_blocks, f"afc_drift m10: K7 bodies {bodies}")
            run = {"launches": launches, "bodies": bodies, "steps": n_blocks}
        out[case] = {"blocks": n_blocks,
                     "frames_decoded_afc": decoded[True],
                     "frames_decoded_static": decoded.get(False),
                     "afc_hz_min": float(freqs.min()),
                     "afc_hz_max": float(freqs.max()), "window": [lo, hi],
                     "body_launches": bodies}
    emit({"phase": "afc_drift", "channels": c, "block_len": blk,
          "cases": out})
    return run


def phase_fleet_offgrid(torch, dev, n_bins: int = 16, n_blocks: int = 3):
    """A 16-bin fleet with an rs41, an m10 and a dfm carrier off the PFB
    grid, each mapped to its bin and residual by bin_and_offset, afc on,
    pipelined, on the card and on the CPU (twins): every serial decodes,
    each block's validity and valid frame bytes, the telemetry and the
    tracked frequencies equal the CPU's."""
    from sondetpu_torch.dsp.channelizer import bin_and_offset
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession
    from sondetpu_torch.runtime.pipeline import unpack_block_output
    from sondetpu_torch.sondes.modulate import freq_shift

    fs_wide = n_bins * FS
    w = n_bins * int(FS)
    n = n_blocks * w
    wide = np.zeros(n, np.complex64)
    plan = []
    for i, (family, serial, center) in enumerate(OFFGRID_CARRIERS):
        k, off = bin_and_offset(center, FS, n_bins)
        plan.append((k, off, family, serial))
        wide += freq_shift(narrowband(family, serial, n, fs_wide),
                           center / fs_wide)
    rng = np.random.default_rng(12)
    wide += (0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
             ).astype(np.complex64)
    check(all(off != 0.0 for _, off, _, _ in plan),
          f"fleet_offgrid: a carrier on the grid {plan}")
    chans = [FleetChannel(pfb_bin=k, sonde=f, offset_hz=off)
             for k, off, f, _ in plan]
    kw = dict(fs_chan=FS, block_len=int(FS), afc=True, pipelined=True)
    gpu = FleetSession(chans, n_bins, dev, **kw)
    cpu = FleetSession(chans, n_bins, "cpu", **kw)
    torch.cuda.synchronize()
    cuda.reset_launches()
    valid = {}
    for b in range(n_blocks):
        x = wide[b * w:(b + 1) * w]
        planes = (np.ascontiguousarray(x.real, np.float32),
                  np.ascontiguousarray(x.imag, np.float32))
        gpu.process_wideband(planes)
        cpu.process_wideband(planes)
        (pg, fg), (pc, fc) = gpu._pending, cpu._pending
        hg, hc = pg.cpu().numpy(), pc.numpy()
        off = 0
        for (sonde, _, sess), frg, frc in zip(gpu._order, fg, fc):
            cfg = sess.config
            size = cfg.channels * cfg.packed_row_bytes
            ug, uc = (unpack_block_output(h[off:off + size], cfg.k_slots,
                                          cfg.wire_ncols, cfg.chase_total)
                      for h in (hg, hc))
            off += size
            v = uc[1]
            check(np.array_equal(ug[1], v),
                  f"fleet_offgrid block {b} {sonde}: validity differs")
            check(torch.equal(frg.cpu()[torch.from_numpy(v)],
                              frc[torch.from_numpy(v)]),
                  f"fleet_offgrid block {b} {sonde}: frame bytes differ")
            valid[sonde] = valid.get(sonde, 0) + int(v.sum())
    gpu.flush()
    cpu.flush()
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    bodies = dict(cuda.body_launches)
    tg, tc = gpu.telemetry, cpu.telemetry
    for i, (_, _, family, serial) in enumerate(plan):
        check(i in tg and tg[i].serial == serial,
              f"fleet_offgrid: channel {i} ({family}) telemetry {tg.get(i)}")
        check(json.dumps(tg[i].to_dict(), sort_keys=True)
              == json.dumps(tc[i].to_dict(), sort_keys=True),
              f"fleet_offgrid: channel {i} telemetry differs from the CPU")
    freqs = {}
    for sonde, (idxs, sess) in gpu.groups.items():
        # the real rows: the pad rows repeat the group's first bin without
        # its offset, so they carry no centred signal
        fg_, fc_ = (s.afc_freqs[:len(idxs)] for s in
                    (sess, cpu.groups[sonde][1]))
        err = float(np.abs(fg_ - fc_).max())
        check(err <= FLEET_AFC_HZ, f"fleet_offgrid {sonde}: tracked "
              f"frequencies {fg_} differ from the CPU's {fc_}")
        freqs[sonde] = {"seed_hz": sess.config.fine_offsets[0],
                        "card_hz": float(fg_[0]), "cpu_hz": float(fc_[0]),
                        "err_hz": err}
    check(bodies.get("fused_dualtone_frontend:skip_nb5_afc") == n_blocks,
          f"fleet_offgrid: K7 bodies {bodies}")
    emit({"phase": "fleet_offgrid", "bins": n_bins, "blocks": n_blocks,
          "carriers": [{"bin": k, "offset_hz": off, "sonde": f, "serial": s}
                       for k, off, f, s in plan],
          "valid_frames": valid, "matches_cpu": True, "afc": freqs,
          "afc_tol_hz": FLEET_AFC_HZ, "body_launches": bodies})
    return {"launches": launches, "bodies": bodies, "steps": n_blocks}


def phase_session_workers(torch, dev, blocks, workers: int = 8):
    """The RS41 session at 2048 channels with host_workers=0 and with
    ``workers`` threads, block by block in turns: identical telemetry, and
    each one's process_block wall times."""
    from sondetpu_torch.runtime.pipeline import PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    cfg = PipelineConfig(sonde="rs41", channels=CHANNELS, block_len=BLOCK_LEN,
                         use_pallas=True, input_dtype="i16")
    sessions = {0: DecoderSession(cfg, dev),
                workers: DecoderSession(cfg, dev, host_workers=workers)}
    wall = {k: [] for k in sessions}
    for b, planes in enumerate(blocks):
        for k in (sorted(sessions) if b % 2 == 0
                  else sorted(sessions, reverse=True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sessions[k].process_block(planes)
            wall[k].append(time.perf_counter() - t0)
    text = {k: {ch: json.dumps(t.to_dict(), sort_keys=True)
                for ch, t in s.telemetry.items()}
            for k, s in sessions.items()}
    sessions[workers].close()
    check(len(text[0]) == CHANNELS and text[0] == text[workers],
          "session_workers: telemetry differs between 0 and "
          f"{workers} host workers")
    check(sessions[0].metrics.frames_decoded
          == sessions[workers].metrics.frames_decoded,
          "session_workers: decoded frames differ")
    emit({"phase": "session_workers", "channels": CHANNELS,
          "blocks": len(blocks), "host_workers": [0, workers],
          "frames_decoded": sessions[0].metrics.frames_decoded,
          "process_block_ms_median": {
              str(k): statistics.median(v) * 1e3 for k, v in wall.items()},
          "process_block_ms": {str(k): [t * 1e3 for t in v]
                               for k, v in wall.items()},
          "same_telemetry": True})


# m10 at this block (4 s + 5 samples): dev * n / fs = 48001.25 is not an
# integer, so the dual-tone gate fails and m10 falls back to the FM
# discriminator on K1; in bf16 the one config the original accepts whose
# fused front end reads bfloat16 planes
M10_FALLBACK_BLOCK = BLOCK_LEN + 5


def phase_bf16_path(torch, dev, family: str, smi, n_blocks: int = 2):
    """A bf16 kernel route through DecoderSession at 2048 channels, i16, one
    signal on every channel: ims100 on K7's chanfilt_t41_nb20_bf16 body (4 s
    blocks), or m10's FM fallback (M10_FALLBACK_BLOCK) on K1's
    decim1_t41_bf16 body with K2's long_l and sign_l64 bodies (m10's and
    M20's templates) on the widened bfloat16 ring. The truth's telemetry on every channel and exactly those bodies
    (and on ims100's route the plain correlation's) once a step; then the bf16 and the f32 step of the same config in
    turns, each one's peak device memory."""
    import dataclasses
    import warnings

    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    fallback = family == "m10"
    block = M10_FALLBACK_BLOCK if fallback else BLOCK_LEN
    # m10's FM fallback correlates its 80-chip template (K2's long body)
    # and the M20 alternate's 64 chips (the sign body) on the bf16 ring
    want = ({"fused_frontend:decim1_t41_bf16": n_blocks,
             "corr:long_l": n_blocks, "corr:sign_l64": n_blocks}
            if fallback else
            {"fused_dualtone_frontend:chanfilt_t41_nb20_bf16": n_blocks})
    label = "m10_fallback_bf16" if fallback else f"{family}_bf16"
    cfg = PipelineConfig(sonde=family, channels=CHANNELS, block_len=block,
                         use_pallas=True, compute_dtype="bf16",
                         input_dtype="i16")
    # ims100's K7 route correlates with the plain correlation kernel
    want.update(plain_route_bodies(cfg, n_blocks))
    qi, qq = dualtone_planes(family, n_blocks * block, seed=9)
    row_i = torch.from_numpy(qi).to(dev)
    row_q = torch.from_numpy(qq).to(dev)
    blocks = [(row_i[None, b * block:(b + 1) * block]
               .expand(CHANNELS, -1).contiguous(),
               row_q[None, b * block:(b + 1) * block]
               .expand(CHANNELS, -1).contiguous()) for b in range(n_blocks)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the fallback warns
        pipe = Pipeline(cfg, dev)
        f32 = Pipeline(dataclasses.replace(cfg, compute_dtype="f32"), dev)
    check(pipe._route == ("fused" if fallback else "dualtone"),
          f"{label}: route {pipe._route}")
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
    bodies = dict(cuda.body_launches)
    m = sess.metrics
    check(m.frames_decoded > 0, f"{label}: no frames decoded")
    check(sorted(sess.telemetry) == list(range(CHANNELS)),
          f"{label}: channels without telemetry")
    t = sess.telemetry[0]
    ref = json.dumps(t.to_dict(), sort_keys=True)
    check(all(json.dumps(sess.telemetry[ch].to_dict(), sort_keys=True) == ref
              for ch in range(CHANNELS)),
          f"{label}: telemetry differs between identical channels")
    check(dualtone_truth(family, t), f"{label}: telemetry {t.to_dict()}")
    check(bodies == want, f"{label}: bodies {bodies}, expected {want}")
    check(sess.state.chipbuf.dtype == torch.bfloat16
          and sess.state.chan_tail_i.dtype == torch.bfloat16,
          f"{label}: state not in bfloat16")
    emit({"phase": label, "sonde": family, "channels": CHANNELS,
          "block_len": block, "blocks": n_blocks, "compute_dtype": "bf16",
          "frames_raw": m.frames_raw, "frames_decoded": m.frames_decoded,
          "frames_per_channel": m.frames_decoded / CHANNELS,
          "serial": t.serial, "lat": t.lat,
          "process_block_seconds": block_seconds,
          "launches": {k: v for k, v in launches.items() if v},
          "body_launches": bodies})
    del sess
    peaks = {}
    for key, p in (("bf16", pipe), ("f32", f32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st = p.init_state()
        for planes in blocks:
            st, _ = p.step(st, planes)
        torch.cuda.synchronize()
        peaks[key] = torch.cuda.max_memory_allocated()
        del st
    turns = alternate_steps(torch, [pipe, f32], blocks)
    emit({"phase": label + "_step", "sonde": family, "channels": CHANNELS,
          "block_len": block,
          "step_ms_median_bf16": statistics.median(turns[0]),
          "step_ms_median_f32": statistics.median(turns[1]),
          "step_ms_bf16": turns[0], "step_ms_f32": turns[1],
          "max_memory_allocated_bytes_bf16": peaks["bf16"],
          "max_memory_allocated_bytes_f32": peaks["f32"],
          "nvidia_smi": smi})
    return {"launches": launches, "bodies": bodies, "steps": n_blocks,
            "step_ms": statistics.median(turns[0])}


def gate_rows(family: str, c: int, n: int, fs: float):
    """int16 (i, q) [c, n] at rate fs: channel ch carries truth ch % 3 of
    the family (rs41, m10 or ims100 serials), from its own offset into the
    stream, with its own noise of std 0.05, cs16."""
    serials = {"rs41": ("S1234567", "T7654321", "R0420042"),
               "m10": M10_SERIALS[:3],
               "ims100": ("2136051", "2136052", "2136053")}[family]
    rows = []
    for k, serial in enumerate(serials):
        iq = narrowband(family, serial, n + 37 * k, fs)[37 * k:37 * k + n]
        rng = np.random.default_rng(70 + k)
        iq = iq + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
        rows.append([np.clip(x * 32767, -32768, 32767).astype(np.int16)
                     for x in (iq.real, iq.imag)])
    return (np.stack([rows[ch % 3][0] for ch in range(c)]),
            np.stack([rows[ch % 3][1] for ch in range(c)]), serials)


def phase_gates(torch, dev):
    """The original's kernel gates on the card, use_pallas=True: rs41 at 12
    channels (not a multiple of 8) and m10 at 200-sample blocks (below
    HALO) take the plain-op front end and launch no kernel but the plain
    correlation; ims100 at 48.1
    kHz (sps 20.04) takes K7's chanfilt_t41_nb20 body and linear_interp.
    Each on the card equals the CPU block by block (validity, valid frame bytes, RS
    verdicts), and the sessions' telemetry is equal, each channel its
    truth."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import (Pipeline, PipelineConfig,
                                                 _rational_sps)
    from sondetpu_torch.runtime.session import DecoderSession

    cases = (  # label, config, blocks, bodies per block
        ("rs41-channels-12", dict(sonde="rs41", channels=12), 3, {}),
        ("m10-block-200", dict(sonde="m10", block_len=200), 288, {}),
        ("ims100-48100", dict(sonde="ims100", fs=48100.0, block_len=48100),
         3, {"fused_dualtone_frontend:chanfilt_t41_nb20": 1}))
    out = {}
    for label, kw, n_blocks, per in cases:
        cfg = PipelineConfig(**{**dict(channels=8, block_len=int(FS),
                                       use_pallas=True, input_dtype="i16"),
                                **kw})
        block = cfg.block_len
        qi, qq, serials = gate_rows(cfg.sonde, cfg.channels,
                                    n_blocks * block, cfg.fs)
        gpu, cpu = Pipeline(cfg, dev), Pipeline(cfg, "cpu")
        check(gpu._route == ("dualtone" if per else None),
              f"gates {label}: route {gpu._route}")
        gsess = DecoderSession(cfg, dev, pipeline=gpu)
        csess = DecoderSession(cfg, "cpu", pipeline=cpu)
        torch.cuda.synchronize()
        cuda.reset_launches()
        frames = 0
        sg, sc = gpu.init_state(), cpu.init_state()
        for b in range(n_blocks):
            blk = (qi[:, b * block:(b + 1) * block],
                   qq[:, b * block:(b + 1) * block])
            sg, og = gpu.step(sg, blk)
            sc, oc = cpu.step(sc, blk)
            v = oc.frame_valid
            check(torch.equal(og.frame_valid.cpu(), v)
                  and torch.equal(og.frames.cpu()[v], oc.frames[v])
                  and torch.equal(og.rs_clean.cpu(), oc.rs_clean),
                  f"gates {label} block {b}: the card differs from the CPU")
            frames += int(v.sum())
            gsess.process_block(blk)
            csess.process_block(blk)
        torch.cuda.synchronize()
        bodies = dict(cuda.body_launches)
        want = {**{k: 2 * n_blocks * v for k, v in per.items()},
                **plain_route_bodies(cfg, 2 * n_blocks)}
        check(bodies == want and (per or plain_kernels_only(
            cuda.launches, cfg, 2 * n_blocks)),
              f"gates {label}: bodies {bodies}, expected {want}")
        for ch in range(cfg.channels):
            tg, tc = gsess.telemetry.get(ch), csess.telemetry.get(ch)
            check(tg is not None and tc is not None
                  and tg.serial == serials[ch % 3]
                  and json.dumps(tg.to_dict(), sort_keys=True)
                  == json.dumps(tc.to_dict(), sort_keys=True),
                  f"gates {label} channel {ch}: telemetry {tg}")
        out[label] = {"channels": cfg.channels, "block_len": block,
                      "blocks": n_blocks, "valid_frames": frames,
                      "route": gpu._route or "plain",
                      "linear_interp": (not float(cfg.sps).is_integer()
                                        and _rational_sps(cfg) is None),
                      "body_launches": bodies}
    emit({"phase": "gates", "cases": out, "matches_cpu": True})


def phase_fleet_bf16_step(torch, fleet, wi, wq, smi):
    """The bf16 fleet's device step and the same fleet's in f32, in turns
    (a, b, b, a, ...: 12 steps each), each one's peak device memory."""
    from sondetpu_torch.runtime.fleet import FleetSession

    f32 = FleetSession(fleet.channels, fleet.n_bins, fleet.device,
                       fs_chan=FS, block_len=fleet.block_len)
    peaks = {}
    for key, f in (("bf16", fleet), ("f32", f32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):                      # warm-up
            f.step(wi, wq)
        torch.cuda.synchronize()
        peaks[key] = torch.cuda.max_memory_allocated()
    turns = {"bf16": [], "f32": []}
    for r in range(6):
        pair = [("bf16", fleet), ("f32", f32)]
        for key, f in (pair if r % 2 == 0 else pair[::-1]):
            for _ in range(2):
                t0 = time.perf_counter()
                f.step(wi, wq)
                torch.cuda.synchronize()
                turns[key].append((time.perf_counter() - t0) * 1e3)
    del f32
    step = statistics.median(turns["bf16"])
    secs = fleet.block_len / FS
    emit({"phase": "fleet_bf16_step", "bins": fleet.n_bins,
          "block_seconds": secs, "steps": len(turns["bf16"]),
          "step_ms_median": step,
          "step_ms_median_f32": statistics.median(turns["f32"]),
          "step_ms": turns["bf16"], "step_ms_f32": turns["f32"],
          "realtime_channels": fleet.n_bins * secs / step * 1e3,
          "max_memory_allocated_bytes": peaks["bf16"],
          "max_memory_allocated_bytes_f32": peaks["f32"],
          "nvidia_smi": smi})
    return step


def phase_profile(torch, dev, family: str, steps: int = 3, dtype=None):
    """torch.profiler over ``steps`` steady device steps of one family at
    2048 channels x 4 s; with ``dtype``, of the plain-op step in that
    compute dtype."""
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig

    cfg = PipelineConfig(sonde=family, channels=CHANNELS, block_len=BLOCK_LEN,
                         use_pallas=dtype is None, compute_dtype=dtype or "f32",
                         input_dtype="i16")
    n = steps * BLOCK_LEN
    qi, qq = (rs41_planes("S1234567", steps, seed=0) if family == "rs41"
              else dualtone_planes(family, n, seed=9)
              if family in ("m10", "ims100", "mrzn1")
              else afsk_planes(family, n, seed=7))
    blocks = [tuple(torch.from_numpy(x[None, b * BLOCK_LEN:(b + 1) * BLOCK_LEN])
                    .to(dev).expand(CHANNELS, -1).contiguous()
                    for x in (qi, qq)) for b in range(steps)]
    pipe = Pipeline(cfg, dev)
    state = pipe.init_state()
    for planes in blocks[:2]:                   # warm-up
        state, _ = pipe.step(state, planes)
    torch.cuda.synchronize()
    holder = [state]

    def step(k):
        holder[0], _ = pipe.step(holder[0], blocks[k])

    profile_steps(torch, family + (f" plain {dtype}" if dtype else ""), step,
                  steps)


def profile_steps(torch, label: str, step, steps: int):
    """torch.profiler over step(0) .. step(steps - 1), warmed up by the
    caller: device time by kernel name per step against the step's wall
    time (the card's busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(steps):
            step(k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    check(device_ms > 0, f"profile {label}: the profiler saw no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]

    def row(e):
        return [e.key[:90], e.self_device_time_total / 1e3 / steps,
                e.count / steps]

    emit({"phase": "profile", "sonde": label, "steps": steps,
          "step_wall_ms": wall_ms, "device_ms_per_step": device_ms,
          "busy_share": device_ms / wall_ms,
          "kernels_per_step": sum(e.count for e in kernels) / steps,
          "top": [row(e) for e in top],
          # the port's own kernels (csrc/, an anonymous namespace), however
          # small
          "port_kernels": [row(e) for e in kernels
                           if "anonymous namespace" in e.key]})


def phase_profile_fleet(torch, dev, steps: int = 3):
    """torch.profiler over ``steps`` device steps of the 2048-bin fleet
    (the fleet_path's groups, one block of its signal)."""
    from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession

    chans = [FleetChannel(pfb_bin=k, sonde=fleet_family(k))
             for k in range(N_BINS)]
    fleet = FleetSession(chans, N_BINS, dev, fs_chan=FS, block_len=BLOCK_LEN,
                         pipelined=True)
    wi, wq = next(fleet_blocks(torch, dev, 1, seed=3))
    for _ in range(2):                          # warm-up
        fleet.step(wi, wq)
    torch.cuda.synchronize()
    profile_steps(torch, "fleet", lambda k: fleet.step(wi, wq), steps)


def phase_resources(sources=("frontend.cu", "afsk.cu", "pfb_dft.cu",
                             "corr.cu", "dualtone.cu", "syndrome.cu",
                             "lane_fir.cu", "demod_fir.cu"), quiet=False):
    """Registers, stack, spills and static shared memory of each body of
    the redesigned kernels, as ptxas reports them (nvcc -Xptxas -v), with
    the library's flags. K3's shared memory is dynamic: see
    csrc/syndrome.cu's launch."""
    import re

    from sondetpu_torch.kernels import cuda

    out = {}
    for src in sources:
        res = subprocess.run(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.devnull, os.path.join(cuda.CSRC, src)],
            capture_output=True, text=True, check=True, timeout=600)
        name = None
        for line in res.stderr.splitlines():
            m = re.search(r"Compiling entry function '\S*?\d("
                          r"frontend_kernel|frontend_walk_kernel|"
                          r"afsk_kernel|dft2048_kernel|"
                          r"pfb_dft_kernel|corr_blocked_kernel|long_kernel|"
                          r"dualtone_kernel|rs_clean_kernel|lane_fir_kernel|"
                          r"plain_fir_kernel|plain_fir_strided_kernel|"
                          r"demod_audio_kernel|demod_fir_kernel|"
                          r"pfb_fir_kernel|pfb_fir_bf16_kernel|"
                          r"dft2048_bf16_kernel)"
                          r"((?:I|L[ib]-?\d+E|f|13__nv_bfloat16)*)", line)
            if m:
                # the kernel's name and template arguments, from the mangling
                args = ["".join(a) for a in re.findall(
                    r"L[ib](-?\d+)E|13__nv_(bfloat16)|(?<=I)(f)",
                    m.group(2))]
                name = m.group(1) + (f"<{','.join(args)}>" if args else "")
                spill = 0
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                stack = re.search(r"(\d+) bytes cumulative stack", line)
                smem = re.search(r"(\d+) bytes smem", line)
                out[f"{src}:{name}"] = {
                    "registers": int(m.group(1)),
                    "stack_bytes": int(stack.group(1)) if stack else 0,
                    "spill_store_bytes": spill,
                    "static_smem_bytes": int(smem.group(1)) if smem else 0}
    if not quiet:
        emit({"phase": "resources", "kernels": out})
    return out


def phase_tune(torch, dev, variants=(
        (), ("SONDETPU_CORR_R=9",), ("SONDETPU_CORR_R=21",),
        ("SONDETPU_DUALTONE_R=7",), ("SONDETPU_DUALTONE_R=11",),
        ("SONDETPU_RS_CLEAN_F=4",), ("SONDETPU_RS_CLEAN_F=8",),
        ("SONDETPU_LANE_FIR_R=9",), ("SONDETPU_LANE_FIR_R=21",),
        ("SONDETPU_DEMOD_FIR_R=9",), ("SONDETPU_DEMOD_FIR_R=15",))):
    """K2, K7, K3, K10 and K9 rebuilt with each variant's -D flags (K2's,
    K7's, K10's and K9's outputs per thread, R; K3's frames per warp, F) and
    timed at the paths' shapes (K3 at 320 and 518 bytes), each checked
    against its twin (K9 without the DC, bit for bit), beside ptxas's
    registers and spills."""
    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.corr import corr_kernel, corr_plain
    from sondetpu_torch.kernels.dualtone import (fused_dualtone_frontend,
                                                 fused_dualtone_plain,
                                                 mixer_tables)
    from sondetpu_torch.kernels.frontend import (HALO, fused_demod_fir,
                                                 fused_demod_fir_plain)
    from sondetpu_torch.kernels.lane_fir import lane_fir, lane_fir_plain
    from sondetpu_torch.kernels.syndrome import rs_clean_flags_kernel
    from sondetpu_torch.sondes.rs41 import SPEC

    gen = torch.Generator(device=dev).manual_seed(8)
    buf = torch.randn((CHANNELS, 2560 + 19200), generator=gen, device=dev)
    t = SPEC.sync_chip_template()
    want_corr = corr_plain(buf, torch.from_numpy(t).to(dev))
    k7 = (*(torch.randn(s, generator=gen, device=dev) for s in (
        (616, BLOCK_LEN), (616, BLOCK_LEN), (616, HALO), (616, HALO))),
        design_lowpass(0.45 * FS, FS, 41),
        *(torch.from_numpy(x).to(dev)
          for x in mixer_tables(BLOCK_LEN, 12000.0 / FS)), 5, False, True)
    want_k7 = fused_dualtone_plain(*k7)[0]
    rng = np.random.default_rng(8)
    k3 = []
    for name in ("rs41", "rs41x"):
        frames, truth, layout = syndrome_frames(rng, name, CHANNELS * 9)
        k3.append((name, torch.from_numpy(frames).to(dev), layout,
                   torch.from_numpy(truth).to(dev)))
    h = design_lowpass(0.1, 1.0, 41)
    x10 = torch.randn((CHANNELS, BLOCK_LEN + 40), generator=gen, device=dev)
    want_k10 = lane_fir_plain(x10, h)
    k9 = (*(torch.randn(s, generator=gen, device=dev) for s in (
        (CHANNELS, BLOCK_LEN // 2), (CHANNELS, BLOCK_LEN // 2), (CHANNELS, 2),
        (CHANNELS, 40))), design_lowpass(2640.0, FS / 2, 41),
        float(np.float32(FS / 2 / (2 * np.pi * 2400.0))))
    want_k9 = fused_demod_fir_plain(*k9, False)[0].view(torch.int32)
    base = list(cuda.NVCC_FLAGS)
    try:
        for flags in variants:
            cuda.NVCC_FLAGS = base + [f"-D{f}" for f in flags]
            cuda._lib = None
            cuda.library()
            check(torch.equal(corr_kernel(buf, t), want_corr),
                  f"tune {flags}: corr differs from its twin")
            check(torch.equal(fused_dualtone_frontend(*k7)[0], want_k7),
                  f"tune {flags}: metric differs from its twin")
            for name, fr, layout, truth in k3:
                check(torch.equal(rs_clean_flags_kernel(fr, layout), truth),
                      f"tune {flags}: rs_clean {name} differs from the truth")
            check(torch.equal(lane_fir(x10, h), want_k10),
                  f"tune {flags}: lane_fir differs from its twin")
            check(torch.equal(fused_demod_fir(*k9, False)[0].view(
                torch.int32), want_k9),
                  f"tune {flags}: demod_fir differs from its twin")
            emit({"phase": "tune", "flags": list(flags),
                  "corr_ms": cuda_ms(torch, lambda: corr_kernel(buf, t), 50),
                  "dualtone_ms": cuda_ms(
                      torch, lambda: fused_dualtone_frontend(*k7), 20),
                  "rs_clean_ms": {name: cuda_ms(
                      torch, lambda: rs_clean_flags_kernel(fr, layout), 50)
                      for name, fr, layout, _ in k3},
                  "lane_fir_ms": cuda_ms(torch, lambda: lane_fir(x10, h), 20),
                  "demod_fir_ms": cuda_ms(
                      torch, lambda: fused_demod_fir(*k9, True), 20),
                  "resources": phase_resources(
                      ("corr.cu", "dualtone.cu", "syndrome.cu",
                       "lane_fir.cu", "demod_fir.cu"), quiet=True)})
    finally:
        cuda.NVCC_FLAGS = base
        cuda._lib = None


PFB_PROFILE_VARIANTS = (
    ("full", ()), ("no_arithmetic", ("SONDETPU_PFB_PROFILE=1",)),
    ("no_loads", ("SONDETPU_PFB_PROFILE=2",)),
    ("no_stores", ("SONDETPU_PFB_PROFILE=4",)),
    ("loads_only", ("SONDETPU_PFB_PROFILE=5",)),
    ("stores_only", ("SONDETPU_PFB_PROFILE=3",)),
    ("arithmetic_only", ("SONDETPU_PFB_PROFILE=6",)))


def phase_profile_pfb(torch, dev, smi, variants=PFB_PROFILE_VARIANTS):
    """The PFB's bodies at the fleet's shape, [192000, 2048], rebuilt with
    -DSONDETPU_PFB_PROFILE=bits (bit 1 skips the arithmetic: K4 writes its
    newest rounded sample, K6 sends its loaded points straight to the
    transposed tile; bit 2 skips K6's device-memory loads, bit 4 its
    stores) and timed by CUDA events: K4 in bf16 and f32, K6's n2048 body
    in bf16 and f32, beside torch.fft.fft of the widened input; ptxas's
    registers, spills and shared memory of every body. The full build is
    held to the twins; the others compute nothing a path may use."""
    from sondetpu_torch.dsp.channelizer import PFBChannelizer
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.pfb import (pfb_dft, pfb_dft_plain,
                                            pfb_fir_plain, pfb_fir_stream)

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(16)
    m = BLOCK_LEN
    x_i, x_q = (torch.randn((m, N_BINS), generator=gen, device=dev)
                for _ in range(2))
    t_i, t_q = (torch.randn((8, N_BINS), generator=gen, device=dev)
                for _ in range(2))
    hcol = PFBChannelizer(N_BINS, dev)._hcol_t
    twiddles = PFBChannelizer(N_BINS, dev)._twiddles
    u32 = [torch.randn((m, N_BINS), generator=gen, device=dev)
           for _ in range(2)]
    u16 = [u.to(bf) for u in u32]
    z = torch.complex(u16[0].float(), u16[1].float())
    emit({"phase": "profile_pfb", "variant": "library",
          "fft_widened_bf16_ms": cuda_ms(
              torch, lambda: torch.fft.fft(z, dim=-1), 20),
          "nvidia_smi": smi})
    del z
    base = list(cuda.NVCC_FLAGS)
    try:
        for label, flags in variants:
            cuda.NVCC_FLAGS = base + [f"-D{f}" for f in flags]
            cuda._lib = None
            cuda.library()
            if not flags:
                got = pfb_fir_stream(x_i, x_q, t_i, t_q, hcol, bf)
                want = pfb_fir_plain(torch.cat([t_i, x_i]),
                                     torch.cat([t_q, x_q]), hcol, bf)
                check(all(torch.equal(a.view(torch.int16),
                                      b.view(torch.int16))
                          for a, b in zip(got, want)),
                      "profile_pfb: K4 bf16 differs from its twin")
                del got, want
                for u in (u16, u32):
                    y = pfb_dft(*u, twiddles)
                    ref = pfb_dft_plain(*(v.float() for v in u))
                    top = max(float(r.abs().max()) for r in ref)
                    err = max(float((a.float() - b).abs().max())
                              for a, b in zip(y, ref))
                    check(err <= 2.0 ** (np.floor(np.log2(top)) - 7)
                          + 1e-4 * top, f"profile_pfb: K6 err {err}")
                    del y, ref
            emit({"phase": "profile_pfb", "variant": label,
                  "flags": list(flags),
                  "k4_bf16_ms": cuda_ms(torch, lambda: pfb_fir_stream(
                      x_i, x_q, t_i, t_q, hcol, bf), 20),
                  "k4_f32_ms": cuda_ms(torch, lambda: pfb_fir_stream(
                      x_i, x_q, t_i, t_q, hcol), 20),
                  "k6_bf16_ms": cuda_ms(
                      torch, lambda: pfb_dft(*u16, twiddles), 20),
                  "k6_f32_ms": cuda_ms(
                      torch, lambda: pfb_dft(*u32, twiddles), 20),
                  "resources": phase_resources(("pfb.cu", "pfb_dft.cu"),
                                               quiet=True)})
    finally:
        cuda.NVCC_FLAGS = base
        cuda._lib = None


K7_PROFILE_VARIANTS = (
    ("full", ()), ("no_chanfilt", ("SONDETPU_DUALTONE_PROFILE=1",)),
    ("no_boxcar", ("SONDETPU_DUALTONE_PROFILE=2",)),
    ("no_stores", ("SONDETPU_DUALTONE_PROFILE=4",)),
    ("boxcar_only", ("SONDETPU_DUALTONE_PROFILE=5",)),
    ("chanfilt_only", ("SONDETPU_DUALTONE_PROFILE=6",)),
    ("staging_only", ("SONDETPU_DUALTONE_PROFILE=7",)))


def phase_profile_k7(torch, dev, smi, variants=K7_PROFILE_VARIANTS):
    """K7's channel-filter bodies at ims100's shape, [2048, 192000], its
    10 kHz 41-tap channel filter, 2400 Hz tables and nb 20 (f32, bf16, f32
    with AFC) and nb 19 (f32, bf16: the run-time body), and m10's skip_nb5
    body at [616, 192000],
    rebuilt with -DSONDETPU_DUALTONE_PROFILE=bits (1 leaves out the
    channel filter, 2 the mix and boxcars, 4 the metric's stores; the
    "only" builds keep the staging, the metric and its sums besides) and
    timed by CUDA events, with the body each case launched and ptxas's
    registers and spills of every body. A build without profile bits is
    held to the twin; the others compute nothing a path may use."""
    from sondetpu_torch.dsp.fir import design_lowpass
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels.dualtone import (fused_dualtone_frontend,
                                                 fused_dualtone_plain,
                                                 mixer_tables)
    from sondetpu_torch.kernels.frontend import HALO

    gen = torch.Generator(device=dev).manual_seed(17)

    def planes(c, dtype=torch.float32):
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in ((c, BLOCK_LEN), (c, BLOCK_LEN), (c, HALO),
                          (c, HALO))]

    f32 = planes(CHANNELS)
    bf16 = [p.to(torch.bfloat16) for p in f32]
    m10 = planes(616)
    ims_taps = design_lowpass(10000.0, FS, 41)
    ims_tabs = [torch.from_numpy(t).to(dev)
                for t in mixer_tables(BLOCK_LEN, 2400.0 / FS)]
    m10_tabs = [torch.from_numpy(t).to(dev)
                for t in mixer_tables(BLOCK_LEN, 12000.0 / FS)]
    cases = {  # label: (planes, taps, tables, nb, afc, skip)
        "nb20_f32": (f32, ims_taps, ims_tabs, 20, False, False),
        "nb20_bf16": (bf16, ims_taps, ims_tabs, 20, False, False),
        "nb20_afc_f32": (f32, ims_taps, ims_tabs, 20, True, False),
        "nb19_f32": (f32, ims_taps, ims_tabs, 19, False, False),
        "nb19_bf16": (bf16, ims_taps, ims_tabs, 19, False, False),
        "m10_skip_nb5_f32": (m10, ims_taps, m10_tabs, 5, False, True)}

    def call(case):
        p, taps, tabs, nb, afc, skip = cases[case]
        return fused_dualtone_frontend(*p, taps, *tabs, nb, afc, skip)

    base = list(cuda.NVCC_FLAGS)
    try:
        for label, flags in variants:
            cuda.NVCC_FLAGS = base + [f"-D{f}" for f in flags]
            cuda._lib = None
            cuda.library()
            out = {}
            for case, (p, taps, tabs, nb, afc, skip) in cases.items():
                cuda.reset_launches()
                got = call(case)
                torch.cuda.synchronize()
                body = next(iter(cuda.body_launches))
                if not any("PROFILE" in f for f in flags):
                    want = fused_dualtone_plain(*p, taps, *tabs, nb, afc,
                                                skip)
                    check(torch.equal(got[0], want[0]),
                          f"profile_k7 {case}: metric differs from its twin")
                    del want
                del got
                out[case] = {"body": body, "ms": cuda_ms(
                    torch, lambda: call(case), 20)}
            emit({"phase": "profile_k7", "variant": label,
                  "flags": list(flags), "cases": out, "nvidia_smi": smi,
                  "resources": phase_resources(("dualtone.cu",),
                                               quiet=True)})
            torch.cuda.empty_cache()
    finally:
        cuda.NVCC_FLAGS = base
        cuda._lib = None


K1_PROFILE_VARIANTS = (
    ("full", ()), ("no_chanfilt", ("SONDETPU_FRONTEND_PROFILE=1",)),
    ("no_disc", ("SONDETPU_FRONTEND_PROFILE=2",)),
    ("no_fir", ("SONDETPU_FRONTEND_PROFILE=4",)),
    ("no_stores", ("SONDETPU_FRONTEND_PROFILE=8",)),
    ("chanfilt_only", ("SONDETPU_FRONTEND_PROFILE=14",)),
    ("disc_only", ("SONDETPU_FRONTEND_PROFILE=13",)),
    ("fir_only", ("SONDETPU_FRONTEND_PROFILE=11",)),
    ("staging_only", ("SONDETPU_FRONTEND_PROFILE=15",)),
    ("staging_nowait", ("SONDETPU_FRONTEND_PROFILE=31",)),
    ("nothing", ("SONDETPU_FRONTEND_PROFILE=47",)),
    ("walk_f32", ("SONDETPU_FRONTEND_WALK_F32=1",)))
K1_PROFILE_WALKS = (1, 2, 4, 8, 16)


def phase_profile_k1(torch, dev, smi, variants=K1_PROFILE_VARIANTS):
    """K1's compiled bodies (41 taps) at [2048, 192000]: decim 1 with the
    lowpass matched taps (m10's FM fallback) and with the identity, decim 2
    (RS41's shape), each on float32 and bfloat16 planes, rebuilt with
    -DSONDETPU_FRONTEND_PROFILE=bits (1 leaves out the channel filter, 2
    the discriminator, 4 the matched FIR, 8 the stores of filt; the "only"
    builds keep the staging and the DC sums besides; walk_f32 sends the
    float32 cases to the walking bodies, which no path launches on float32)
    and timed by CUDA events, with the body each case launched and
    ptxas's registers and spills of every body. A build without profile
    bits is held to the twin before the DC (and on bfloat16 to the
    float32 kernel on the widened input, DC included); the others compute
    nothing a path may use."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.kernels import frontend as kfront
    from sondetpu_torch.kernels.frontend import (fused_frontend,
                                                 fused_frontend_plain)

    gen = torch.Generator(device=dev).manual_seed(18)
    f32 = {d: frontend_inputs(torch, dev, gen, CHANNELS, BLOCK_LEN, d, 41,
                              False)[:4] for d in (1, 2)}
    taps = {(d, ident): frontend_inputs(torch, dev, gen, 1, 256, d, 41,
                                        ident)[4:7]
            for d in (1, 2) for ident in (False, True)}
    bf16 = {d: [p.to(torch.bfloat16) for p in f32[d]] for d in (1, 2)}
    cases = {  # label: (planes, decim, identity)
        "d1_lowpass_f32": (f32[1], 1, False),
        "d1_lowpass_bf16": (bf16[1], 1, False),
        "d1_identity_f32": (f32[1], 1, True),
        "d1_identity_bf16": (bf16[1], 1, True),
        "d2_f32": (f32[2], 2, False),
        "d2_bf16": (bf16[2], 2, False)}

    def call(case, dc=True):
        planes, d, ident = cases[case]
        return fused_frontend(*planes, *taps[(d, ident)], d, dc)

    base = list(cuda.NVCC_FLAGS)
    try:
        for label, flags in variants:
            cuda.NVCC_FLAGS = base + [f"-D{f}" for f in flags]
            cuda._lib = None
            cuda.library()
            out = {}
            for case, (planes, d, ident) in cases.items():
                cuda.reset_launches()
                got = call(case, False)
                torch.cuda.synchronize()
                body = next(iter(cuda.body_launches))
                if not any("PROFILE" in f for f in flags):
                    want = fused_frontend_plain(*planes, *taps[(d, ident)],
                                                d, False)
                    check(torch.equal(got[0], want[0]),
                          f"profile_k1 {label} {case}: filt differs from "
                          "its twin")
                    del want
                    if planes[0].dtype == torch.bfloat16:
                        wide = fused_frontend(*(p.float() for p in planes),
                                              *taps[(d, ident)], d, False)
                        check(torch.equal(got[3], wide[3]),
                              f"profile_k1 {label} {case}: dc differs from "
                              "the float32 body on the widened input")
                        del wide
                del got
                # as the path calls it (the block DC subtracted by one more
                # pass over filt), and the kernel with the DC's sum alone
                out[case] = {"body": body, "ms": cuda_ms(
                    torch, lambda: call(case), 20),
                    "kernel_ms": cuda_ms(
                        torch, lambda: call(case, False), 20)}
            # the walking bodies at other walks (tiles a block takes)
            chosen = kfront.frontend_walk
            try:
                for w in K1_PROFILE_WALKS:
                    kfront.frontend_walk = lambda c, tiles, sms, w=w: w
                    out["d1_lowpass_bf16"][f"ms_walk{w}"] = cuda_ms(
                        torch, lambda: call("d1_lowpass_bf16"), 20)
            finally:
                kfront.frontend_walk = chosen
            emit({"phase": "profile_k1", "variant": label,
                  "flags": list(flags), "cases": out, "nvidia_smi": smi,
                  "resources": phase_resources(("frontend.cu",),
                                               quiet=True)})
            torch.cuda.empty_cache()
    finally:
        cuda.NVCC_FLAGS = base
        cuda._lib = None


# the configs each steps mode times: (family, compute dtype, block length)
STEP_SETS = {
    # ims100 and mrzn1 on K7's channel-filter bodies
    "dualtone": (("ims100", "f32", BLOCK_LEN), ("mrzn1", "f32", BLOCK_LEN),
                 ("ims100", "bf16", BLOCK_LEN)),
    # m10's FM fallback on K1's decim1_t41 bodies
    "m10": (("m10", "bf16", BLOCK_LEN + 5), ("m10", "f32", BLOCK_LEN + 5)),
}


def phase_dualtone_steps_here(torch, dev, smi, label: str,
                              kind: str = "dualtone"):
    """The kernel-path steps of STEP_SETS[kind] at 2048 channels (ims100
    and mrzn1 at 4 s in f32, ims100 in bf16; or m10's FM fallback at
    M10_FALLBACK_BLOCK in bf16 and f32), each the median of 12 steady steps
    (phase_step), with the bodies they launched, for the sondetpu_torch
    this process imports: one JSON line."""
    import warnings

    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig

    out = {"phase": f"{kind}_steps", "tree": label, "nvidia_smi": smi}
    for family, dtype, block in STEP_SETS[kind]:
        cfg = PipelineConfig(sonde=family, channels=CHANNELS,
                             block_len=block, use_pallas=True,
                             compute_dtype=dtype, input_dtype="i16")
        qi, qq = dualtone_planes(family, 3 * block, seed=9)
        ri, rq = torch.from_numpy(qi).to(dev), torch.from_numpy(qq).to(dev)
        blocks = [(ri[None, b * block:(b + 1) * block]
                   .expand(CHANNELS, -1).contiguous(),
                   rq[None, b * block:(b + 1) * block]
                   .expand(CHANNELS, -1).contiguous()) for b in range(3)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")        # m10's fallback warns
            pipe = Pipeline(cfg, dev)
        cuda.reset_launches()
        out[f"{family}_{dtype}_step_ms"] = phase_step(
            torch, pipe, blocks, phase=f"{family}_{dtype}_step")
        out[f"{family}_{dtype}_bodies"] = dict(cuda.body_launches)
        del pipe, blocks
        torch.cuda.empty_cache()
    emit(out)


def phase_dualtone_steps(trees, kind: str = "dualtone"):
    """phase_dualtone_steps_here for each checkout in ``trees``, in that
    order, each in a process of its own that imports the checkout's
    sondetpu_torch (and builds its kernels) with this file's phases: give
    two checkouts in turns, e.g. the parent's unpacked by git archive into
    build/parent and this one, as ``build/parent . . build/parent``, to
    compare them on one card."""
    here = os.path.abspath(__file__)
    for tree in trees:
        code = ("import runpy, sys; sys.argv = [%r, '--dualtone-steps-here',"
                " %r, %r]; runpy.run_path(%r, run_name='__main__')"
                % (here, tree, kind, here))
        res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith(f'{{"phase": "{kind}_steps"')]
        check(res.returncode == 0 and lines,
              f"{kind}_steps {tree}: {res.returncode} {res.stderr[-2000:]}")
        print(lines[-1], flush=True)


# --- the command line (sondetpu_torch.cli.main) ---------------------------------

CLI_FAMILIES = ("rs41", "rs41x", "m10", "dfm", "ims100", "imet4", "c50",
                "mrzn1")
CLI_REF_EPOCH = "1700000000"
# synth frames of about 3.5 s per family: --sonde auto probes 3 blocks
CLI_FRAMES = {"rs41": 7, "rs41x": 5, "m10": 21, "dfm": 16, "ims100": 15,
              "imet4": 9, "c50": 17, "mrzn1": 33}
# the carrier offset of the --afc case: 3 kHz, but 1 kHz for ims100 and
# mrzn1, which the JAX package's AFC does not pull in from 3 kHz either
CLI_AFC_HZ = {"ims100": 1000.0, "mrzn1": 1000.0}
# the off-grid carrier of cli_wideband: (bin, family, serial, offset Hz)
CLI_OFFGRID = (12, "rs41", "T7654321", 3150.0)
# the seeds and frame counts of tests/test_torch_fer.py
# the one decode unit in which the kernel path's card and CPU sets may
# part: imet4's packet 124 in the clean run, a sync-peak pick that turns on
# a last-ulp tie; the card keeps it, as the JAX package's kernels do, and
# the CPU twins do not (tests/test_torch_fer.py, KERNEL_TIE; see phase_fer)
FER_TIE = ("imet4", 124)
FER_FRAMES = {"rs41": 24, "rs41x": 24, "m10": 24, "dfm": 24, "ims100": 24,
              "mrzn1": 24, "imet4": 200, "c50": 200}


def cli_dir():
    """A temporary directory under the ignored build/ for a phase's files,
    removed when the phase ends."""
    import tempfile

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    return tempfile.TemporaryDirectory(prefix="cli_", dir=base)


def run_cli(torch, argv, label: str) -> dict:
    """The port's command line in this process, with the kernels' and the
    IQ readers' counts set to 0 just before and read just after. Returns
    its stderr and stdout, those counts and the host seconds it
    reports."""
    import contextlib
    import io

    from sondetpu_torch.cli import main as cli
    from sondetpu_torch.io import iq as tiq
    from sondetpu_torch.kernels import cuda

    torch.cuda.synchronize()
    cuda.reset_launches()
    tiq.reset_readers()
    err, out = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    text = err.getvalue()
    check(rc == 0, f"{label}: exit code {rc}: {text[-3000:]}")
    host = next((json.loads(line)["cli_seconds"] for line in
                 text.splitlines() if line.startswith('{"cli_seconds"')),
                None)
    return {"stderr": text, "stdout": out.getvalue(),
            "launches": dict(cuda.launches),
            "bodies": dict(cuda.body_launches), "readers": dict(tiq.readers),
            "cli_seconds": host, "seconds": seconds}


def jsonl_lines(path: str) -> list:
    with open(path) as f:
        return f.read().splitlines()


def write_cs16(path: str, qi, qq, mode: str = "wb") -> None:
    """Interleave int16 (i, q) planes into a cs16 file."""
    inter = np.empty(2 * qi.size, np.int16)
    inter[0::2], inter[1::2] = qi, qq
    with open(path, mode) as f:
        inter.tofile(f)


def phase_cli_full_width(torch, dev, smi, channels: int = CHANNELS,
                         block_len: int = BLOCK_LEN, n_blocks: int = 3):
    """``decode`` of one rs41 channel tiled to ``channels`` rows (bench.py's
    shape: cs16, device dequant, 4 s blocks) at the CLI's default (the
    plain-op step in f32) and with use_pallas (K1, K2, K3): S1234567 on
    every channel; the session rate of each run beside that of
    DecoderSession.process_block on the same host planes, and the share of
    the wall time in the host's file read and tile."""
    from sondetpu_torch.cli.config import FrameworkConfig
    from sondetpu_torch.runtime.pipeline import PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    check(block_len == BLOCK_LEN, "cli_full_width: rs41_planes' block")
    qi, qq = rs41_planes("S1234567", n_blocks, seed=0)
    block_s = block_len / FS
    runs = {}
    with cli_dir() as d:
        iq = os.path.join(d, "rs41.cs16")
        write_cs16(iq, qi, qq)
        for use_pallas in (False, True):
            key = "use_pallas" if use_pallas else "default"
            cfg = os.path.join(d, f"{key}.json")
            FrameworkConfig(block_len=block_len, device_dequant=True,
                            use_pallas=use_pallas).save(cfg)
            out = os.path.join(d, f"{key}.jsonl")
            r = run_cli(torch, ["decode", "--iq", iq, "--sonde", "rs41",
                                "--channels", str(channels), "--config", cfg,
                                "--jsonl", out, "--ref-epoch", CLI_REF_EPOCH,
                                "--device", str(dev)], f"cli_full_width {key}")
            recs = [json.loads(x) for x in jsonl_lines(out)]
            got = {x["channel"] for x in recs if x["serial"] == "S1234567"}
            check(got == set(range(channels)),
                  f"cli_full_width {key}: {channels - len(got)} channels "
                  "without S1234567")
            if use_pallas:
                want = {"fused_frontend:decim2_t41": n_blocks,
                        "corr:sign_l64": n_blocks, "rs_clean:c384": n_blocks}
                check(r["bodies"] == want,
                      f"cli_full_width {key}: bodies {r['bodies']}")
            else:
                check(plain_kernels_only(r["launches"], PipelineConfig(
                    sonde="rs41", channels=channels, block_len=block_len),
                    n_blocks),
                      f"cli_full_width {key}: kernels {r['launches']}")
            h = r["cli_seconds"]
            # the same blocks through DecoderSession, host planes tiled
            # beforehand: what the CLI adds is its read and tile
            pcfg = PipelineConfig(sonde="rs41", channels=channels,
                                  block_len=block_len, use_pallas=use_pallas,
                                  input_dtype="i16")
            sess = DecoderSession(pcfg, dev)
            blocks = [(np.tile(qi[None, b * block_len:(b + 1) * block_len],
                               (channels, 1)),
                       np.tile(qq[None, b * block_len:(b + 1) * block_len],
                               (channels, 1))) for b in range(n_blocks)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for planes in blocks:
                sess.process_block(planes)
            torch.cuda.synchronize()
            sess_s = (time.perf_counter() - t0) / n_blocks
            del blocks
            runs[key] = {
                "compute_dtype": "f32", "lines": len(recs),
                "launches": r["launches"], "bodies": r["bodies"],
                "cli_seconds": h,
                "cli_wall_per_block_s": h["wall"] / n_blocks,
                "session_rate": channels * block_s
                / (h["wall"] / n_blocks),
                "read_tile_share": (h["read"] + h["tile"]) / h["wall"],
                "sinks_share": h["sinks"] / h["wall"],
                "decoder_session_rate": channels * block_s / sess_s,
                "decoder_session_per_block_s": sess_s}
    emit({"phase": "cli_full_width", "channels": channels,
          "block_len": block_len, "blocks": n_blocks, "device": smi,
          "runs": runs})
    return {k: {"launches": v["launches"], "bodies": v["bodies"],
                "steps": n_blocks} for k, v in runs.items()}


def cli_wideband_carriers():
    """The carriers of cli_wideband's capture in wide_blocks' form:
    FLEET_CARRIERS on the grid and CLI_OFFGRID, all from block 0."""
    return tuple((k, f, serial, 0.0, 0.0, None)
                 for k, f, serial in FLEET_CARRIERS) \
        + ((*CLI_OFFGRID, 0.0, None),)


def cli_wideband_file(torch, dev, path: str, n_bins: int, block_len: int,
                      n_blocks: int) -> None:
    """The cs16 capture of cli_wideband: wide_blocks with
    cli_wideband_carriers() in noise of std AUTO_NOISE (bandlimited, so
    the spectrum scan sees each carrier once), scaled by 0.05 so the sum
    stays inside the int16 range, quantized and interleaved on the card."""
    with open(path, "wb") as f:
        for wi, wq in wide_blocks(torch, dev, n_blocks, seed=3,
                                  carriers=cli_wideband_carriers(),
                                  n_bins=n_bins, block_len=block_len):
            q = torch.stack([wi, wq], -1).mul_(0.05 * 32767).round_() \
                .clamp_(-32768, 32767).to(torch.int16)
            q.reshape(-1).cpu().numpy().tofile(f)


def phase_cli_wideband(torch, dev, smi, n_bins: int = N_BINS,
                       block_len: int = 48000, n_blocks: int = 2):
    """``decode --wideband --bins n_bins`` of a cs16 capture (n_blocks of
    1 s) with the channel map of bench.py (rs41, m10, dfm by bin) and one
    carrier off the grid, use_pallas: from the file and with --stream, each
    carrier's truth decoded and the JSONL of both runs equal; every kernel
    of the fleet path launched. Then the fleet's checkpoint: the first
    block with --checkpoint, the second with --resume, whose JSONL is the
    uninterrupted run's."""
    from sondetpu_torch.cli.config import ChannelConfig, FrameworkConfig

    k_off, _, serial_off, off = CLI_OFFGRID
    carriers = FLEET_CARRIERS + (CLI_OFFGRID[:3],)
    out = {}
    with cli_dir() as d:
        iq = os.path.join(d, "wide.cs16")
        t0 = time.perf_counter()
        cli_wideband_file(torch, dev, iq, n_bins, block_len, n_blocks)
        make_s = time.perf_counter() - t0
        cfg = FrameworkConfig(block_len=block_len, use_pallas=True)
        cfg.channel_map = [
            ChannelConfig(center_freq=(k if k < n_bins // 2 else k - n_bins)
                          * FS + (off if k == k_off else 0.0),
                          sonde=fleet_family(k)) for k in range(n_bins)]
        cfg_path = os.path.join(d, "fleet.json")
        cfg.save(cfg_path)
        base = ["decode", "--wideband", "--bins", str(n_bins),
                "--config", cfg_path, "--ref-epoch", CLI_REF_EPOCH,
                "--device", str(dev)]
        lines = {}
        for how in ("file", "stream"):
            j = os.path.join(d, f"{how}.jsonl")
            r = run_cli(torch, base + ["--iq", iq, "--jsonl", j]
                        + (["--stream"] if how == "stream" else []),
                        f"cli_wideband {how}")
            lines[how] = jsonl_lines(j)
            recs = [json.loads(x) for x in lines[how]]
            for k, family, serial in carriers:
                check(any(x["channel"] == k and x["type"] == family
                          and x["serial"] == serial for x in recs),
                      f"cli_wideband {how}: carrier {family} {serial} in "
                      f"bin {k} not decoded")
            la = r["launches"]
            # m10's group correlates its two templates with the plain
            # correlation kernel
            check(la["pfb_fir_stream"] == la["pfb_dft"] == n_blocks
                  and la["fused_dualtone_frontend"] == n_blocks
                  and la["fused_frontend"] == la["corr"] == 2 * n_blocks
                  and la["rs_clean"] == n_blocks
                  and la["plain_corr"] == 2 * n_blocks,
                  f"cli_wideband {how}: launches {la}")
            if how == "stream":
                check(r["readers"].get("native:iqs_read") == n_blocks,
                      f"cli_wideband stream: readers {r['readers']}")
            out[how] = {"launches": la, "bodies": r["bodies"],
                        "readers": r["readers"], "seconds": r["seconds"],
                        "lines": len(recs), "stderr_tail":
                        r["stderr"].splitlines()[-1]}
        check(lines["file"] == lines["stream"],
              "cli_wideband: --stream JSONL differs from the file's")
        emit({"phase": "cli_wideband", "bins": n_bins,
              "block_len": block_len, "blocks": n_blocks,
              "capture_bytes": os.path.getsize(iq),
              "capture_seconds": make_s, "device": smi, "runs": out,
              "carriers": [list(c) for c in carriers]})
        out["scan"] = phase_scan(torch, dev, smi, iq, n_bins, carriers, d)
        # the fleet checkpoint: block 1, then the rest from its checkpoint
        raw = np.fromfile(iq, np.int16)
        w = 2 * n_bins * block_len
        first, rest = os.path.join(d, "a.cs16"), os.path.join(d, "b.cs16")
        raw[:w].tofile(first)
        raw[w:].tofile(rest)
        del raw
        os.remove(iq)
        ck = os.path.join(d, "fleet.ckpt")
        ja, jb = os.path.join(d, "a.jsonl"), os.path.join(d, "b.jsonl")
        run_cli(torch, base + ["--iq", first, "--jsonl", ja,
                               "--checkpoint", ck], "cli_checkpoint fleet a")
        rb = run_cli(torch, base + ["--iq", rest, "--jsonl", jb,
                                    "--resume", ck], "cli_checkpoint fleet b")
        split = jsonl_lines(ja) + jsonl_lines(jb)
        check(split == lines["file"], "cli_checkpoint fleet: the resumed "
              "run's JSONL differs from the uninterrupted run's")
        emit({"phase": "cli_checkpoint_fleet", "bins": n_bins,
              "checkpoint_bytes": os.path.getsize(ck), "lines": len(split),
              "resume_launches": rb["launches"], "device": smi})
    return {"launches": out["file"]["launches"],
            "bodies": out["file"]["bodies"], "steps": n_blocks}, out["scan"]


def phase_scan(torch, dev, smi, iq: str, n_bins: int, carriers, d: str):
    """``scan --fs-wide`` of cli_wideband's capture at its defaults (nfft
    4096, every family probed over the first 3 s) with --out: every
    carrier found once and classified as its family in its bin, the
    off-grid one within 1.5 kHz of its centre, nothing else; K4 and K6
    launch once a probe block, and no other kernel but the probe sessions'
    plain correlation."""
    from sondetpu_torch.cli.config import FrameworkConfig
    from sondetpu_torch.dsp.channelizer import bin_and_offset

    cfg_path = os.path.join(d, "scan.json")
    r = run_cli(torch, ["scan", "--iq", iq, "--fs-wide", str(n_bins * FS),
                        "--out", cfg_path, "--device", str(dev)], "scan")
    found = json.loads(r["stdout"].splitlines()[-1])
    cfg = FrameworkConfig.load(cfg_path)
    got = sorted((bin_and_offset(e.center_freq, FS, n_bins)[0], e.sonde)
                 for e in cfg.channel_map)
    want = sorted((k, f) for k, f, *_ in carriers)
    check(got == want and len(found) == len(carriers)
          and cfg.wide_bins == n_bins,
          f"scan: found {found}, channel map {got} != {want}")
    k_off, _, _, off = CLI_OFFGRID
    center = next(e.center_freq for e in cfg.channel_map
                  if bin_and_offset(e.center_freq, FS, n_bins)[0] == k_off)
    check(abs(center - (k_off * FS + off)) < 1500.0,
          f"scan: off-grid centre {center}")
    la = r["launches"]
    blocks = int(os.path.getsize(iq) // (4 * n_bins * 48000))
    check(la["pfb_fir_stream"] == la["pfb_dft"] == min(blocks, 3)
          and la["plain_corr"] > 0 and la["plain_fir"] > 0
          and not any(v for name, v in la.items()
                      if name not in ("pfb_fir_stream", "pfb_dft",
                                      "plain_corr", "plain_fir")),
          f"scan: launches {la}")
    emit({"phase": "scan", "bins": n_bins, "device": smi,
          "capture_bytes": os.path.getsize(iq), "carriers": found,
          "channel_map": got, "seconds": r["seconds"], "launches": la})
    return {"launches": la, "bodies": r["bodies"], "steps": min(blocks, 3)}


def phase_cli_narrowband(torch, dev, smi):
    """Each family on one channel through ``decode`` on the card and on the
    CPU (the kernels' plain twins) from the same synth file with the same
    --ref-epoch: JSONL, GPX and PTU byte-equal; then on the card --stream
    against the file read, --rate 50000 against the same signal at 48 kHz,
    a cs8 file with device dequant, --sonde auto and --afc with the carrier
    3 kHz off (1 kHz for ims100 and mrzn1, CLI_AFC_HZ); and --channels 8
    with use_pallas for each family whose kernel gates hold, card against
    CPU."""
    from sondetpu_torch.cli.config import FrameworkConfig
    from sondetpu_torch.io.iq import iq_from_file, write_iq
    from sondetpu_torch.runtime.pipeline import PipelineConfig, _route
    from sondetpu_torch.sondes.modulate import freq_shift

    sinks = ("jsonl", "gpx", "ptu")
    result, kernel_runs = {}, {}
    with cli_dir() as d:
        def decode(label, argv, device):
            o = os.path.join(d, label)
            os.makedirs(o)
            r = run_cli(torch, ["decode", *argv, "--ref-epoch",
                                CLI_REF_EPOCH, "--device", str(device)]
                        + [x for s in sinks
                           for x in (f"--{s}", os.path.join(o, s))],
                        f"cli_narrowband {label}")
            files = []
            for s in sinks:
                with open(os.path.join(o, s), "rb") as f:
                    files.append(f.read())
            return files, r

        cfg_pallas = os.path.join(d, "pallas.json")
        FrameworkConfig(use_pallas=True).save(cfg_pallas)
        cfg_dq = os.path.join(d, "dequant.json")
        FrameworkConfig(device_dequant=True).save(cfg_dq)
        for family in CLI_FAMILIES:
            iq = os.path.join(d, f"{family}.cf32")
            frames = str(CLI_FRAMES[family])
            run_cli(torch, ["synth", "--sonde", family, "--frames", frames,
                            "--out", iq], f"synth {family}")
            sig = iq_from_file(iq)
            res = {}
            card, _ = decode(f"{family}_card", ["--iq", iq, "--sonde",
                                                family], dev)
            lines = card[0].count(b"\n")
            check(lines >= 2, f"cli_narrowband {family}: {lines} lines")
            cpu, _ = decode(f"{family}_cpu", ["--iq", iq, "--sonde",
                                              family], "cpu")
            check(card == cpu, f"cli_narrowband {family}: card and CPU "
                  "outputs differ")
            res["lines"] = lines
            stream, r = decode(f"{family}_stream", ["--iq", iq, "--sonde",
                                                    family, "--stream"], dev)
            check(stream[0] == card[0] and r["readers"].get(
                "native:iqs_read", 0) > 0,
                f"cli_narrowband {family}: --stream differs or no native "
                f"reader ({r['readers']})")
            # the same frames at 50 kHz through the device resampler
            iq50 = os.path.join(d, f"{family}_50k.cf32")
            run_cli(torch, ["synth", "--sonde", family, "--frames", frames,
                            "--fs", "50000", "--out", iq50],
                    f"synth {family} 50k")
            rate, _ = decode(f"{family}_rate", ["--iq", iq50, "--sonde",
                                                family, "--rate", "50000"],
                             dev)
            res["rate_50k_lines"] = rate[0].count(b"\n")
            check(rate[0] == card[0],
                  f"cli_narrowband {family}: --rate 50000 JSONL differs from "
                  "the same frames at 48 kHz")
            cs8 = os.path.join(d, f"{family}.cs8")
            write_iq(cs8, sig, "cs8")
            dq_card, r = decode(f"{family}_cs8_card",
                                ["--iq", cs8, "--sonde", family, "--config",
                                 cfg_dq], dev)
            dq_cpu, _ = decode(f"{family}_cs8_cpu",
                               ["--iq", cs8, "--sonde", family, "--config",
                                cfg_dq], "cpu")
            check(dq_card == dq_cpu and dq_card[0].count(b"\n") >= 2,
                  f"cli_narrowband {family}: cs8 device dequant, card and "
                  "CPU differ or nothing decoded")
            auto, r = decode(f"{family}_auto", ["--iq", iq, "--sonde",
                                                "auto"], dev)
            detected = next((x.split()[-1] for x in r["stderr"].splitlines()
                             if x.startswith("[auto] detected")), None)
            res["auto_detected"] = detected
            check(detected == family and auto[0] == card[0],
                  f"cli_narrowband {family}: --sonde auto found {detected}")
            off = os.path.join(d, f"{family}_off.cf32")
            res["afc_offset_hz"] = CLI_AFC_HZ.get(family, 3000.0)
            write_iq(off, freq_shift(sig, res["afc_offset_hz"] / FS))
            afc = {}
            for where, tag in ((dev, "card"), ("cpu", "cpu")):
                afc[tag], _ = decode(f"{family}_afc_{tag}",
                                     ["--iq", off, "--sonde", family,
                                      "--afc"], where)
            res["afc_lines"] = afc["card"][0].count(b"\n")
            check(afc["card"] == afc["cpu"] and res["afc_lines"] >= 2,
                  f"cli_narrowband {family}: --afc off the carrier, card and "
                  "CPU differ or nothing decoded")
            gates = _route(PipelineConfig(sonde=family, channels=8,
                                          use_pallas=True)) is not None
            res["kernel_gates_hold"] = gates
            if gates:
                k8, r = decode(f"{family}_c8_card",
                               ["--iq", iq, "--sonde", family, "--channels",
                                "8", "--config", cfg_pallas], dev)
                c8, _ = decode(f"{family}_c8_cpu",
                               ["--iq", iq, "--sonde", family, "--channels",
                                "8", "--config", cfg_pallas], "cpu")
                check(k8 == c8, f"cli_narrowband {family}: 8 channels with "
                      "use_pallas, card and CPU differ")
                steps = -(-sig.size // 48000)
                # the plain correlation once a template a step on every
                # route but the fused one (m10, ims100, mrzn1, imet4, c50)
                corr = kernel_launches(plain_route_bodies(PipelineConfig(
                    sonde=family, channels=8, use_pallas=True),
                    steps)).get("plain_corr", 0)
                check(any(r["launches"].values())
                      and r["launches"]["plain_corr"] == corr,
                      f"cli_narrowband {family}: launches {r['launches']}, "
                      f"expected {corr} of the plain correlation")
                res["c8_lines"] = k8[0].count(b"\n")
                res["c8_launches"] = {k: v for k, v in r["launches"].items()
                                      if v}
                kernel_runs[family] = {"launches": r["launches"],
                                       "bodies": r["bodies"],
                                       "steps": steps}
            result[family] = res
    emit({"phase": "cli_narrowband", "device": smi, "families": result})
    return kernel_runs


def phase_cli_checkpoint(torch, dev, smi, channels: int = 64,
                         n_blocks: int = 4):
    """``decode --checkpoint`` after block 1 and ``--resume`` in a fresh
    process state for the rest, against the uninterrupted run, for an rs41
    session of ``channels`` in f32 and in bf16 (no ml_dtypes loaded); then
    the JAX package's committed checkpoint (tests/data) restored into the
    port's session on the card, run on to the JAX run's telemetry."""
    import importlib.util

    from sondetpu_torch.cli.config import FrameworkConfig
    from sondetpu_torch.runtime import checkpoint
    from sondetpu_torch.runtime.pipeline import PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    # 1 s blocks: rs41_planes gives BLOCK_LEN samples a block
    qi, qq = rs41_planes("S1234567", -(-n_blocks * 48000 // BLOCK_LEN),
                         seed=4)
    qi, qq = qi[:n_blocks * 48000], qq[:n_blocks * 48000]
    res = {}
    with cli_dir() as d:
        whole = os.path.join(d, "whole.cs16")
        write_cs16(whole, qi, qq)
        first, rest = os.path.join(d, "a.cs16"), os.path.join(d, "b.cs16")
        write_cs16(first, qi[:48000], qq[:48000])
        write_cs16(rest, qi[48000:], qq[48000:])
        for dtype in ("f32", "bf16"):
            cfg = os.path.join(d, f"{dtype}.json")
            FrameworkConfig(compute_dtype=dtype, afc=True).save(cfg)
            base = ["decode", "--sonde", "rs41", "--channels", str(channels),
                    "--config", cfg, "--ref-epoch", CLI_REF_EPOCH,
                    "--device", str(dev)]
            j = {k: os.path.join(d, f"{dtype}_{k}.jsonl")
                 for k in ("whole", "a", "b")}
            ck = os.path.join(d, f"{dtype}.ckpt")
            run_cli(torch, base + ["--iq", whole, "--jsonl", j["whole"]],
                    f"cli_checkpoint {dtype} whole")
            run_cli(torch, base + ["--iq", first, "--jsonl", j["a"],
                                   "--checkpoint", ck],
                    f"cli_checkpoint {dtype} a")
            run_cli(torch, base + ["--iq", rest, "--jsonl", j["b"],
                                   "--resume", ck],
                    f"cli_checkpoint {dtype} b")
            want = jsonl_lines(j["whole"])
            check(len(want) >= channels
                  and jsonl_lines(j["a"]) + jsonl_lines(j["b"]) == want,
                  f"cli_checkpoint {dtype}: the resumed JSONL differs from "
                  "the uninterrupted run's")
            res[dtype] = {"lines": len(want),
                          "checkpoint_bytes": os.path.getsize(ck)}
    loaded = sorted(m for m in sys.modules if m.split(".")[0] == "ml_dtypes")
    check(not loaded, f"cli_checkpoint: ml_dtypes was loaded: {loaded}")
    # the JAX package's checkpoint, committed with the script that wrote it
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint", os.path.join(here, "tests", "data",
                                       "jax_checkpoint.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    r = fixture.RECIPE
    with open(fixture.EXPECTED) as f:
        expected = json.load(f)
    sess = DecoderSession(PipelineConfig(
        sonde=r["sonde"], channels=r["channels"], block_len=r["block_len"],
        compute_dtype=r["compute_dtype"], afc=r["afc"]), dev)
    checkpoint.load_session(sess, fixture.CKPT)
    check(sess.state.chipbuf.device.type == torch.device(dev).type
          and sess.state.chipbuf.dtype == torch.bfloat16,
          "cli_checkpoint: the JAX checkpoint's state is not on the card in "
          "bfloat16")
    pi, pq = fixture.planes()
    b = r["block_len"]
    for k in range(r["blocks_saved"], r["blocks"]):
        sess.process_block((pi[:, k * b:(k + 1) * b],
                            pq[:, k * b:(k + 1) * b]))
    check(fixture.telemetry_json(sess.telemetry) == expected["telemetry"],
          "cli_checkpoint: the JAX checkpoint, run on in the port on the "
          "card, differs from the JAX run's telemetry")
    res["jax_fixture"] = {"channels": r["channels"],
                          "blocks_after_resume": r["blocks"]
                          - r["blocks_saved"],
                          "checkpoint_bytes": os.path.getsize(fixture.CKPT),
                          "frames_seen": sess.frames_seen}
    emit({"phase": "cli_checkpoint", "channels": channels, "device": smi,
          "ml_dtypes_loaded": bool(loaded), **res})


def phase_fer(torch, dev, smi, families=CLI_FAMILIES):
    """The port's fer_sweep on the card against the same sweep on the CPU
    at the seed and frame counts of tests/test_torch_fer.py, on the plain
    path with one channel (the original's config) and on the kernel path
    with 8 channels: the decoded-unit key sets of every run (the clean one,
    then each SNR) equal, and the points. One exception, FER_TIE: in
    imet4's kernel-path clean run one block holds 11 sync peaks for its 10
    frame slots, the two weakest within about 1e-7, and the card keeps
    packet 124 where the CPU twins drop it. There the card's clean set may
    hold that packet's units beyond the CPU's, and nothing else, and each
    point's decoded count differs by just those units of its run."""
    from sondetpu_torch.bench import fer
    from sondetpu_torch.kernels import cuda

    out = {}
    launches = {}
    for family in families:
        snrs = [12.0, 16.0] if family in ("imet4", "c50") else [10.0, 14.0]
        for path, kw in (("plain", {}),
                         ("kernel", {"channels": 8, "use_pallas": True})):
            got = {}
            for where, tag in ((dev, "card"), ("cpu", "cpu")):
                runs = []
                cuda.reset_launches()
                t0 = time.perf_counter()
                res = fer.fer_sweep(family, snrs,
                                    n_frames=FER_FRAMES[family], seed=1,
                                    device=where, unit_sets=runs, **kw)
                got[tag] = (res, runs, time.perf_counter() - t0,
                            dict(cuda.launches))
            card, cpu = got["card"], got["cpu"]
            check(len(card[1]) == len(cpu[1]) == 1 + len(snrs),
                  f"fer {family} {path}: {len(card[1])} and {len(cpu[1])} "
                  "runs")
            # per run (clean, then each SNR): the units only one device has
            only = [sorted(map(str, a ^ b))[:4]
                    for a, b in zip(card[1], cpu[1])]
            tie = (FER_TIE[1] if path == "kernel" and family == FER_TIE[0]
                   else None)
            extra = card[1][0] - cpu[1][0]
            check(card[1][1:] == cpu[1][1:]
                  and not (cpu[1][0] - card[1][0])
                  and all(k[2] == tie for k in extra),
                  f"fer {family} {path}: the card's decoded units differ "
                  f"from the CPU's: {only}")
            channels = kw.get("channels", 1)
            check(all(a["decoded"] - b["decoded"]
                      == len(noisy & extra) / channels
                      for a, b, noisy in zip(card[0]["points"],
                                             cpu[0]["points"], card[1][1:]))
                  and (bool(extra) or card[0] == cpu[0]),
                  f"fer {family} {path}: the card's points differ from the "
                  f"CPU's: {card[0]['points']} {cpu[0]['points']}")
            if path == "kernel":
                check(any(card[3].values()),
                      f"fer {family} kernel: no kernel launched")
                launches[family] = card[3]
            out[f"{family}_{path}"] = {
                "points": card[0]["points"],
                "cpu_points": cpu[0]["points"],
                "units": card[0]["fer_denominator_clean_units"],
                "units_on_one_device": [len(a ^ b)
                                        for a, b in zip(card[1], cpu[1])],
                "differing_units": only,
                "card_seconds": card[2], "cpu_seconds": cpu[2]}
    emit({"phase": "fer", "device": smi, "seed": 1, "frames": FER_FRAMES,
          "sweeps": out})
    return launches


# the bandlimited wideband generator (wide_blocks): narrowband taps per
# output phase of its polyphase interpolator, its Kaiser window's beta and
# its cutoff in Hz (m10 fills +/-17 kHz; the first image lies at 31 kHz)
INTERP_TAPS = 24
INTERP_BETA = 8.0
INTERP_CUTOFF = 24000.0
# the AutoFleet phase's carriers at 2048 bins, (bin, family, serial, offset
# Hz, start s, stop s or None): present from block 0, one off the grid, one
# that launches mid-run and one that stops; far enough apart for the scan's
# 24 kHz PSD bins (nfft 4096 at 98.3 MHz) to keep their runs apart
AUTO_CARRIERS = ((1, "rs41", "S1234567", 0.0, 0.0, None),
                 (6, "m10", "910-2-12345", 0.0, 0.0, None),
                 (12, "rs41", "T7654321", 3150.0, 0.0, None),
                 (20, "m10", "A05-3-54321", 0.0, 3.0, None),
                 (30, "dfm", "1234567", 0.0, 0.0, 2.5))
AUTO_DROP_IDLE = 2
# noise std per component against unit carriers: ~30 dB over the noise in
# a 24 kHz PSD bin, below the Hann window's -31 dB sidelobes
AUTO_NOISE = 1.0
# the 16-bin AutoFleet and unfused fleet: a carrier of every kernel family
# (K1-K3 rs41 and dfm, K7 m10, K8 imet4), one off the grid
AUTO16_CARRIERS = ((2, "rs41", "S1234567", 0.0, 0.0, None),
                   (5, "m10", "910-2-12345", 0.0, 0.0, None),
                   (9, "imet4", "", 1500.0, 0.0, None),
                   (13, "dfm", "1234567", 0.0, 0.0, None))


def interpolator_taps(n_bins: int) -> np.ndarray:
    """[INTERP_TAPS, n_bins] float32 H with H[j, p] = h[p + (T - 1 - j) N]
    of a Kaiser-windowed sinc lowpass h at INTERP_CUTOFF of the wideband
    rate N * FS, gain N (each phase sums to about 1), so that
    y[m N + p] = sum_j x[m - T + 1 + j] H[j, p] upsamples x by N. Its
    images lie some 80 dB down, where fleet_blocks' zero-order hold leaves
    a copy of each carrier 20-30 dB down in the bins beside it, which the
    spectrum scan finds."""
    t, n = INTERP_TAPS, n_bins
    x = np.arange(t * n) - (t * n - 1) / 2.0
    fc = INTERP_CUTOFF / (n * FS)
    h = 2.0 * fc * np.sinc(2.0 * fc * x) * np.kaiser(t * n, INTERP_BETA) * n
    return np.ascontiguousarray(h.reshape(t, n)[::-1]).astype(np.float32)


def wide_blocks(torch, dev, n_blocks: int, seed: int, carriers,
                n_bins: int = N_BINS, block_len: int = 48000,
                noise: float = AUTO_NOISE):
    """Wideband (i, q) planes [n_bins * block_len] float32 on ``dev``, one
    block at a time: complex noise of std ``noise`` per component plus each
    carrier (bin, family, serial, offset Hz, start s, stop s or None),
    modulated at 48 kHz by the port's modulator, shifted by its offset,
    silent outside [start, stop), upsampled to n_bins x 48 kHz by
    interpolator_taps on the card and moved to its bin by fleet_blocks'
    phase ramp (column j of a block's [block_len, n_bins] view times
    exp(2 pi i k j / n_bins))."""
    from sondetpu_torch.sondes.modulate import freq_shift

    t = INTERP_TAPS
    n = n_blocks * block_len
    taps = torch.from_numpy(interpolator_taps(n_bins)).to(dev)
    placed = []
    for k, family, serial, offset, start, stop in carriers:
        iq = narrowband(family, serial, n, FS)
        if offset:
            iq = freq_shift(iq, offset / FS)
        s = np.arange(n) / FS
        iq = np.where((s >= start) & (s < (np.inf if stop is None else stop)),
                      iq, 0).astype(np.complex64)
        iq = np.concatenate([np.zeros(t - 1, np.complex64), iq])
        a = torch.from_numpy(np.stack([iq.real, iq.imag]).astype(
            np.float32)).to(dev)
        ang = 2.0 * np.pi * k * np.arange(n_bins) / n_bins
        ph = torch.from_numpy(np.stack([np.cos(ang), np.sin(ang)]).astype(
            np.float32)).to(dev)
        placed.append((a, ph))
    gen = torch.Generator(device=dev).manual_seed(seed)
    for b in range(n_blocks):
        wi = noise * torch.randn((block_len, n_bins), generator=gen,
                                 device=dev)
        wq = noise * torch.randn((block_len, n_bins), generator=gen,
                                 device=dev)
        for a, ph in placed:
            y = a[:, b * block_len:(b + 1) * block_len + t - 1] \
                .unfold(1, t, 1) @ taps                 # [2, block_len, N]
            wi += y[0] * ph[0] - y[1] * ph[1]
            wq += y[0] * ph[1] + y[1] * ph[0]
            del y
        yield wi.reshape(-1), wq.reshape(-1)


def autofleet_truths(carriers) -> dict:
    """(bin, family) -> the serial its decoder reports (imet4: "")."""
    return {(k, f): serial for k, f, serial, *_ in carriers}


def phase_autofleet(torch, dev, smi, n_bins: int = N_BINS,
                    n_blocks: int = 8):
    """AutoFleet.process_wideband at n_bins x 48 kHz, 1-s blocks made one at
    a time on the card (AUTO_CARRIERS), the original's defaults (use_pallas
    False, f32) with rescan_blocks=3, probe_blocks=2 and drop_idle_blocks:
    the tracked list ends with every live carrier at its bin and family and
    its serial decoded, the stopped one tracked and then dropped; K4 and K6
    launch once a fleet step and once a probe block of each
    classification, and no other kernel but the plain correlation of the
    plain-op groups and probes. Each block's wall (synchronized)
    and each rescan's PSD ms, classification s and rebuild s are timed by
    wrapping the functions the AutoFleet calls."""
    import sondetpu_torch.dsp.scan as tscan
    import sondetpu_torch.runtime.autofleet as taf
    from sondetpu_torch.kernels import cuda

    spent = {}

    def timed(key, fn):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
                spent[key + "_calls"] = spent.get(key + "_calls", 0) + 1
        return inner

    changes, rescans, walls, fleet_steps = [], [], [], []
    auto = taf.AutoFleet(n_bins, dev, block_len=48000, rescan_blocks=3,
                         probe_blocks=2, drop_idle_blocks=AUTO_DROP_IDLE,
                         on_change=lambda tr: changes.append(
                             [(t.sonde, t.pfb_bin) for t in tr]))
    rescan = auto._rescan

    def timed_rescan():
        spent.clear()
        t0 = time.perf_counter()
        rescan()
        torch.cuda.synchronize()
        rescans.append({
            "after_block": auto.blocks_seen - 1,
            "rescan_s": time.perf_counter() - t0,
            "psd_ms": 1e3 * spent.get("psd", 0.0),
            "classify_s": spent.get("classify", 0.0),
            "classify_calls": spent.get("classify_calls", 0),
            "rebuild_s": spent.get("rebuild", 0.0),
            "tracked": [(t.sonde, t.pfb_bin) for t in auto.tracked]})

    auto._rescan = timed_rescan
    auto._rebuild = timed("rebuild", auto._rebuild)
    psd, classify = tscan.welch_psd, taf.classify_carriers
    tscan.welch_psd = timed("psd", psd)
    taf.classify_carriers = timed("classify", classify)
    try:
        blocks = wide_blocks(torch, dev, n_blocks, seed=21,
                             carriers=AUTO_CARRIERS, n_bins=n_bins)
        torch.cuda.synchronize()
        cuda.reset_launches()
        for wi, wq in blocks:
            fleet_steps.append(auto.fleet is not None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            auto.process_wideband((wi, wq))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        del wi, wq, blocks
        launches = dict(cuda.launches)
    finally:
        tscan.welch_psd, taf.classify_carriers = psd, classify
    truths = autofleet_truths(AUTO_CARRIERS)
    live = {(k, f) for k, f, _, _, _, stop in AUTO_CARRIERS if stop is None}
    got = {(t.pfb_bin, t.sonde): t for t in auto.tracked}
    check(set(got) == live, f"autofleet: tracked {sorted(got)} != {live}")
    for key, t in got.items():
        check(t.telem is not None and t.telem.serial == truths[key],
              f"autofleet: {key} telemetry {t.telem}")
    stopped = [(f, k) for k, f, _, _, _, stop in AUTO_CARRIERS if stop]
    check(all(any(s in c for c in changes) for s in stopped)
          and not any(s in changes[-1] for s in stopped),
          f"autofleet: the stopped carrier was not tracked and dropped "
          f"{changes}")
    k_off, _, _, off, _, _ = AUTO_CARRIERS[2]
    t_off = got[(k_off, "rs41")]
    check(abs(t_off.center_hz - (k_off * FS + off)) < 1500.0,
          f"autofleet: off-grid centre {t_off.center_hz}")
    probes = 2 * sum(r["classify_calls"] for r in rescans)
    steps = sum(fleet_steps)
    check(launches["pfb_fir_stream"] == launches["pfb_dft"] == steps + probes
          and launches["plain_corr"] > 0 and launches["plain_fir"] > 0
          and not any(v for name, v in launches.items()
                      if name not in ("pfb_fir_stream", "pfb_dft",
                                      "plain_corr", "plain_fir")),
          f"autofleet: launches {launches} (fleet steps {steps}, probe "
          f"blocks {probes})")
    rescan_blocks = {r["after_block"] for r in rescans}
    steady = [w for b, (w, f) in enumerate(zip(walls, fleet_steps))
              if f and b not in rescan_blocks]
    emit({"phase": "autofleet", "bins": n_bins, "block_len": 48000,
          "blocks": n_blocks, "device": smi, "noise": AUTO_NOISE,
          "carriers": [list(c) for c in AUTO_CARRIERS],
          "tracked": [{"bin": t.pfb_bin, "sonde": t.sonde,
                       "center_hz": t.center_hz,
                       "seed_offset_hz": t.seed_offset_hz,
                       "found_block": t.found_block,
                       "serial": t.telem.serial} for t in auto.tracked],
          "changes": changes, "block_walls_s": walls,
          "steady_block_wall_s": statistics.median(steady),
          "steady_blocks": len(steady), "rescans": rescans,
          "fleet_steps": steps, "probe_blocks": probes,
          "launches": launches})
    del auto
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": steps + probes}


def phase_autofleet_cpu(torch, dev, smi, n_bins: int = 16,
                        n_blocks: int = 5):
    """``decode --wideband --bins 16 --auto`` of a cf32 capture with
    AUTO16_CARRIERS on the card and on the CPU (the kernels' twins) with
    the same --ref-epoch: the JSONL equal and every carrier decoded, at the
    CLI's default (plain-op groups: K4 and K6 only) and with use_pallas
    and --afc (K1-K3, K7 and K8 in the groups). Then the JAX package's
    AutoFleet checkpoint (tests/data) loaded on the card and run on: the
    JAX package's own continuation."""
    import importlib.util

    from sondetpu_torch.cli.config import FrameworkConfig
    from sondetpu_torch.runtime import checkpoint
    from sondetpu_torch.runtime.autofleet import AutoFleet

    truths = autofleet_truths(AUTO16_CARRIERS)
    runs, out = {}, {}
    with cli_dir() as d:
        iq = os.path.join(d, "wide16.cf32")
        with open(iq, "wb") as f:
            for wi, wq in wide_blocks(torch, dev, n_blocks, seed=22,
                                      carriers=AUTO16_CARRIERS,
                                      n_bins=n_bins, noise=0.05):
                torch.stack([wi, wq], -1).cpu().numpy().tofile(f)
        for key, use_pallas, afc in (("default", False, False),
                                     ("use_pallas_afc", True, True)):
            cfg = os.path.join(d, f"{key}.json")
            FrameworkConfig(use_pallas=use_pallas).save(cfg)
            lines, card = {}, None
            for where, device in (("card", str(dev)), ("cpu", "cpu")):
                j = os.path.join(d, f"{key}_{where}.jsonl")
                r = run_cli(torch, ["decode", "--iq", iq, "--wideband",
                                    "--bins", str(n_bins), "--auto",
                                    "--rescan", "3", "--config", cfg,
                                    "--jsonl", j, "--ref-epoch",
                                    CLI_REF_EPOCH, "--device", device]
                            + (["--afc"] if afc else []),
                            f"autofleet_cpu {key} {where}")
                lines[where] = jsonl_lines(j)
                card = card or r
            check(lines["card"] == lines["cpu"],
                  f"autofleet_cpu {key}: the card's JSONL differs from the "
                  "CPU's")
            recs = [json.loads(x) for x in lines["cpu"]]
            for (k, family), serial in truths.items():
                check(any(x["type"] == family and (x["serial"] == serial
                          if serial else x["lat"] == 40.0) for x in recs),
                      f"autofleet_cpu {key}: {family} in bin {k} not decoded")
            la = card["launches"]
            kernels = ("fused_frontend", "corr", "rs_clean",
                       "fused_dualtone_frontend", "fused_afsk_frontend")
            check(la["pfb_fir_stream"] > 0 and la["pfb_dft"] > 0
                  and all((la[k] > 0) == use_pallas for k in kernels),
                  f"autofleet_cpu {key}: launches {la}")
            runs[key] = {"launches": la, "bodies": card["bodies"],
                         "steps": n_blocks}
            out[key] = {"lines": len(recs), "launches": la,
                        "card_seconds": card["seconds"],
                        "last_stderr": card["stderr"].splitlines()[-1]}
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "jax_autofleet_checkpoint", os.path.join(
            here, "tests", "data", "jax_autofleet_checkpoint.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    with open(fixture.EXPECTED) as f:
        expected = json.load(f)
    r = expected["recipe"]
    updates, block = [], [0]
    auto = AutoFleet(device=dev, **fixture.autofleet_kwargs(r),
                     on_update=lambda ch, s, t: updates.append(
                         fixture.update_record(block[0], ch, s, t)))
    checkpoint.load_autofleet(auto, fixture.CKPT)
    wide = fixture.wideband(r)
    w = r["n_bins"] * r["block_len"]
    for block[0] in range(r["blocks_saved"], r["blocks"]):
        auto.process_wideband(wide[block[0] * w:(block[0] + 1) * w])
    check(updates == expected["updates"],
          "autofleet_cpu: the JAX AutoFleet checkpoint, run on in the port "
          "on the card, differs from the JAX package's continuation")
    out["jax_fixture"] = {"updates": len(updates),
                          "checkpoint_bytes": os.path.getsize(fixture.CKPT)}
    emit({"phase": "autofleet_cpu", "bins": n_bins, "blocks": n_blocks,
          "device": smi, "carriers": [list(c) for c in AUTO16_CARRIERS],
          "matches_cpu": True, **out})
    return runs


def phase_fleet_unfused(torch, dev, smi, n_bins: int = 16,
                        n_blocks: int = 3):
    """A 16-bin FleetSession (AUTO16_CARRIERS by bin and offset, the
    default use_pallas: every group on its kernel route, pipelined) fused
    and unfused on the card, block by block: the same updates and
    telemetry, and the same launches; each mode's synchronized wall per
    block."""
    from sondetpu_torch.dsp.channelizer import bin_and_offset
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession

    blocks = list(wide_blocks(torch, dev, n_blocks, seed=23,
                              carriers=AUTO16_CARRIERS, n_bins=n_bins,
                              noise=0.05))
    chans = []
    for k, family, _, off, _, _ in AUTO16_CARRIERS:
        b, resid = bin_and_offset(k * FS + off, FS, n_bins)
        chans.append(FleetChannel(pfb_bin=b, sonde=family, offset_hz=resid))
    res = {}
    for fused in (True, False):
        fleet = FleetSession(chans, n_bins, dev, fs_chan=FS,
                             block_len=48000, pipelined=True, fused=fused)
        torch.cuda.synchronize()
        cuda.reset_launches()
        ups, telem, walls = [], [], []
        for wi, wq in blocks:
            t0 = time.perf_counter()
            ups.append(fleet.process_wideband((wi, wq)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            telem.append({c: json.dumps(t.to_dict(), sort_keys=True)
                          for c, t in fleet.telemetry.items()})
        ups.append(fleet.flush())
        telem.append({c: json.dumps(t.to_dict(), sort_keys=True)
                      for c, t in fleet.telemetry.items()})
        torch.cuda.synchronize()
        res[fused] = (ups, telem, walls, dict(cuda.launches),
                      dict(cuda.body_launches), fleet.telemetry)
    (fu, ft, fw, fl, fb, ftel), (uu, ut, uw, ul, ub, _) = res[True], res[False]
    check(uu == fu and ut == ft, f"fleet_unfused: updates {uu} and telemetry "
          f"differ from the fused step's {fu}")
    check(ul == fl and ub == fb, f"fleet_unfused: launches {ul} != {fl}")
    for i, (_, family, serial, *_r) in enumerate(AUTO16_CARRIERS):
        t = ftel.get(i)
        check(t is not None and (t.serial == serial if serial
                                 else t.lat == 40.0),
              f"fleet_unfused: channel {i} ({family}) telemetry {t}")
    emit({"phase": "fleet_unfused", "bins": n_bins, "blocks": n_blocks,
          "device": smi, "updates": fu, "fused_block_walls_s": fw,
          "unfused_block_walls_s": uw, "launches": ul, "body_launches": ub})
    return {"launches": ul, "bodies": ub, "steps": n_blocks}


# -- the multi-device layer (sondetpu_torch.parallel) --------------------
# Shards on one card run in turn: the mesh phases' times show the cost of
# sharding, never scaling.

MESH_SERIALS = ("S1234567", "T7654321", "R0420042", "N2718281")
MESH_KERNEL_PLAN = (("rs41", 32), ("m10", 16), ("dfm", 8))
MESH_KERNEL_CARRIERS = ((1, "rs41", "S1234567"), (33, "m10", "910-2-12345"),
                        (50, "dfm", "1234567"))


def mesh_rs41_blocks(torch, dev, n_blocks: int, channels=None):
    """int16 (i, q) planes [channels, BLOCK_LEN] on ``dev``, one block at a
    time: channel ch carries MESH_SERIALS[ch % 4] (rs41_planes, each with
    its own seed) plus its own seeded noise of std 0.02 per component, so
    that no two channels are alike."""
    channels = channels or CHANNELS
    rows = [rs41_planes(s, n_blocks, seed=40 + k)
            for k, s in enumerate(MESH_SERIALS)]
    ri = torch.from_numpy(np.stack([r[0] for r in rows])).to(dev)
    rq = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
    idx = torch.arange(channels, device=dev) % len(MESH_SERIALS)
    gen = torch.Generator(device=dev).manual_seed(41)
    out = []
    for b in range(n_blocks):
        sl = slice(b * BLOCK_LEN, (b + 1) * BLOCK_LEN)
        planes = []
        for r in (ri, rq):
            x = r[idx, sl].float() + 0.02 * 32767 * torch.randn(
                (channels, BLOCK_LEN), generator=gen, device=dev)
            planes.append(x.round_().clamp_(-32768, 32767).to(torch.int16))
        out.append(tuple(planes))
    return out


def in_turns(torch, fns, rounds: int = 6, per: int = 2):
    """Synchronized wall times (ms) of each zero-argument callable, taken
    in turns (a, b, b, a, ...) so that all meet the same card."""
    times = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for k in order:
            for _ in range(per):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[k]()
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
    return times


def telemetry_text(telem) -> dict:
    # as JSON text: NaN fields (uncalibrated PTU) compare equal
    return {c: json.dumps(t.to_dict(), sort_keys=True)
            for c, t in telem.items()}


def phase_mesh_session(torch, dev, smi, n_blocks: int = 3):
    """RS41 at 2048 channels x 4 s (cs16, the kernel route in f32) on a
    4-way mesh on the one card: per block the sharded step's packed buffer
    and validity torch.equal to the unsharded step's; the mesh session's
    telemetry equal to the unsharded session's, each channel its serial;
    K1-K3 four times a step (once a shard), read from the mesh session's
    run alone; the step and the session's block, sharded and unsharded, in
    turns. Then the plain-op bf16 step (the JAX bench's default) at 64
    channels on an 8-way mesh, held to the CPU."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.parallel import make_mesh, sharded_pipeline_step
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    mesh = make_mesh(devices=[dev] * 4)
    cfg = PipelineConfig(sonde="rs41", channels=CHANNELS, block_len=BLOCK_LEN,
                         use_pallas=True, input_dtype="i16")
    blocks = mesh_rs41_blocks(torch, dev, n_blocks)
    pipe = Pipeline(cfg, dev)
    step_fn, shard_fn = sharded_pipeline_step(pipe, mesh)
    s0, s1 = pipe.init_state(), shard_fn(pipe.init_state())
    valid = 0
    for b, (qi, qq) in enumerate(blocks):
        s0, o0 = pipe._step_impl(s0, qi, qq)
        s1, o1 = step_fn(s1, shard_fn(qi), shard_fn(qq))
        check(torch.equal(torch.cat([o.packed for o in o1.parts]), o0.packed)
              and torch.equal(torch.cat([o.frame_valid for o in o1.parts]),
                              o0.frame_valid),
              f"mesh_session block {b}: the sharded step's packed buffer "
              "differs from the unsharded step's")
        valid += int(o0.frame_valid.sum())
    del s0, s1, o0, o1
    msess = DecoderSession(cfg, dev, mesh=mesh)
    usess = DecoderSession(cfg, dev, pipeline=pipe)
    torch.cuda.synchronize()
    cuda.reset_launches()
    for planes in blocks:
        msess.process_block(planes)
    torch.cuda.synchronize()
    launches, bodies = dict(cuda.launches), dict(cuda.body_launches)
    for planes in blocks:
        usess.process_block(planes)
    mt = telemetry_text(msess.telemetry)
    check(mt == telemetry_text(usess.telemetry),
          "mesh_session: telemetry differs from the unsharded session's")
    for ch in range(CHANNELS):
        t = msess.telemetry.get(ch)
        check(t is not None and t.serial == MESH_SERIALS[ch % 4]
              and abs(t.lat - 45.0) < 1e-4,
              f"mesh_session: channel {ch} telemetry {t}")
    want = {"fused_frontend": 4 * n_blocks, "corr": 4 * n_blocks,
            "rs_clean": 4 * n_blocks}
    check({k: launches[k] for k in want} == want
          and not any(v for k, v in launches.items() if k not in want),
          f"mesh_session: launches {launches}, expected {want}")
    check(bodies == {"fused_frontend:decim2_t41": 4 * n_blocks,
                     "corr:sign_l64": 4 * n_blocks,
                     "rs_clean:c384": 4 * n_blocks},
          f"mesh_session: bodies {bodies}")
    # the device step and the session's block, sharded and unsharded, in
    # turns; the sessions go on over the blocks (telemetry keeps merging)
    st = {"u": pipe.init_state(), "m": shard_fn(pipe.init_state())}
    k = {"u": 0, "m": 0}

    def unsharded_step():
        st["u"], _ = pipe._step_impl(st["u"], *blocks[k["u"] % n_blocks])
        k["u"] += 1

    def sharded_step():
        qi, qq = blocks[k["m"] % n_blocks]
        st["m"], _ = step_fn(st["m"], shard_fn(qi), shard_fn(qq))
        k["m"] += 1

    step_u, step_m = in_turns(torch, [unsharded_step, sharded_step])
    del st
    nb = {"u": 0, "m": 0}

    def block(key, sess):
        def run():
            sess.process_block(blocks[nb[key] % n_blocks])
            nb[key] += 1
        return run

    block_u, block_m = in_turns(torch, [block("u", usess),
                                        block("m", msess)], rounds=2, per=1)
    del msess, usess, blocks
    torch.cuda.empty_cache()
    plain = phase_mesh_plain_bf16(torch, dev)
    emit({"phase": "mesh_session", "device": smi, "mesh": mesh.shape,
          "channels": CHANNELS, "block_len": BLOCK_LEN, "blocks": n_blocks,
          "valid_frames": valid, "launches": {k: v for k, v in
                                              launches.items() if v},
          "body_launches": bodies,
          "note": "the 4 shards share one card and run in turn: the times "
                  "show the cost of sharding, not scaling",
          "step_ms": {"unsharded": statistics.median(step_u),
                      "sharded_4way": statistics.median(step_m),
                      "unsharded_all": step_u, "sharded_4way_all": step_m},
          "block_ms": {"unsharded": block_u, "sharded_4way": block_m},
          "plain_bf16_8way": plain})
    return {"launches": launches, "bodies": bodies, "steps": n_blocks}


def phase_mesh_plain_bf16(torch, dev, channels: int = 64, n_blocks: int = 2):
    """The plain-op RS41 step in bf16 (use_pallas=False, i16) at 64
    channels on an 8-way mesh on the card against the unsharded step on
    the CPU: validity and valid frame bytes block by block, the sessions'
    telemetry; no hand kernel launched."""
    from sondetpu_torch.kernels import cuda
    from sondetpu_torch.parallel import make_mesh, sharded_pipeline_step
    from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession

    cpu = torch.device("cpu")
    mesh = make_mesh(devices=[dev] * 8)
    cfg = PipelineConfig(sonde="rs41", channels=channels, block_len=BLOCK_LEN,
                         compute_dtype="bf16", input_dtype="i16")
    blocks = [(qi.cpu(), qq.cpu()) for qi, qq in
              mesh_rs41_blocks(torch, dev, n_blocks, channels)]
    gpu, host = Pipeline(cfg, dev), Pipeline(cfg, cpu)
    step_fn, shard_fn = sharded_pipeline_step(gpu, mesh)
    sg, sc = shard_fn(gpu.init_state()), host.init_state()
    msess = DecoderSession(cfg, dev, mesh=mesh)
    csess = DecoderSession(cfg, cpu, pipeline=host)
    torch.cuda.synchronize()
    cuda.reset_launches()
    frames = 0
    for b, (qi, qq) in enumerate(blocks):
        sg, og = step_fn(sg, shard_fn(qi.numpy()), shard_fn(qq.numpy()))
        sc, oc = host.step(sc, (qi, qq))
        vg = torch.cat([o.frame_valid for o in og.parts]).cpu()
        fg = torch.cat([o.frames for o in og.parts]).cpu()
        check(torch.equal(vg, oc.frame_valid)
              and torch.equal(fg[vg], oc.frames[oc.frame_valid]),
              f"mesh plain bf16 block {b}: validity or frame bytes differ "
              "from the CPU")
        frames += int(vg.sum())
        msess.process_block((qi.numpy(), qq.numpy()))
        csess.process_block((qi, qq))
    torch.cuda.synchronize()
    # each of the mesh's shards correlates on the card in both steps
    check(plain_kernels_only(cuda.launches, cfg,
                          2 * mesh.devices.size * n_blocks),
          f"mesh plain bf16: hand kernels launched {dict(cuda.launches)}")
    check(telemetry_text(msess.telemetry) == telemetry_text(csess.telemetry)
          and len(msess.telemetry) == channels,
          "mesh plain bf16: telemetry differs from the CPU session's")
    return {"channels": channels, "mesh": mesh.shape, "blocks": n_blocks,
            "valid_frames": frames}


def mesh_fleet_run(torch, fleet, blocks):
    """Per block the updates, the telemetry after it and the synchronized
    wall time; launches and bodies over the run (counts set to 0 just
    before it)."""
    from sondetpu_torch.kernels import cuda

    torch.cuda.synchronize()
    cuda.reset_launches()
    ups, telem, walls = [], [], []
    for wi, wq in blocks:
        t0 = time.perf_counter()
        ups.append(fleet.process_wideband((wi, wq)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        telem.append(telemetry_text(fleet.telemetry))
    return ups, telem, walls, dict(cuda.launches), dict(cuda.body_launches)


def phase_mesh_fleet(torch, dev, smi, n_blocks: int = 3):
    """The fused mesh fleet. (a) 2048 bins x 1 s with bench.py's channel
    map (1230 rs41, 614 m10, 204 dfm; no group divides by 8, so each takes
    the plain-op route, as in the original) on a 2-way mesh on the card,
    every group sharded (_mp_order): updates and telemetry equal to the
    unsharded fused fleet's block by block, K4 and K6 once a block. (b) the
    kernel routes: 56 channels in 64 bins (32 rs41, 16 m10, 8 dfm) on a
    4-way mesh, against the unsharded fused fleet: K1-K3, K7, K4 and K6
    launched. (c) 16 rs41 channels in 16 bins and one m10 (which stays on
    the device: _mp_local) on an 8-way mesh, card against CPU. Each with
    its per-block walls, sharded and unsharded in turns for (a)."""
    from sondetpu_torch.parallel import make_mesh
    from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession

    nb_a = 48000
    chans = [FleetChannel(pfb_bin=k, sonde=fleet_family(k))
             for k in range(N_BINS)]
    mesh2 = make_mesh(devices=[dev] * 2)
    blocks = list(fleet_blocks(torch, dev, n_blocks, seed=51, n_bins=N_BINS,
                               block_len=nb_a))
    fm = FleetSession(chans, N_BINS, dev, block_len=nb_a, mesh=mesh2,
                      use_pallas=False)
    fu = FleetSession(chans, N_BINS, dev, block_len=nb_a, use_pallas=False)
    check(fm._fused_mesh and not fm._mp_local
          and [g[0] for g in fm._mp_order] == ["rs41", "m10", "dfm"],
          "mesh_fleet: every group of the 2048-bin map should shard")
    mu, mtel, mwall, launches, bodies = mesh_fleet_run(torch, fm, blocks)
    uu, utel, uwall, _, _ = mesh_fleet_run(torch, fu, blocks)
    check(mu == uu and mtel == utel, f"mesh_fleet: updates {mu} and "
          f"telemetry differ from the unsharded fused fleet's {uu}")
    telem = fm.telemetry
    for k, family, serial in FLEET_CARRIERS:
        check(telem.get(k) is not None and telem[k].serial == serial,
              f"mesh_fleet: channel {k} ({family}) telemetry {telem.get(k)}")
    # every group's shards correlate with the plain correlation kernel and
    # filter with the plain filter
    plain = {}
    for _, (_, sess) in fm.groups.items():
        for k, v in kernel_launches(plain_route_bodies(sess.config,
                                                       1)).items():
            plain[k] = plain.get(k, 0) + mesh2.devices.size * n_blocks * v
    check(launches["pfb_fir_stream"] == n_blocks == launches["pfb_dft"]
          and all(launches[k] == v for k, v in plain.items())
          and sum(launches.values()) == 2 * n_blocks + sum(plain.values()),
          f"mesh_fleet: launches {launches}, expected {plain}")
    run_a = {"launches": launches, "bodies": bodies, "steps": n_blocks}
    nk = {"m": 0, "u": 0}

    def block(key, fleet):
        def run():
            fleet.process_wideband(blocks[nk[key] % n_blocks])
            nk[key] += 1
        return run

    wall_u, wall_m = in_turns(torch, [block("u", fu), block("m", fm)],
                              rounds=2, per=1)
    del fm, fu, blocks
    torch.cuda.empty_cache()

    # (b) the kernel routes on a 4-way mesh
    n_bins = 64
    families = [s for s, n in MESH_KERNEL_PLAN for _ in range(n)]
    chans = [FleetChannel(pfb_bin=b, sonde=s) for b, s in enumerate(families)]
    blocks = list(fleet_blocks(torch, dev, n_blocks, seed=52, n_bins=n_bins,
                               block_len=nb_a, carriers=MESH_KERNEL_CARRIERS))
    fm = FleetSession(chans, n_bins, dev, block_len=nb_a,
                      mesh=make_mesh(devices=[dev] * 4), use_pallas=True)
    fu = FleetSession(chans, n_bins, dev, block_len=nb_a, use_pallas=True)
    check([sess.pipeline._route for _, _, sess in fm._order]
          == ["fused", "dualtone", "fused"],
          "mesh_fleet kernel routes: group routes")
    mu, mtel, _, klaunches, kbodies = mesh_fleet_run(torch, fm, blocks)
    uu, utel, _, _, _ = mesh_fleet_run(torch, fu, blocks)
    check(mu == uu and mtel == utel, f"mesh_fleet kernel routes: updates "
          f"{mu} and telemetry differ from the unsharded fleet's {uu}")
    telem = fm.telemetry
    for k, family, serial in MESH_KERNEL_CARRIERS:
        check(telem.get(k) is not None and telem[k].serial == serial,
              f"mesh_fleet kernel routes: channel {k} ({family}) telemetry "
              f"{telem.get(k)}")
    want = {"pfb_fir_stream": n_blocks, "pfb_dft": n_blocks,
            "fused_frontend": 8 * n_blocks, "corr": 8 * n_blocks,
            "rs_clean": 4 * n_blocks, "fused_dualtone_frontend": 4 * n_blocks,
            "plain_corr": 8 * n_blocks}
    check({k: klaunches[k] for k in want} == want,
          f"mesh_fleet kernel routes: launches {klaunches}, expected {want}")
    run_b = {"launches": klaunches, "bodies": kbodies, "steps": n_blocks}
    del fm, fu, blocks
    torch.cuda.empty_cache()

    # (c) 16 rs41 (sharded 8-way) + 1 m10 (_mp_local), card against CPU
    chans = [FleetChannel(pfb_bin=k, sonde="rs41") for k in range(16)]
    chans.append(FleetChannel(pfb_bin=6, sonde="m10"))
    carriers = ((1, "rs41", "S1234567"), (6, "m10", "910-2-12345"))
    blocks = list(fleet_blocks(torch, dev, n_blocks, seed=53, n_bins=16,
                               block_len=nb_a, carriers=carriers))
    runs = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        fleet = FleetSession(chans, 16, d, block_len=nb_a,
                             mesh=make_mesh(devices=[d] * 8))
        check([g[0] for g in fleet._mp_order] == ["rs41"]
              and fleet._mp_local == ["m10"],
              "mesh_fleet 16 bins: rs41 sharded, m10 on the device")
        runs[label] = mesh_fleet_run(
            torch, fleet, [(wi.to(d), wq.to(d)) for wi, wq in blocks])[:2]
        if label == "card":
            telem = fleet.telemetry
    check(runs["card"] == runs["cpu"], "mesh_fleet 16 bins: card and CPU "
          f"differ: updates {runs['card'][0]} against {runs['cpu'][0]}")
    check(telem[1].serial == "S1234567" and telem[16].serial == "910-2-12345",
          f"mesh_fleet 16 bins: telemetry {telem}")
    emit({"phase": "mesh_fleet", "device": smi, "bins": N_BINS,
          "block_len": nb_a, "blocks": n_blocks, "mesh": mesh2.shape,
          "groups": {"rs41": 1230, "m10": 614, "dfm": 204},
          "updates": mu, "launches": {k: v for k, v in launches.items() if v},
          "kernel_routes": {"bins": n_bins, "mesh": {"chip": 4},
                            "launches": {k: v for k, v in klaunches.items()
                                         if v}, "body_launches": kbodies},
          "bins16_8way_updates": runs["card"][0],
          "note": "shards share one card and run in turn: the times show "
                  "the cost of sharding, not scaling",
          "block_ms": {"unsharded": wall_u, "sharded_2way": wall_m}})
    return run_a, run_b


def phase_mesh_processes(torch, smi, timeout: int = 600):
    """Two processes on the one card in a gloo group on 127.0.0.1, each
    with four positions of cuda:0 (tests/torch_mp_worker.py --full): the
    8-channel session and the 8-bin fleet decode exactly each process's
    channels and see every channel through the fan-in, with equal summed
    metrics and no per-block host upload of the fleet; the time-sharded
    front end across the processes equals the serial chain; and RS41 at
    2048 channels x 4 s, 1024 channels a process, likewise, with the
    fan-in's time per call."""
    import contextlib
    import socket
    import tempfile

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "torch_mp_worker.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    res = {}
    with tempfile.TemporaryDirectory() as d, contextlib.ExitStack() as files:
        paths = [(os.path.join(d, f"out{r}"), os.path.join(d, f"err{r}"))
                 for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, worker, str(r), str(port), "cuda", "--full"],
            stdout=files.enter_context(open(o, "w")),
            stderr=files.enter_context(open(e, "w")))
            for r, (o, e) in enumerate(paths)]
        try:
            # a rank that fails leaves the other waiting in a collective:
            # stop both at the first failure or at the time limit
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for p, (o, e) in zip(procs, paths):
            with open(o) as fo, open(e) as fe:
                out, err = fo.read(), fe.read()
            check(p.returncode == 0, f"mesh_processes: worker failed "
                  f"({p.returncode}):\n{err[-3000:]}")
            r = json.loads([ln for ln in out.splitlines()
                            if ln.startswith("{")][-1])
            res[r["rank"]] = r
    r0, r1 = res[0], res[1]
    check(r0["local_telemetry"] == [0, 1, 2, 3]
          and r1["local_telemetry"] == [4, 5, 6, 7],
          "mesh_processes: the session's local channels")
    check(r0["fleet_local"] == [0, 1, 2, 3]
          and r1["fleet_local"] == [4, 5, 6, 7],
          "mesh_processes: the fleet's local channels")
    check(r0["full_local"] == [0, 1023, 1024]
          and r1["full_local"] == [1024, 2047, 1024],
          f"mesh_processes: full-width local channels {r0['full_local']} "
          f"{r1['full_local']}")
    for r in (r0, r1):
        check(r["expected_local"] == r["local_telemetry"]
              and r["fan_channels"] == list(range(8))
              and abs(r["fan_lat0"] - 45.0) < 1e-3
              and r["serial0"] == "S1234567"
              and r["metrics"]["frames_decoded"] >= 8
              and r["fleet_fan"] == list(range(8))
              and r["fleet_shard_stats"]["host_uploads"] == 0
              and r["fleet_fused_mesh"] is True
              and r["time_parallel_shape"] == [4, 8192]
              and r["time_parallel_err"] <= 2e-4
              and r["full_fan"] == CHANNELS
              and r["full_serials"] == ["S1234567"]
              and r["full_fan_lats"] == [45.0]
              and r["full_metrics"]["frames_decoded"] > 0
              and r["full_metrics"]["frames_decoded"] % CHANNELS == 0,
              f"mesh_processes: rank {r['rank']}: {r}")
        want = {"fused_frontend": 12, "corr": 12, "rs_clean": 12}
        check({k: r["full_launches"].get(k, 0) for k in want} == want,
              f"mesh_processes: rank {r['rank']} launches "
              f"{r['full_launches']}")
    check(r0["metrics"] == r1["metrics"]
          and r0["full_metrics"] == r1["full_metrics"],
          "mesh_processes: the summed metrics differ between the ranks")
    launches = {k: r0["full_launches"].get(k, 0) + r1["full_launches"].get(k, 0)
                for k in r0["full_launches"]}
    emit({"phase": "mesh_processes", "device": smi, "processes": 2,
          "backend": "gloo", "mesh": r0["mesh"],
          "note": "both processes share one card: the times show the cost "
                  "of the fan-in and of sharding, not scaling",
          "full_metrics": r0["full_metrics"],
          "full_block_ms": {str(r["rank"]): r["full_block_ms"]
                            for r in (r0, r1)},
          "fanin_ms_per_call": {str(r["rank"]): r["fanin_ms"]
                                for r in (r0, r1)},
          "metrics_fanin_ms": {str(r["rank"]): r["metrics_fanin_ms"]
                               for r in (r0, r1)},
          "fleet_shard_stats": r0["fleet_shard_stats"],
          "launches": launches})
    return {"launches": launches, "bodies": {}, "steps": 3}


def phase_time_parallel(torch, dev, smi, rows_cpu: int = 16):
    """time_parallel_fir and time_parallel_frontend at [2048, 192000] f32
    on a 4-way mesh on the card: against the serial chain on the card
    (the FIR exactly; the front end within tests/test_parallel.py's 2e-4)
    and, on their first rows, against the CPU; each timed beside its
    serial chain."""
    from sondetpu_torch.dsp.fir import apply_windows, design_lowpass
    from sondetpu_torch.parallel import (frontend_serial, make_mesh,
                                         time_parallel_fir,
                                         time_parallel_frontend)

    mesh = make_mesh(devices=[dev] * 4)
    gen = torch.Generator(device=dev).manual_seed(61)
    xi = torch.randn((CHANNELS, BLOCK_LEN), generator=gen, device=dev)
    xq = torch.randn((CHANNELS, BLOCK_LEN), generator=gen, device=dev)
    taps = design_lowpass(5000.0, FS, 41)
    ct = taps
    mt = design_lowpass(2640.0, FS / 2, 41)
    kw = dict(decim=2, scale=3.18)

    def fir_serial(x):
        z = torch.zeros((x.shape[0], 40), device=x.device)
        return apply_windows(torch.cat([z, x], -1), taps)

    out = {}
    y = time_parallel_fir(xi, taps, mesh)
    check(torch.equal(y, fir_serial(xi)), "time_parallel_fir differs from "
          "the serial FIR on the card")
    cpu_err = float((y[:rows_cpu].cpu() - fir_serial(xi[:rows_cpu].cpu()))
                    .abs().max())
    check(cpu_err <= 2e-4, f"time_parallel_fir: card against CPU {cpu_err}")
    out["fir"] = {"cpu_max_abs_err": cpu_err}
    del y
    for dc in (False, True):
        got = time_parallel_frontend(xi, xq, ct, mt, mesh, dc_block=dc, **kw)
        want = frontend_serial(xi, xq, ct, mt, dc_block=dc, **kw)
        err = float((got - want).abs().max())
        check(got.shape == (CHANNELS, BLOCK_LEN // 2) and err <= 2e-4,
              f"time_parallel_frontend dc_block={dc}: {err} from the serial "
              "chain on the card")
        cpu = frontend_serial(xi[:rows_cpu].cpu(), xq[:rows_cpu].cpu(), ct,
                              mt, dc_block=dc, **kw)
        cerr = float((got[:rows_cpu].cpu() - cpu).abs().max())
        check(cerr <= 2e-4, f"time_parallel_frontend dc_block={dc}: card "
              f"against CPU {cerr}")
        out[f"frontend_dc{int(dc)}"] = {"serial_max_abs_err": err,
                                        "cpu_max_abs_err": cerr}
        del got, want
    fir_u, fir_m = in_turns(torch, [lambda: fir_serial(xi),
                                    lambda: time_parallel_fir(xi, taps, mesh)],
                            rounds=2, per=2)
    fe_u, fe_m = in_turns(torch, [
        lambda: frontend_serial(xi, xq, ct, mt, **kw),
        lambda: time_parallel_frontend(xi, xq, ct, mt, mesh, **kw)],
        rounds=2, per=2)
    emit({"phase": "time_parallel", "device": smi, "shape": [CHANNELS,
                                                             BLOCK_LEN],
          "mesh": mesh.shape, **out,
          "note": "4 blocks on one card in turn: the cost of the halos, "
                  "not scaling",
          "fir_ms": {"serial": statistics.median(fir_u),
                     "time_parallel_4way": statistics.median(fir_m)},
          "frontend_ms": {"serial": statistics.median(fe_u),
                          "time_parallel_4way": statistics.median(fe_m)}})


def phase_dryrun(torch, dev, smi):
    """sondetpu_torch.parallel.dryrun.dryrun_multichip(4, cuda:0)."""
    from sondetpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(4, dev)
    emit({"phase": "dryrun_multichip", "device": smi, "n_devices": 4,
          "seconds": time.perf_counter() - t0})


LIB_CPU_ROWS = 8           # rows of each library result held to the CPU
RESAMPLE_ROWS = 1024       # rational_resample 48 -> 50 kHz: its float32
                           # [rows, n_out, nph] gather is 1024 x 200000 x 9
                           # x 4 B = 7.37 GB


def lib_close(name: str, got, want, rel: float) -> float:
    """max|got - want| <= rel * max|want| with got taken to the CPU (rel <
    1, so a zero output fails): tests/test_torch_library.py's limits."""
    import torch

    got = got.cpu()
    if want.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    scale = float(want.abs().max())
    err = float((got.to(want.dtype) - want).abs().max())
    check(tuple(got.shape) == tuple(want.shape) and 0 < rel < 1
          and scale > 0 and err <= rel * scale,
          f"library {name}: card against CPU {err} (limit {rel} x {scale})")
    return err


def nrz_rows(torch, dev, gen, c: int, n: int, sps: int):
    """[c, n] float32 boxcar-matched NRZ of random bits plus noise of std
    0.1 (tests/test_sync.py's signal), made on ``dev``."""
    from sondetpu_torch.dsp.fir import boxcar_taps, fir_filter

    bits = torch.randint(0, 2, (c, n // sps), generator=gen, device=dev)
    nrz = (bits.to(torch.float32) * 2 - 1).repeat_interleave(sps, dim=1)
    return fir_filter(nrz, boxcar_taps(sps)) + 0.1 * torch.randn(
        (c, n), generator=gen, device=dev)


def phase_library(torch, dev, smi, c: int = CHANNELS, n: int = BLOCK_LEN,
                  resample_rows: int = RESAMPLE_ROWS,
                  sub: int = LIB_CPU_ROWS):
    """The public DSP, timing, coding and physics API on the card at the
    sizes users run (the FIR, demodulators, AGC and decimator at [2048,
    192000], rational_resample 48 -> 50 kHz on 1024 rows, symbol_sample
    at [2048, 96000] sps 5, gardner_scan at [2048, 24000] with 4800
    symbols, the coding functions on [2048, 2560] bits, the physics on 1e6
    values): each result against the port's CPU result on its first rows
    (the coding and physics on all), within tests/test_torch_library.py's
    limits and exact where those are; fir_apply and fm_apply over 4
    chunks torch.equal to fir_filter and fm_demod on the card; each timed
    by CUDA events. The FIR's filters are the one hand kernel here, the
    plain filter (``apply_windows`` on the card)."""
    import sondetpu_torch.dsp as tdsp
    import sondetpu_torch.sync as tsync
    from sondetpu_torch import physics
    from sondetpu_torch.dsp.agc import agc_apply, agc_init
    from sondetpu_torch.dsp.resample import make_rational_resampler
    from sondetpu_torch.kernels import cuda

    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(71)
    res = {}
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()

    def on_card(*ts):
        check(all(t.device.type == "cuda" for t in ts),
              "library: a result left the card")

    def timed(name, fn, reps, shape, **extra):
        res[name] = {"ms": cuda_ms(torch, fn, reps), "shape": list(shape),
                     **extra}

    # the FIR: fir_filter, fir_apply over 4 chunks, polyphase_decimate
    taps = tdsp.design_lowpass(5000.0, FS, 41)
    x = torch.randn((c, n), generator=gen, device=dev)
    y = tdsp.fir_filter(x, taps)
    on_card(y)
    err = lib_close("fir_filter", y[:sub], tdsp.fir_filter(x[:sub].cpu(),
                                                           taps), 1e-5)
    st = tdsp.fir_init(c, 41, device=dev)
    q = n // 4
    for k in range(4):
        st, yk = tdsp.fir_apply(st, x[:, k * q:(k + 1) * q], taps)
        check(torch.equal(yk, y[:, k * q:(k + 1) * q]),
              f"library fir_apply chunk {k} differs from fir_filter")
    del y, yk
    timed("fir_filter", lambda: tdsp.fir_filter(x, taps), 3, x.shape,
          ntaps=41, max_abs_err=err)
    st0 = tdsp.fir_init(c, 41, device=dev)
    timed("fir_apply", lambda: tdsp.fir_apply(st0, x, taps), 3, x.shape,
          ntaps=41, chunks_equal_fir_filter=4)
    y = tdsp.polyphase_decimate(x, 2, fs=FS)
    on_card(y)
    err = lib_close("polyphase_decimate", y[:sub],
                    tdsp.polyphase_decimate(x[:sub].cpu(), 2, fs=FS), 1e-5)
    del y
    timed("polyphase_decimate", lambda: tdsp.polyphase_decimate(x, 2, fs=FS),
          3, x.shape, factor=2, ntaps=17, max_abs_err=err)
    # the AGC: three blocks (attack, then decay) against the CPU
    xq = torch.randn((c, n), generator=gen, device=dev)
    sg, sc = agc_init(c, device=dev), agc_init(sub, device=cpu)
    for level in (5.0, 5.0, 0.2):
        sg, yi, yq, g = agc_apply(sg, x * level, xq * level)
        sc, ci, cq, gc = agc_apply(sc, x[:sub].cpu() * level,
                                   xq[:sub].cpu() * level)
        on_card(yi, yq, g)
        err = max(lib_close("agc_apply gain", g[:sub], gc, 1e-5),
                  lib_close("agc_apply y_i", yi[:sub], ci, 1e-5),
                  lib_close("agc_apply y_q", yq[:sub], cq, 1e-5))
    del yi, yq
    timed("agc_apply", lambda: agc_apply(sg, x, xq), 5, x.shape,
          max_abs_err=err)
    # rational_resample 48 -> 50 kHz
    up, down, rtaps = make_rational_resampler(FS, 50000.0)
    xr = x[:resample_rows]
    nph = -(-len(rtaps) // up)
    y = tdsp.rational_resample(xr, up, down, rtaps)
    on_card(y)
    err = lib_close("rational_resample", y[:sub], tdsp.rational_resample(
        xr[:sub].cpu(), up, down, rtaps), 1e-5)
    del y
    timed("rational_resample", lambda: tdsp.rational_resample(
        xr, up, down, rtaps), 3, xr.shape, up=up, down=down, nph=nph,
        gather_bytes=resample_rows * (n * up // down) * nph * 4,
        max_abs_err=err)
    del x, xq, xr
    torch.cuda.empty_cache()
    # the FM discriminator on complex64 [c, n], and fm_apply over 4 chunks
    phase = torch.cumsum(0.3 * torch.randn((c, n), generator=gen,
                                           device=dev), dim=1)
    amp = 1.0 + 0.1 * torch.randn((c, n), generator=gen, device=dev)
    iq = torch.polar(amp, phase)
    del phase, amp
    audio = tdsp.fm_demod(iq, FS, 2400.0)
    on_card(audio)
    err = lib_close("fm_demod", audio[:sub],
                    tdsp.fm_demod(iq[:sub].cpu(), FS, 2400.0), 1e-5)
    fst = tdsp.fm_init(c, device=dev)
    for k in range(4):
        fst, ak = tdsp.fm_apply(fst, iq[:, k * q:(k + 1) * q], FS, 2400.0)
        check(torch.equal(ak, audio[:, k * q:(k + 1) * q]),
              f"library fm_apply chunk {k} differs from fm_demod")
    del audio, ak
    timed("fm_demod", lambda: tdsp.fm_demod(iq, FS, 2400.0), 3, iq.shape,
          dtype="complex64", input_bytes=iq.numel() * 8, max_abs_err=err)
    fst0 = tdsp.fm_init(c, device=dev)
    timed("fm_apply", lambda: tdsp.fm_apply(fst0, iq, FS, 2400.0), 3,
          iq.shape, dtype="complex64", chunks_equal_fm_demod=4)
    del iq
    torch.cuda.empty_cache()
    # the AFSK discriminator on imet4's tones (1200/2200 Hz, 1200 Bd)
    sym = torch.randint(0, 2, (c, n // 40), generator=gen, device=dev)
    f = torch.where(sym > 0, 1200.0, 2200.0).repeat_interleave(40, dim=1)
    aud = torch.sin(torch.cumsum(f * (2 * np.pi / FS), dim=1)) + 0.05 * \
        torch.randn((c, n), generator=gen, device=dev)
    del f
    y = tdsp.afsk_discriminate(aud, FS, 1200.0, 2200.0, 1200.0)
    on_card(y)
    err = lib_close("afsk_discriminate", y[:sub], tdsp.afsk_discriminate(
        aud[:sub].cpu(), FS, 1200.0, 2200.0, 1200.0), 2e-5)
    ends = torch.arange(1, n // 40, device=dev) * 40 - 1
    check(torch.equal(y[:, ends] > 0, sym[:, :-1] > 0),
          "library afsk_discriminate: a symbol's sign is not its tone")
    del y, sym
    timed("afsk_discriminate", lambda: tdsp.afsk_discriminate(
        aud, FS, 1200.0, 2200.0, 1200.0), 3, aud.shape, max_abs_err=err)
    del aud
    torch.cuda.empty_cache()
    # symbol_sample at [c, 96000] sps 5, two blocks (unlocked, locked)
    nb, sps = n // 2, 5
    xs = nrz_rows(torch, dev, gen, c, 2 * nb, sps)
    n_sym = nb // sps + 1
    sg, sc = tsync.timing_init(c, device=dev), tsync.timing_init(sub,
                                                                  device=cpu)
    lim = 2 * float(np.spacing(np.float32(nb)))
    err = perr = 0.0
    for b in range(2):
        blk = xs[:, b * nb:(b + 1) * nb]
        sg, soft, valid = tsync.symbol_sample(sg, blk, sps, n_sym)
        sc, csoft, cvalid = tsync.symbol_sample(sc, blk[:sub].cpu(), sps,
                                                n_sym)
        on_card(soft, valid, sg.pos)
        check(torch.equal(valid[:sub].cpu(), cvalid) and bool(cvalid.any()),
              f"library symbol_sample block {b}: valid differs from the CPU")
        err = max(err, lib_close("symbol_sample soft", soft[:sub], csoft,
                                 2e-4))
        perr = max(perr, float((sg.pos[:sub].cpu() - sc.pos).abs().max()))
        check(perr <= lim, f"library symbol_sample: phase {perr} > {lim}")
    del soft, valid
    timed("symbol_sample", lambda: tsync.symbol_sample(sg, blk, sps, n_sym),
          5, blk.shape, sps=sps, n_sym=n_sym, max_abs_err=err,
          phase_max_abs_err=perr)
    # gardner_scan at [c, 24000] with 4800 symbols
    xg = xs[:, :24000].contiguous()
    del xs, blk
    soft, valid = tsync.gardner_scan(xg, float(sps), 4800)
    csoft, cvalid = tsync.gardner_scan(xg[:sub].cpu(), float(sps), 4800)
    on_card(soft, valid)
    check(torch.equal(valid[:sub].cpu(), cvalid),
          "library gardner_scan: valid differs from the CPU")
    err = lib_close("gardner_scan", soft[:sub], csoft, 1e-5)
    del soft, valid
    timed("gardner_scan", lambda: tsync.gardner_scan(xg, float(sps), 4800),
          1, xg.shape, n_sym=4800, max_abs_err=err)
    del xg
    # the coding functions on [c, 2560] bits, all rows against the CPU
    bits = torch.randint(0, 2, (c, 2560), generator=gen, device=dev,
                         dtype=torch.uint8)
    prev = torch.randint(0, 2, (c,), generator=gen, device=dev,
                         dtype=torch.uint8)
    mask = np.random.default_rng(71).integers(0, 256, 64, dtype=np.uint8)
    cb, cprev = bits.cpu(), prev.cpu()
    by = tsync.bits_to_bytes(bits)
    coding = {
        "nrzs_decode": (lambda: tsync.nrzs_decode(bits, prev),
                        tsync.nrzs_decode(cb, cprev), bits.shape),
        "bits_to_bytes": (lambda: tsync.bits_to_bytes(bits),
                          tsync.bits_to_bytes(cb), bits.shape),
        "bytes_to_bits": (lambda: tsync.bytes_to_bits(by),
                          tsync.bytes_to_bits(tsync.bits_to_bytes(cb)),
                          by.shape),
        "descramble_xor": (lambda: tsync.descramble_xor(by, mask),
                           tsync.descramble_xor(tsync.bits_to_bytes(cb),
                                                mask), by.shape)}
    for name, (fn, want, shape) in coding.items():
        got = fn()
        on_card(got)
        check(got.dtype == torch.uint8 and torch.equal(got.cpu(), want),
              f"library {name}: card differs from the CPU")
        timed(name, fn, 20, shape, exact=True)
    check(torch.equal(tsync.bytes_to_bits(by), bits),
          "library: bytes_to_bits(bits_to_bytes(bits)) is not bits")
    # the physics on 1e6 values, all against the CPU
    m = 1_000_000
    alt = torch.empty(m, device=dev).uniform_(-500.0, 90000.0, generator=gen)
    temp = torch.empty(m, device=dev).uniform_(-60.0, 40.0, generator=gen)
    rh = torch.empty(m, device=dev).uniform_(1.0, 100.0, generator=gen)
    p = physics.altitude_to_pressure_torch(alt)
    on_card(p)
    err = lib_close("altitude_to_pressure_torch", p,
                    physics.altitude_to_pressure_torch(alt.cpu()), 2e-5)
    timed("altitude_to_pressure_torch",
          lambda: physics.altitude_to_pressure_torch(alt), 20, alt.shape,
          max_abs_err=err)
    d = physics.dewpt_torch(temp, rh)
    on_card(d)
    err = lib_close("dewpt_torch", d, physics.dewpt_torch(temp.cpu(),
                                                          rh.cpu()), 2e-5)
    timed("dewpt_torch", lambda: physics.dewpt_torch(temp, rh), 20,
          temp.shape, max_abs_err=err)
    torch.cuda.synchronize()
    launched = {k: v for k, v in cuda.launches.items() if v}
    check(list(launched) == ["plain_fir"],
          f"library: hand-kernel launches {launched}, expected the plain "
          "filter's alone")
    torch.cuda.empty_cache()
    emit({"phase": "library", "device": smi, "cpu_rows": sub,
          "seconds": time.perf_counter() - t0,
          "hand_kernel_launches": launched, "functions": res})
    return res


def phase_oracle(torch, dev, smi, card: str = "cuda"):
    """python -m sondetpu_torch.bench.oracle --selftest on the card
    (--device cuda, in this process) and on the CPU: every family ok and
    every expected frame bit-exact on the card, and the card's JSON report
    equal to the CPU's. (``card="cpu"`` rehearses the phase on the CPU.)"""
    import contextlib
    import io

    from sondetpu_torch.bench import oracle
    from sondetpu_torch.kernels import cuda

    reports, seconds, launched = {}, {}, {}
    with cli_dir() as d:
        for label, device in (("cuda", card), ("cpu", "cpu")):
            path = os.path.join(d, f"oracle_{label}.json")
            torch.cuda.synchronize()
            cuda.reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = oracle.main(["--selftest", "--device", device,
                                  "--out", path])
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - t0
            launched[label] = dict(cuda.launches)
            check(rc == 0, f"oracle --selftest --device {device}: exit code "
                  f"{rc}: {out.getvalue()[-2000:]}")
            with open(path) as f:
                reports[label] = f.read()
    rep = json.loads(reports["cuda"])
    check(sorted(rep) == sorted(oracle.FAMILIES),
          f"oracle: families {sorted(rep)}")
    for fam, e in rep.items():
        check(e["ok"] is True and e["frames_decoded"] > 0,
              f"oracle {fam}: not ok on the card: {e}")
        check(e.get("frames_bit_exact", 1) == e.get("frames_expected", 1),
              f"oracle {fam}: {e.get('frames_bit_exact')} of "
              f"{e.get('frames_expected')} frames bit-exact")
    check(reports["cuda"] == reports["cpu"],
          "oracle: the card's report differs from the CPU's")
    emit({"phase": "oracle", "device": smi, "seconds": seconds,
          "equal_to_cpu": True,
          "hand_kernel_launches": {k: sum(v.values())
                                   for k, v in launched.items()},
          "families": {fam: {k: e[k] for k in (
              "frames_decoded", "frames_bit_exact", "frames_expected", "ok")
              if k in e} for fam, e in rep.items()}})
    return rep


def subset(entry, keys=("max_abs_err", "ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by", "f32_body_ms")):
    return {k: entry[k] for k in keys if k in entry}


def main() -> int:
    import torch

    if sys.argv[1:2] in (["--dualtone-steps"], ["--m10-steps"]):
        # the ims100 and mrzn1 steps (or m10's FM fallback's) of checkouts
        # in turns:
        # python3 chip_smoke.py --dualtone-steps build/parent . . build/parent
        phase_env(torch)
        phase_dualtone_steps(sys.argv[2:] or ["."],
                             sys.argv[1][2:].split("-")[0])
        return 0
    smi = phase_env(torch)
    dev = torch.device("cuda", 0)
    phase_build()
    if sys.argv[1:2] == ["--dualtone-steps-here"]:
        phase_dualtone_steps_here(torch, dev, smi, *sys.argv[2:4])
        return 0
    if sys.argv[1:] == ["--profile"]:
        # the step breakdowns only: python3 chip_smoke.py --profile
        phase_resources()
        for family in ("rs41", "imet4", "c50", "ims100"):
            phase_profile(torch, dev, family)
            torch.cuda.empty_cache()
        phase_profile(torch, dev, "rs41", dtype="bf16")
        torch.cuda.empty_cache()
        phase_profile(torch, dev, "m10", dtype="bf16")
        torch.cuda.empty_cache()
        phase_profile_fleet(torch, dev)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--profile-pfb"]:
        # the PFB's bodies and their load-, store- and arithmetic-only
        # builds: python3 chip_smoke.py --profile-pfb
        phase_profile_pfb(torch, dev, smi)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--profile-k7"]:
        # K7's channel-filter bodies and their builds without a stage:
        # python3 chip_smoke.py --profile-k7
        phase_profile_k7(torch, dev, smi)
        print(smi, flush=True)
        return 0
    if sys.argv[1:2] == ["--profile-k1"]:
        # K1's compiled bodies and their builds without a stage:
        # python3 chip_smoke.py --profile-k1 [VARIANT ...]
        names = sys.argv[2:]
        phase_profile_k1(torch, dev, smi, [
            v for v in K1_PROFILE_VARIANTS if not names or v[0] in names])
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--plain-fir"]:
        # the plain filter and the plain-op RS41 steps it runs in:
        # python3 chip_smoke.py --plain-fir
        phase_resources(("lane_fir.cu",))
        phase_plain_fir(torch, dev)
        for dtype in ("f32", "bf16"):
            pipe, blocks, _ = phase_main_path(torch, dev, "rs41", 3, dtype)
            phase_step(torch, pipe, blocks, phase="plain_step", smi=smi)
            del pipe, blocks
            torch.cuda.empty_cache()
        phase_distinct(torch, dev, "rs41", "bf16")
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--tune"]:
        # outputs or frames per thread: python3 chip_smoke.py --tune
        phase_tune(torch, dev)
        print(smi, flush=True)
        return 0
    k1 = phase_frontend(torch, dev)
    kres = {"fused_frontend": k1["rs41"]}
    kres.update(phase_kernels(torch, dev))
    kres.update(phase_fleet_kernels(torch, dev))
    k8 = phase_afsk_kernels(torch, dev)
    kres["fused_afsk_frontend"] = k8["imet4"]
    plain_corr_res = phase_plain_correlation(torch, dev)
    plain_fir_res = phase_plain_fir(torch, dev)
    unpathed, unpathed_launches = phase_unpathed_kernels(torch, dev)
    kres.update(unpathed)
    # every path is driven with the counts at 0 just before it and read
    # just after; each kernel's launches come from the path that drives it
    runs = {}
    pipe, blocks, runs["rs41"] = phase_main_path(torch, dev)
    phase_distinct(torch, dev)
    main_step_ms = phase_step(torch, pipe, blocks, smi=smi)
    phase_session_workers(torch, dev, blocks)
    del pipe, blocks
    torch.cuda.empty_cache()
    runs["ddc_afc"] = phase_ddc_afc_path(torch, dev, main_step_ms, smi)
    torch.cuda.empty_cache()
    pipe, blocks, runs["rs41x"] = phase_main_path(torch, dev, "rs41x", 2)
    phase_distinct(torch, dev, "rs41x")
    del pipe, blocks
    torch.cuda.empty_cache()
    # the plain-op step (use_pallas=False, the JAX bench's default in bf16):
    # RS41 in bf16 and f32, rs41x and dfm in bf16; no hand kernel but the
    # plain correlation and the plain filter
    for dtype in ("bf16", "f32"):
        pipe, blocks, runs[f"plain_{dtype}"] = phase_main_path(
            torch, dev, "rs41", 3, dtype)
        phase_step(torch, pipe, blocks, phase="plain_step", smi=smi)
        del pipe, blocks
        torch.cuda.empty_cache()
    phase_distinct(torch, dev, "rs41", "bf16")
    runs["plain_rs41x_bf16"] = phase_main_path(torch, dev, "rs41x", 1,
                                               "bf16")[2]
    phase_distinct(torch, dev, "dfm", "bf16")
    torch.cuda.empty_cache()
    runs["pfb_stream"] = phase_pfb_stream(torch, dev)
    fleet, (wi, wq), runs["fleet"] = phase_fleet_path(torch, dev)
    phase_fleet_distinct(torch, dev)
    phase_fleet_step(torch, fleet, wi, wq, smi)
    del fleet, wi, wq
    torch.cuda.empty_cache()
    # the bf16 fleet (bench.py's fleet default): the PFB's bf16 bodies
    runs["pfb_stream_bf16"] = phase_pfb_stream(torch, dev, "bf16")
    fleet, (wi, wq), runs["fleet_bf16"] = phase_fleet_path(
        torch, dev, n_blocks=3, compute_dtype="bf16")
    phase_fleet_bf16_step(torch, fleet, wi, wq, smi)
    del fleet, wi, wq
    torch.cuda.empty_cache()
    phase_fleet_distinct(torch, dev, plan=FLEET_AFSK_PLAN,
                         compute_dtype="bf16")
    runs["fleet_offgrid"] = phase_fleet_offgrid(torch, dev)
    for family, n_blocks in (("imet4", 3), ("c50", 2)):
        pipe, blocks, runs[family] = phase_afsk_path(torch, dev, family,
                                                     n_blocks)
        phase_step(torch, pipe, blocks, phase="afsk_step")
        del pipe, blocks
        torch.cuda.empty_cache()
    phase_afsk_distinct(torch, dev)
    # the jnp AFSK front end (use_pallas=False, the JAX CLI's default)
    for family in AFSK_TONES:
        pipe, blocks, runs[f"plain_{family}"] = phase_afsk_path(
            torch, dev, family, 2, use_pallas=False)
        phase_step(torch, pipe, blocks, phase="plain_afsk_step", smi=smi)
        del pipe, blocks
        torch.cuda.empty_cache()
    phase_afsk_distinct(torch, dev, 2, use_pallas=False)
    runs["afc_m10"] = phase_afc_drift(torch, dev)
    torch.cuda.empty_cache()
    # the last two families: K7's channel-filter body with midpoint DC
    for family, n_blocks in (("ims100", 3), ("mrzn1", 2)):
        runs[family] = phase_dualtone_path(torch, dev, family, n_blocks, smi)
        torch.cuda.empty_cache()
    phase_dualtone_distinct(torch, dev)
    phase_plain_dualtone(torch, dev, smi)
    torch.cuda.empty_cache()
    # bf16 on the kernel routes: K7's chanfilt_t41_nb20 body, and K1 (with
    # K2 on the widened ring) on m10's FM fallback; then the original's kernel gates
    for family in ("ims100", "m10"):
        key = "m10_fallback_bf16" if family == "m10" else f"{family}_bf16"
        runs[key] = phase_bf16_path(torch, dev, family, smi)
        torch.cuda.empty_cache()
    phase_gates(torch, dev)
    torch.cuda.empty_cache()
    # the command line, as a user runs it: each run's launches are read
    # from that run alone (run_cli sets the counts to 0 just before it)
    new_runs = {}
    cli_runs = phase_cli_full_width(torch, dev, smi)
    torch.cuda.empty_cache()
    cli_runs["wideband"], new_runs["scan"] = phase_cli_wideband(
        torch, dev, smi)
    torch.cuda.empty_cache()
    for family, run in phase_cli_narrowband(torch, dev, smi).items():
        cli_runs[f"{family}_c8"] = run
    phase_cli_checkpoint(torch, dev, smi)
    for family, launches in phase_fer(torch, dev, smi).items():
        cli_runs[f"fer_{family}_c8"] = {"launches": launches}
    for name in ("fused_frontend", "corr", "rs_clean", "pfb_fir_stream",
                 "pfb_dft", "fused_dualtone_frontend", "fused_afsk_frontend"):
        check(any(r["launches"][name] for r in cli_runs.values()),
              f"kernel {name}: no launches from the command line's runs")
    torch.cuda.empty_cache()
    # the receiver's automation: the AutoFleet at full width, the 16-bin
    # decode --wideband --auto card against CPU, the unfused fleet step
    new_runs["autofleet"] = phase_autofleet(torch, dev, smi)
    for key, run in phase_autofleet_cpu(torch, dev, smi).items():
        new_runs[f"autofleet_cpu_{key}"] = run
    new_runs["fleet_unfused"] = phase_fleet_unfused(torch, dev, smi)
    for name in ("pfb_fir_stream", "pfb_dft"):
        check(new_runs["autofleet"]["launches"][name] > 0,
              f"kernel {name}: no launches on the AutoFleet path")
    torch.cuda.empty_cache()
    # the multi-device layer: each mesh path's launches from its own run
    mesh_runs = {"mesh_session": phase_mesh_session(torch, dev, smi)}
    torch.cuda.empty_cache()
    mesh_runs["mesh_fleet"], mesh_runs["mesh_fleet_kernel_routes"] = \
        phase_mesh_fleet(torch, dev, smi)
    torch.cuda.empty_cache()
    mesh_runs["mesh_processes"] = phase_mesh_processes(torch, smi)
    phase_time_parallel(torch, dev, smi)
    torch.cuda.empty_cache()
    phase_dryrun(torch, dev, smi)
    for name in ("fused_frontend", "corr", "rs_clean", "pfb_fir_stream",
                 "pfb_dft", "fused_dualtone_frontend"):
        check(any(r["launches"][name] for r in mesh_runs.values()),
              f"kernel {name}: no launches on the mesh paths")
    torch.cuda.empty_cache()
    # the public library API and the oracle harness (no hand kernel)
    phase_library(torch, dev, smi)
    phase_oracle(torch, dev, smi)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "sondetpu"))
    check(not loaded, f"the run imported jax or the JAX package: {loaded}")

    launches_from = {"fused_frontend": "imet4", "fused_afsk_frontend": "imet4",
                     "corr": "rs41", "rs_clean": "rs41",
                     "pfb_fir_stream": "fleet", "pfb_dft": "fleet",
                     "fused_dualtone_frontend": "fleet",
                     "pfb_fir_timemajor": "pfb_stream"}
    paths = ("rs41", "fleet", "imet4", "c50", "rs41x", "plain_bf16",
             "plain_f32", "plain_rs41x_bf16", "ddc_afc", "fleet_offgrid",
             "afc_m10", "ims100", "mrzn1", "fleet_bf16", "plain_imet4",
             "plain_c50", "ims100_bf16", "m10_fallback_bf16")
    table = []
    for name in KERNEL_SOURCES:
        if name in launches_from:
            frm = launches_from[name]
            n = runs[frm]["launches"][name]
        else:                    # K9 and K10: no pipeline path runs them
            frm, n = "kernels phase (no pipeline path)", unpathed_launches[name]
        check(n > 0, f"kernel {name}: no launches")
        row = {"name": name, "route": "cuda",
               "source": KERNEL_SOURCES[name][0],
               "replaces": KERNEL_SOURCES[name][1], "launches": n,
               "launches_from": frm, **subset(kres[name]),
               "launches_per_step": {
                   p: runs[p]["launches"][name] / runs[p]["steps"]
                   for p in paths},
               "cli_launches": {p: r["launches"][name]
                                for p, r in cli_runs.items()
                                if r["launches"][name]},
               "automation_launches": {p: r["launches"][name]
                                       for p, r in new_runs.items()},
               "mesh_launches": {p: r["launches"].get(name, 0)
                                 for p, r in mesh_runs.items()}}
        check(all(k in row for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")),
              f"kernel {name}: row lacks a number {row}")
        table.append(row)
    table[0].update(
        bodies_by_path={p: {k: v for k, v in runs[p]["bodies"].items()
                            if k.startswith("fused_frontend")}
                        for p in paths},
        decim1_identity=subset(k1["afsk"]),
        decim1_lowpass=subset(k1["decim1-lowpass"]))
    k8_row = next(e for e in table if e["name"] == "fused_afsk_frontend")
    k8_row["win20"] = subset(k8["c50"])
    k3_row = next(e for e in table if e["name"] == "rs_clean")
    k3_row.update(
        lop3=kres["rs_clean"]["lop3"],
        lop3_ms_at_integer_rate=kres["rs_clean"]["lop3_ms_at_integer_rate"],
        rs41x_518_bytes=subset(kres["rs_clean_rs41x"]),
        bodies_by_path={p: {k: v for k, v in runs[p]["bodies"].items()
                            if k.startswith("rs_clean")} for p in paths})
    k7_row = next(e for e in table if e["name"] == "fused_dualtone_frontend")
    k7_row["bodies_by_path"] = {
        p: {k: v for k, v in runs[p]["bodies"].items()
            if k.startswith("fused_dualtone_frontend")} for p in paths}
    k7_row["chanfilt_nb20"] = dict(
        subset(kres["fused_dualtone_frontend_chanfilt"]),
        body=kres["fused_dualtone_frontend_chanfilt"]["body"],
        launches_per_step={p: runs[p]["bodies"].get(
            "fused_dualtone_frontend:chanfilt_t41_nb20", 0) / runs[p]["steps"]
            for p in ("ims100", "mrzn1")})
    k7_row["chanfilt_runtime_nb19"] = subset(
        kres["fused_dualtone_frontend_ims100-nb19"])
    # K10's second entry, the plain correlation: its timings at m10's fleet
    # ring and its launches on every path that runs it
    k10_row = next(e for e in table if e["name"] == "lane_fir")
    k10_row["plain_corr"] = {
        "fleet_m10_ring": {k: dict(subset(e), body=e["body"])
                           for k, e in plain_corr_res.items()},
        "launches_per_step": {p: runs[p]["launches"]["plain_corr"]
                              / runs[p]["steps"] for p in paths},
        "cli_launches": {p: r["launches"]["plain_corr"]
                         for p, r in cli_runs.items()
                         if r["launches"]["plain_corr"]},
        "automation_launches": {p: r["launches"].get("plain_corr", 0)
                                for p, r in new_runs.items()},
        "mesh_launches": {p: r["launches"].get("plain_corr", 0)
                          for p, r in mesh_runs.items()}}
    # K10's third entry, the plain-op front end's filter: its timings at
    # the RS41 plain step's shapes and its launches on every path
    k10_row["plain_fir"] = {
        "rs41_plain_step": {k: dict(subset(e), body=e["body"])
                            for k, e in plain_fir_res.items()},
        "launches_per_step": {p: runs[p]["launches"]["plain_fir"]
                              / runs[p]["steps"] for p in paths},
        "cli_launches": {p: r["launches"]["plain_fir"]
                         for p, r in cli_runs.items()
                         if r["launches"]["plain_fir"]},
        "automation_launches": {p: r["launches"].get("plain_fir", 0)
                                for p, r in new_runs.items()},
        "mesh_launches": {p: r["launches"].get("plain_fir", 0)
                          for p, r in mesh_runs.items()}}
    k9_row = next(e for e in table if e["name"] == "fused_demod_fir")
    k9_row.update(subset(kres["fused_demod_fir"], keys=("audio_ms", "fir_ms")))
    k2_row = next(e for e in table if e["name"] == "corr")
    k2_row.update(
        body=kres["corr"]["body"],
        sign_body_ops=kres["corr"]["sign_body_ops"],
        rounded_body_ops=kres["corr"]["rounded_body_ops"],
        rounded_l64=subset(kres["corr_rounded_l64"]),
        bodies_by_path={p: {k: v for k, v in runs[p]["bodies"].items()
                            if k.split(":")[0] in (
                                "corr", "fused_dualtone_frontend")}
                        for p in paths})
    # the bf16 bodies, a row each: (kernel, its timed entry, the path
    # whose run gives its launches, the body)
    bf16_rows = (
        ("fused_frontend", k1["decim1-lowpass_bf16"], "m10_fallback_bf16",
         "fused_frontend:decim1_t41_bf16"),
        ("fused_dualtone_frontend", kres["fused_dualtone_frontend_bf16"],
         "fleet_bf16", "fused_dualtone_frontend:skip_nb5_bf16"),
        ("pfb_fir_stream", kres["pfb_fir_stream_bf16"], "fleet_bf16",
         "pfb_fir_stream:bf16"),
        ("pfb_fir_timemajor", kres["pfb_fir_timemajor_bf16"],
         "pfb_stream_bf16", "pfb_fir_timemajor:bf16"),
        ("pfb_dft", kres["pfb_dft_bf16"], "fleet_bf16",
         "pfb_dft:n2048_bf16"))
    for name, entry, frm, body in bf16_rows:
        n = runs[frm]["bodies"].get(body, 0)
        check(n > 0, f"kernel {name} bf16: no launches of {body} on {frm}")
        row = {"name": f"{name} (bf16)", "route": "cuda",
               "source": KERNEL_SOURCES[name][0],
               "replaces": KERNEL_SOURCES[name][1], "launches": n,
               "launches_from": frm, "body": body, **subset(entry),
               "launches_per_step": {
                   p: runs[p]["bodies"].get(body, 0) / runs[p]["steps"]
                   for p in paths if "bodies" in runs[p]}}
        check(all(k in row for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")),
              f"kernel {name} bf16: row lacks a number {row}")
        table.append(row)
    table[-5].update(decim2_rs41_shape=subset(k1["rs41_bf16"]),
                     decim1_identity=subset(k1["afsk_bf16"]))
    table[-4].update(chanfilt_nb20=dict(
        subset(kres["fused_dualtone_frontend_chanfilt_bf16"]),
        body=kres["fused_dualtone_frontend_chanfilt_bf16"]["body"],
        launches_per_step={"ims100_bf16": runs["ims100_bf16"]["bodies"].get(
            "fused_dualtone_frontend:chanfilt_t41_nb20_bf16", 0)
            / runs["ims100_bf16"]["steps"]}),
        chanfilt_runtime_nb19=subset(
            kres["fused_dualtone_frontend_ims100-nb19_bf16"]))
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
