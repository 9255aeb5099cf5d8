"""sondetpu-torch command line: decode, synth, fer, types (counterpart:
``sondetpu/cli/main.py``).

The original's command line on the port: ``decode`` runs the streaming
pipeline over an IQ file or stream with GPX/PTU/JSONL sinks (one channel,
``--channels N`` copies of it, ``--sonde auto``, ``--rate`` through the
resampler, ``--stream`` through the native reader, cs16/cs8 device
dequant, AFC, host workers, watchdog, status and table, checkpoint and
resume, and ``--wideband`` fleets from a config's ``channel_map``);
``synth`` generates golden IQ from any registered modulator; ``fer`` runs
the FER-vs-SNR sweep. ``decode`` and ``fer`` run on the card unless
``--device cpu`` asks for the CPU; without a card they stop and say so.
``--trace`` writes a ``torch.profiler`` Chrome trace. Not here: ``scan``,
``decode --auto`` and ``bench``.

``decode`` prints, on stderr before the metrics line, the host seconds it
spent reading the input (``read``, the source's set-up included), tiling
one channel to ``--channels`` rows (``tile``), in ``process_block``
(``process``) and, within that, in the sinks (``sinks``), beside the
loop's wall time (``wall``).

Usage examples:
  python -m sondetpu_torch.cli.main types
  python -m sondetpu_torch.cli.main synth --sonde rs41 --frames 6 --out /tmp/x.cf32
  python -m sondetpu_torch.cli.main decode --iq /tmp/x.cf32 --sonde rs41 \\
      --gpx /tmp/track.gpx --ptu /tmp/ptu.csv --jsonl -
  python -m sondetpu_torch.cli.main fer --sonde rs41 --snrs 5,8,10,15
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _device(args):
    """The torch device of ``--device``, or None (after saying why) when it
    names a CUDA device and there is none."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device "
              "(torch.cuda.is_available() is false); pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return None
    return dev


def cmd_types(args) -> int:
    from sondetpu_torch.sondes import SUPPORTED_TYPES, get_sonde

    for name in SUPPORTED_TYPES:
        spec = get_sonde(name)["spec"]
        print(f"{name:8s} {spec.display_name:14s} bw={spec.bandwidth/1e3:.0f}kHz "
              f"baud={spec.baud:.0f} mod={spec.modulation} "
              f"frame={spec.frame_bytes}B")
    return 0


def cmd_synth(args) -> int:
    from sondetpu_torch.io import write_iq
    from sondetpu_torch.sondes import get_sonde
    from sondetpu_torch.sondes.modulate import add_awgn

    modcls = get_sonde(args.sonde)["modulator"]
    mod = modcls()
    truth_cls = _truth_class(args.sonde)
    truths = [truth_cls() for _ in range(args.frames)]
    for i, t in enumerate(truths):
        if hasattr(t, "frame_no"):
            t.frame_no = args.first_frame + i
    iq = mod.modulate(truths, fs=args.fs)
    if args.snr is not None:
        iq = add_awgn(iq, args.snr)
    write_iq(args.out, iq, args.format)
    print(f"wrote {iq.size} samples ({iq.size/args.fs:.2f}s) to {args.out}")
    return 0


def _truth_class(sonde: str):
    from sondetpu_torch.sondes import get_sonde

    # the Truth class lives in the module that registered the modulator
    # (sonde names and module names differ for variants like rs41x)
    modcls = get_sonde(sonde)["modulator"]
    mod = sys.modules[modcls.__module__]
    name = modcls.__name__.replace("Modulator", "Truth")
    cand = getattr(mod, name, None)
    if cand is None:
        # variant modulators (RS41XModulator) share the base family's
        # truth class (RS41Truth): longest Truth-class prefix of the name
        best = ""
        for a in dir(mod):
            if a.endswith("Truth") and name.startswith(a[:-5]) \
                    and len(a) > len(best):
                best = a
        cand = getattr(mod, best) if best else None
    if cand is None:
        raise KeyError(f"no Truth class for {modcls.__name__}")
    return cand


def _make_sinks(args, default_type="", multi=False):
    from sondetpu_torch.io import (GPXWriter, JSONLWriter, MultiGPXWriter,
                                   PTUWriter)

    # mixed fleets write one <trk> per sonde with per-serial dedup
    # (a single-track writer would thrash and cross-drop points)
    gpx = ((MultiGPXWriter(args.gpx) if multi else GPXWriter(args.gpx))
           if args.gpx else None)
    ptu = PTUWriter(args.ptu) if args.ptu else None
    jsonl = JSONLWriter(args.jsonl) if args.jsonl else None

    def on_update(ch, telem, sonde_type=default_type):
        if gpx:
            if multi:
                gpx.add_track_point(telem.serial, telem.time, telem.lat,
                                    telem.lon, telem.alt, telem.spd,
                                    telem.hdg)
            else:
                if telem.serial:
                    gpx.start_track(telem.serial)  # per-serial tracks (gpx.cpp:39)
                gpx.add_track_point(telem.time, telem.lat, telem.lon,
                                    telem.alt, telem.spd, telem.hdg)
        if ptu:
            ptu.add_point(telem)
        if jsonl:
            jsonl.add_point(telem, channel=ch, sonde_type=sonde_type)

    return on_update, (gpx, ptu, jsonl)


def _timed(it, timing: dict, key: str):
    """Iterate ``it``, adding the host seconds of each step to
    ``timing[key]``."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            timing[key] += time.perf_counter() - t0
            return
        timing[key] += time.perf_counter() - t0
        yield item


def _tile(x, channels: int):
    """One channel's plane [n] -> [channels, n]: np.tile on the host for
    host planes, a broadcast view for device planes (the resampler's)."""
    if isinstance(x, torch.Tensor):
        return x[None, :].expand(channels, -1)
    if channels > 1:
        return np.tile(x[None, :], (channels, 1))
    return x[None, :]


def _start_trace(args, dev):
    if not args.trace:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    print(f"profiler trace -> {args.trace}", file=sys.stderr)
    return prof


def _stop_trace(args, prof) -> None:
    if prof is None:
        return
    prof.stop()
    os.makedirs(args.trace, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.trace, "trace.json"))


def cmd_decode(args) -> int:
    from sondetpu_torch.cli.config import FrameworkConfig
    from sondetpu_torch.io.iq import IQFileSource
    from sondetpu_torch.runtime.pipeline import PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession
    from sondetpu_torch.runtime import checkpoint as ckpt

    dev = _device(args)
    if dev is None:
        return 2
    cfg = FrameworkConfig.load(args.config) if args.config else FrameworkConfig()
    if args.sonde:
        cfg.sonde = args.sonde
    if args.channels:
        cfg.channels = args.channels
    if args.wideband or cfg.wideband or cfg.channel_map:
        return _decode_wideband(args, cfg, dev)
    if cfg.sonde == "auto":
        # the reference's type combobox (main.cpp:136-151), automated:
        # probe the first blocks of the channel with every family's
        # decoder, keep the one whose frames actually parse
        if args.stream:
            print("--sonde auto needs a seekable file (not --stream)",
                  file=sys.stderr)
            return 2
        from sondetpu_torch.io.iq import iq_from_file

        if args.rate and abs(args.rate - cfg.fs) > 1e-9:
            # probe at the capture rate, resample to the channel grid so
            # the per-family probes see 48 kHz samples
            from sondetpu_torch.dsp.resample import StreamingResampler
            raw = iq_from_file(args.iq, args.format,
                               count=int(3 * cfg.block_len
                                         * args.rate / cfg.fs))
            rs = StreamingResampler(args.rate, cfg.fs, channels=2)
            planes = rs.process(np.stack([raw.real.astype(np.float32),
                                          raw.imag.astype(np.float32)]))
            probe = (planes[0] + 1j * planes[1]).astype(np.complex64)
        else:
            probe = iq_from_file(args.iq, args.format,
                                 count=3 * cfg.block_len)
        best = _autodetect_sonde(probe, cfg, dev)
        if best is None:
            print("no family decodes this signal", file=sys.stderr)
            return 1
        print(f"[auto] detected {best}", file=sys.stderr)
        cfg.sonde = best

    on_update, sinks = _make_sinks(args, cfg.sonde)
    timing = {"read": 0.0, "tile": 0.0, "process": 0.0, "sinks": 0.0,
              "wall": 0.0}

    def timed_update(ch, telem):
        t0 = time.perf_counter()
        on_update(ch, telem)
        timing["sinks"] += time.perf_counter() - t0

    # device-dequant ingest: raw integer planes for cs16/cs8 sources
    from sondetpu_torch.io.iq import infer_format
    fmt = infer_format(args.iq, args.format)
    int_ingest = cfg.device_dequant and fmt in ("cs16", "cs8")
    # arbitrary capture rate: a device-side rational resampler converts to
    # the 48 kHz channel grid in-chain (reference main.cpp:60); integer
    # wire formats dequantize inside the resampler, so the pipeline then
    # always sees f32 planes
    resamp = None
    if args.rate and abs(args.rate - cfg.fs) > 1e-9:
        from sondetpu_torch.dsp.resample import DeviceStreamingResampler
        resamp = DeviceStreamingResampler(
            args.rate, cfg.fs, cfg.block_len, dev,
            input_dtype={"cs16": "i16", "cs8": "i8"}[fmt]
            if int_ingest else "f32")
        print(f"[rate] {args.rate:.0f} Hz -> {cfg.fs:.0f} Hz "
              f"({resamp.up}/{resamp.down}), reading "
              f"{resamp.in_len}-sample blocks", file=sys.stderr)
    pcfg = PipelineConfig(sonde=cfg.sonde, channels=cfg.channels, fs=cfg.fs,
                          block_len=cfg.block_len,
                          sync_threshold=cfg.sync_threshold,
                          use_pallas=cfg.use_pallas,
                          compute_dtype=cfg.compute_dtype,
                          afc=args.afc or cfg.afc,
                          input_dtype={"cs16": "i16", "cs8": "i8"}[fmt]
                          if (int_ingest and resamp is None) else "f32")
    sess = DecoderSession(pcfg, dev, on_update=timed_update,
                          host_workers=args.host_workers)
    # offline replay date base for date-less protocols (iMet-4 sends only
    # hh:mm:ss): --ref-epoch wins; a regular file's mtime is the default,
    # so replaying a recorded capture stamps the capture day, not today.
    # Live sources (FIFOs, character devices) keep the wall clock.
    if hasattr(sess.decoder, "ref_epoch"):
        if getattr(args, "ref_epoch", None) is not None:
            sess.decoder.ref_epoch = float(args.ref_epoch)
        elif not args.stream and os.path.isfile(args.iq):
            sess.decoder.ref_epoch = os.path.getmtime(args.iq)
    prof = _start_trace(args, dev)
    try:
        if args.resume:
            ckpt.load_session(sess, args.resume)
            print(f"resumed from {args.resume} at block {sess.blocks_seen}",
                  file=sys.stderr)

        t_loop = time.perf_counter()
        read_len = resamp.in_len if resamp is not None else cfg.block_len
        if args.stream:
            # O(block)-memory path: the native reader thread prefetches and
            # converts the next block while this one is on the device (works
            # on FIFOs/pipes too, so a live SDR can feed the decoder). With
            # device_dequant + cs16/cs8 the planes stay raw integers.
            from sondetpu_torch.io.iq import StreamingIQSource
            src_iter = ((pi, pq) for pi, pq, _ in StreamingIQSource(
                args.iq, block_len=read_len, fmt=args.format,
                raw_planes=int_ingest).blocks())
        elif int_ingest:
            from sondetpu_torch.io.iq import IntIQFileSource
            src = IntIQFileSource(args.iq, block_len=read_len, fmt=fmt)
            src_iter = ((pi, pq) for pi, pq, _ in src.blocks())
        else:
            from sondetpu_torch.io.iq import c64_to_planes
            src = IQFileSource(args.iq, block_len=read_len,
                               fmt=args.format)
            # c64_to_planes uses the native deinterleaver when built — this
            # loop is the per-block host hot path
            src_iter = (c64_to_planes(b) for b, _ in src.blocks())
        timing["read"] += time.perf_counter() - t_loop
        src_iter = _timed(src_iter, timing, "read")
        if resamp is not None:
            def _resampled(it, rs):
                st = rs.init_state()
                for pi, pq in it:
                    st, yi, yq = rs(st, pi, pq)
                    yield yi, yq       # device tensors, already 48 kHz

            src_iter = _resampled(src_iter, resamp)
        for pi, pq in src_iter:
            t0 = time.perf_counter()
            pi, pq = _tile(pi, cfg.channels), _tile(pq, cfg.channels)
            t1 = time.perf_counter()
            sess.process_block((pi, pq))
            timing["tile"] += t1 - t0
            timing["process"] += time.perf_counter() - t1
            if args.status and sess.blocks_seen % args.status == 0:
                print(sess.metrics.status_line(), file=sys.stderr)
            if args.table and sess.blocks_seen % args.table == 0:
                from sondetpu_torch.io.table import CLEAR, render_table
                rows = {ch: (cfg.sonde, t) for ch, t in sess.telemetry.items()}
                rms = sess.metrics.last_rms
                qual = ({ch: float(rms[ch]) for ch in rows}
                        if rms is not None else None)
                freqs = sess.afc_freqs
                afc = ({ch: float(freqs[ch]) for ch in rows}
                       if freqs is not None else None)
                print(CLEAR + render_table(
                    rows, title=sess.metrics.status_line(), quality=qual,
                    afc_hz=afc), file=sys.stderr)
            if args.watchdog:
                sess.watchdog(args.watchdog)
        timing["wall"] = time.perf_counter() - t_loop
    except KeyboardInterrupt:
        # Ctrl-C is how a --stream FIFO run normally ends: fall through to
        # the checkpoint save and sink teardown below
        print("interrupted — finalizing", file=sys.stderr)
    finally:
        # flush the trace regardless of how the run ended (incl. setup
        # failures like a resume mismatch or a missing IQ file)
        _stop_trace(args, prof)
        sess.close()
    if args.checkpoint:
        ckpt.save_session(sess, args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    for w in sinks:
        if w:
            w.deinit()
    print(json.dumps({"cli_seconds": timing}), file=sys.stderr)
    print(sess.metrics.json_line(), file=sys.stderr)
    return 0


def _autodetect_sonde(iq: np.ndarray, cfg, device, families=None):
    """Probe a single channel's IQ with every registered family; return the
    family with the most parsed telemetry updates (None if all score 0)."""
    from sondetpu_torch.runtime.pipeline import PipelineConfig
    from sondetpu_torch.runtime.session import DecoderSession
    from sondetpu_torch.sondes import SUPPORTED_TYPES

    scores = {}
    for fam in families or SUPPORTED_TYPES:
        pcfg = PipelineConfig(sonde=fam, channels=1, fs=cfg.fs,
                              block_len=cfg.block_len,
                              sync_threshold=cfg.sync_threshold)
        sess = DecoderSession(pcfg, device)
        n = 0
        for b in range(iq.size // cfg.block_len):
            blk = iq[b * cfg.block_len:(b + 1) * cfg.block_len]
            n += len(sess.process_block(blk[None, :]))
        scores[fam] = n
    best = max(scores, key=scores.get)
    return best if scores[best] > 0 else None


def _wideband_blocks(args, w: int, fs_wide: float, device):
    """Wideband block iterator: plane pairs (or complex blocks) of w
    samples at fs_wide. With --rate != fs_wide, the capture is read at its
    native rate and rationally resampled on the device to the PFB grid
    (reference main.cpp:60): any SDR rate feeds the fleet."""
    from sondetpu_torch.io.iq import (IQFileSource, StreamingIQSource,
                                      c64_to_planes)

    resamp = None
    if args.rate and abs(args.rate - fs_wide) > 1e-9:
        from sondetpu_torch.dsp.resample import DeviceStreamingResampler
        resamp = DeviceStreamingResampler(args.rate, fs_wide, w, device)
        print(f"[rate] {args.rate:.0f} Hz -> {fs_wide:.0f} Hz "
              f"({resamp.up}/{resamp.down}), reading "
              f"{resamp.in_len}-sample blocks", file=sys.stderr)
    read_len = resamp.in_len if resamp is not None else w
    if args.stream:
        # plane pairs go straight through (no complex materialization on
        # the wideband hot path; FleetSession splits planes itself)
        base = ((pi, pq) for pi, pq, _ in
                StreamingIQSource(args.iq, block_len=read_len,
                                  fmt=args.format).blocks())
    elif resamp is not None:
        base = (c64_to_planes(b) for b, _ in
                IQFileSource(args.iq, block_len=read_len,
                             fmt=args.format).blocks())
    else:
        return (b for b, _ in
                IQFileSource(args.iq, block_len=read_len,
                             fmt=args.format).blocks())
    if resamp is None:
        return base

    def _resampled():
        st = resamp.init_state()
        for pi, pq in base:
            st, yi, yq = resamp(st, pi, pq)
            yield (yi, yq)

    return _resampled()


def _decode_wideband(args, cfg, device) -> int:
    """Wideband input: PFB channelize per the config's channel_map, decode a
    mixed fleet (BASELINE.json:11). Channel map entries give each sonde's
    center frequency within the wideband span; bins snap to fs_chan and the
    residual goes to the per-channel fine-offset DDC."""
    from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession

    # explicit CLI flag wins over the config (repo-wide convention);
    # scan-emitted configs carry wide_bins so neither is usually needed
    n_bins = args.bins or cfg.wide_bins or 8
    fs_chan = cfg.fs
    fs_wide = n_bins * fs_chan
    if not cfg.channel_map:
        print("wideband decode needs --config with channel_map entries",
              file=sys.stderr)
        return 2
    from sondetpu_torch.dsp.channelizer import bin_and_offset
    chans = []
    for entry in cfg.channel_map:
        k, resid = bin_and_offset(entry.center_freq, fs_chan, n_bins)
        chans.append(FleetChannel(pfb_bin=k, sonde=entry.sonde, offset_hz=resid))

    on_update, sinks = _make_sinks(args, multi=True)
    latest = {}

    def fleet_update(ch, sonde, t):
        latest[ch] = (sonde, t)
        on_update(ch, t, sonde)

    fleet = FleetSession(
        chans, n_bins, device, fs_chan=fs_chan, block_len=cfg.block_len,
        sync_threshold=cfg.sync_threshold, use_pallas=cfg.use_pallas,
        compute_dtype=cfg.compute_dtype,
        afc=args.afc or cfg.afc, on_update=fleet_update)
    if args.resume:
        from sondetpu_torch.runtime import checkpoint as ckpt
        ckpt.load_fleet(fleet, args.resume)
        print(f"fleet resumed from {args.resume}", file=sys.stderr)
    w = n_bins * cfg.block_len
    blk_iter = _wideband_blocks(args, w, fs_wide, device)
    blocks = 0
    updates = 0
    try:
        for block in blk_iter:
            updates += fleet.process_wideband(block)
            blocks += 1
            if args.status and blocks % args.status == 0:
                print(f"[wideband] blocks={blocks} updates={updates}",
                      file=sys.stderr)
            if args.table and blocks % args.table == 0:
                from sondetpu_torch.io.table import CLEAR, render_table
                print(CLEAR + render_table(
                    latest, title=f"[wideband] blocks={blocks} updates={updates}"),
                    file=sys.stderr)
    except KeyboardInterrupt:
        # Ctrl-C is how a --stream FIFO run normally ends: still save the
        # checkpoint and deinit the sinks (GPX needs its closing tags)
        print("interrupted — finalizing", file=sys.stderr)
    if args.checkpoint:
        from sondetpu_torch.runtime import checkpoint as ckpt
        ckpt.save_fleet(fleet, args.checkpoint)
        print(f"fleet checkpoint -> {args.checkpoint}", file=sys.stderr)
    for s in sinks:
        if s:
            s.deinit()
    print(f'{{"wideband_blocks": {blocks}, "updates": {updates}}}', file=sys.stderr)
    return 0


def cmd_fer(args) -> int:
    from sondetpu_torch.bench.fer import fer_sweep

    dev = _device(args)
    if dev is None:
        return 2
    snrs = [float(s) for s in args.snrs.split(",")]
    if args.sonde == "all":
        from sondetpu_torch.sondes import SUPPORTED_TYPES
        out = {}
        for name in SUPPORTED_TYPES:
            out[name] = fer_sweep(name, snrs, n_frames=args.frames,
                                  seed=args.seed, device=dev)
            print(f"{name}: {out[name]}", file=sys.stderr)
        print(json.dumps(out))
        return 0
    result = fer_sweep(args.sonde, snrs, n_frames=args.frames, seed=args.seed,
                       device=dev)
    print(json.dumps(result))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sondetpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("types", help="list supported sonde types").set_defaults(fn=cmd_types)

    ps = sub.add_parser("synth", help="synthesize golden IQ")
    ps.add_argument("--sonde", default="rs41")
    ps.add_argument("--frames", type=int, default=6)
    ps.add_argument("--first-frame", type=int, default=100)
    ps.add_argument("--fs", type=float, default=48000.0)
    ps.add_argument("--snr", type=float, default=None)
    ps.add_argument("--format", default="cf32", choices=["cf32", "cs16", "cs8"])
    ps.add_argument("--out", required=True)
    ps.set_defaults(fn=cmd_synth)

    pd = sub.add_parser("decode", help="decode an IQ file")
    pd.add_argument("--iq", required=True)
    pd.add_argument("--format", default=None)
    pd.add_argument("--sonde", default=None,
                    help='family name, or "auto" to detect by probing the '
                         "first blocks with every family")
    pd.add_argument("--channels", type=int, default=None)
    pd.add_argument("--config", default=None)
    pd.add_argument("--device", default="cuda",
                    help='torch device to decode on (default "cuda"; '
                         '"cpu" runs the kernels\' plain versions)')
    pd.add_argument("--gpx", default=None)
    pd.add_argument("--ptu", default=None)
    pd.add_argument("--jsonl", default=None)
    pd.add_argument("--status", type=int, default=0,
                    help="print a status line every N blocks")
    pd.add_argument("--table", type=int, default=0,
                    help="redraw a live per-channel telemetry table every "
                         "N blocks (the reference GUI's table, headless)")
    pd.add_argument("--watchdog", type=int, default=0,
                    help="reset channels idle for N blocks")
    pd.add_argument("--host-workers", type=int, default=0,
                    help="thread-pool size for host FEC/parse (channel-"
                         "aligned shards; 0 = single thread)")
    pd.add_argument("--trace", default=None,
                    help="write a torch.profiler Chrome trace (trace.json) "
                         "into this directory")
    pd.add_argument("--afc", action="store_true",
                    help="track per-channel carrier drift (automatic "
                         "frequency control; GFSK/FSK families)")
    pd.add_argument("--rate", type=float, default=None,
                    help="capture sample rate, Hz. Any rate works: the "
                         "stream is rationally resampled on the device to "
                         "the 48 kHz channel grid (single-channel) or the "
                         "bins*48 kHz PFB grid (--wideband), the in-chain "
                         "equivalent of SDR++'s RationalResampler "
                         "(reference main.cpp:60)")
    pd.add_argument("--checkpoint", default=None, help="save state on exit")
    pd.add_argument("--resume", default=None,
                    help="restore state first (a checkpoint of this package "
                         "or of the JAX package)")
    pd.add_argument("--ref-epoch", type=float, default=None,
                    help="capture-time epoch seconds for date-less "
                         "protocols (iMet-4); default: IQ file mtime")
    pd.add_argument("--stream", action="store_true",
                    help="stream the file/FIFO with the native prefetching "
                         "reader (O(block) memory) instead of loading it")
    pd.add_argument("--wideband", action="store_true",
                    help="input is wideband; channelize per config channel_map")
    pd.add_argument("--bins", type=int, default=None,
                    help="PFB channel count for --wideband (default: the "
                         "config's wide_bins, else 8)")
    pd.set_defaults(fn=cmd_decode)

    pf = sub.add_parser("fer", help="frame-error-rate vs SNR sweep")
    pf.add_argument("--sonde", default="rs41",
                    help='family name, or "all" to sweep every registered '
                         'family')
    pf.add_argument("--snrs", default="0,2,4,6,8,10,12,15,20")
    pf.add_argument("--frames", type=int, default=20)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--device", default="cuda",
                    help='torch device to decode on (default "cuda")')
    pf.set_defaults(fn=cmd_fer)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
