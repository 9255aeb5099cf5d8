"""Bit-exactness oracle harness (counterpart: ``tools/oracle_crosscheck.py``).

The acceptance criterion is framed output that matches the upstream
decoder bit for bit (BASELINE.json:5). This makes the check one command
for the port, the day an upstream sondedump checkout or a recorded capture
exists:

  python -m sondetpu_torch.bench.oracle                     # readiness report
  python -m sondetpu_torch.bench.oracle --selftest          # synthetic diff path
  python -m sondetpu_torch.bench.oracle --sondedump PATH    # build + cross-decode
  python -m sondetpu_torch.bench.oracle --iq rs41=cap.cf32 --iq m10=cap2.cf32:96000

Modes, flags, report layout and exit code are the original's:

- no inputs: per-family status: which families are READY for an oracle
  run (real public layouts, PROTOCOLS.md) and which are BLOCKED
  (framework-defined layouts that a real capture would falsify first).
- --selftest: modulate -> decode (the port's DecoderSession) -> diff
  framed bytes byte for byte against the modulator's frame images and
  parsed telemetry against truth.
- --sondedump PATH: configure and build an upstream sondedump checkout
  (cmake), feed it the same synthetic (or --iq) captures as FM-demodulated
  WAV audio, and report its output beside this decode.
- --iq FAMILY=FILE[:RATE]: decode a recorded complex64 capture (RATE
  defaults to 48000; any other rate is resampled to 48 kHz first).

``--device`` (default ``cuda``) picks where the decode runs; without a
CUDA device ``--device cuda`` exits 2 and says so (``--device cpu`` runs
the kernels' plain twins). Output: a table and a JSON report (--out,
default ORACLE.json); exit 1 when any family's ``ok`` is false.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# family -> (module, Modulator, Truth, layout status, blocking reason)
FAMILIES = {
    "rs41": ("sondetpu_torch.sondes.rs41", "RS41Modulator", "RS41Truth",
             "public", None),
    "dfm": ("sondetpu_torch.sondes.dfm", "DFMModulator", "DFMTruth",
            "public", None),
    "m10": ("sondetpu_torch.sondes.m10", "M10Modulator", "M10Truth",
            "public", None),
    "ims100": ("sondetpu_torch.sondes.ims100", "IMS100Modulator",
               "IMS100Truth", "public-partial",
               "word positions reconstructed; PTU calibration not public"),
    "imet4": ("sondetpu_torch.sondes.imet4", "IMET4Modulator", "IMET4Truth",
              "public", None),
    "c50": ("sondetpu_torch.sondes.c50", "C50Modulator", "C50Truth",
            "framework",
            "telegram byte constants framework-defined (PROTOCOLS.md); a "
            "real C50 capture would falsify them — top oracle priority"),
    "mrzn1": ("sondetpu_torch.sondes.mrzn1", "MRZN1Modulator", "MRZN1Truth",
              "framework",
              "frame layout wholly framework-defined (PROTOCOLS.md); a "
              "real MRZ capture would falsify it — top oracle priority"),
}

# truth fields the parsed-telemetry diff checks, with tolerances
FIELD_TOL = {"lat": 1e-4, "lon": 1e-4, "alt": 2.0}

BLOCK = 48000


def _truths(truth_cls, n=8):
    return [truth_cls(frame_no=10 + i) for i in range(n)]


def _modulate(fam, m, mod, truths, fs=48000.0):
    if fam == "dfm":
        from sondetpu_torch.sondes.modulate import gfsk_modulate
        chips = mod.frames_to_chips(np.stack(
            [mod.build_frame(t, k % 8) for k, t in enumerate(truths)]))
        spec = m.SPEC
        return gfsk_modulate(chips, fs / spec.baud, spec.dev / fs, bt=0.5)
    return mod.modulate(truths, fs=fs)


def _expected_frames(fam, m, mod, truths):
    """The modulator's descrambled on-air frame images (the byte level the
    pipeline's BlockOutput.frames reports)."""
    if fam == "dfm":
        return [np.asarray(mod.build_frame(t, k % 8), np.uint8)
                for k, t in enumerate(truths)]
    if fam == "ims100":
        return [np.asarray(mod.build_frame(t, 0), np.uint8) for t in truths]
    if fam == "imet4":
        return None    # packetized (PTU/GPS sub-packets); telemetry diff only
    if fam == "c50":
        # build_frame returns a telegram GROUP; the decode unit is one
        # 9-byte telegram
        out = []
        for t in truths:
            g = np.asarray(mod.build_frame(t), np.uint8)
            out += [g[i:i + 9] for i in range(0, g.size, 9)]
        return out
    try:
        return [np.asarray(mod.build_frame(t), np.uint8) for t in truths]
    except TypeError:
        return None


def _decode(fam, iq, fs=48000.0, snr_db=None, seed=0, device="cuda"):
    """Decode complex IQ with the port on ``device``; returns (frames,
    session)."""
    from sondetpu_torch.runtime.pipeline import (PipelineConfig,
                                                 unpack_block_output)
    from sondetpu_torch.runtime.session import DecoderSession

    if snr_db is not None:
        rng = np.random.default_rng(seed)
        a = 10 ** (-snr_db / 20.0) / np.sqrt(2)
        iq = iq + a * (rng.normal(size=iq.size)
                       + 1j * rng.normal(size=iq.size)).astype(np.complex64)
    if abs(fs - 48000.0) > 1e-9:
        from sondetpu_torch.dsp.resample import StreamingResampler
        rs = StreamingResampler(fs, 48000.0, channels=2)
        pl = rs.process(np.stack([iq.real.astype(np.float32),
                                  iq.imag.astype(np.float32)]))
        iq = (pl[0] + 1j * pl[1]).astype(np.complex64)
    cfg = PipelineConfig(sonde=fam, channels=1, block_len=BLOCK)
    sess = DecoderSession(cfg, device)
    frames = []
    # pad with one extra silent block so the final frame (whose end may
    # fall at the stream edge) is still gatherable
    iq = np.pad(iq, (0, (-iq.size) % BLOCK + BLOCK))
    n = (iq.size // BLOCK) * BLOCK
    pipe = sess.pipeline
    st = pipe.init_state()
    for b in range(n // BLOCK):
        blk = iq[b * BLOCK:(b + 1) * BLOCK][None, :]
        st, out = pipe.step(st, blk)
        res = unpack_block_output(out.packed.cpu().numpy(), cfg.k_slots,
                                  cfg.wire_ncols, cfg.chase_total)
        valid = res[1]
        if cfg.wire_columns is None:
            for ci, ki in zip(*np.nonzero(valid)):
                frames.append(np.asarray(res[0][ci, ki], np.uint8))
        else:
            for ci, ki in zip(*np.nonzero(valid)):
                frames.append(np.asarray(
                    pipe.fetch_frames(out.frames, [ci], [ki])[0], np.uint8))
        sess.state = st
        # host parse for the telemetry diff
        sess.blocks_seen += 1
        sess._handle_output(out)
    return frames, sess


def _diff_frames(expected, got):
    """Byte-diff decoded frames against expected images (order-tolerant:
    each expected frame is matched to its closest decode)."""
    diffs = []
    matched = 0
    for e in expected:
        best = None
        for g in got:
            if g.size != e.size:
                continue
            d = int(np.count_nonzero(g != e))
            if best is None or d < best[0]:
                best = (d, g)
        if best is None:
            diffs.append({"expected_len": int(e.size),
                          "error": "no decode of this length"})
        elif best[0] == 0:
            matched += 1
        else:
            bad = np.nonzero(best[1] != e)[0][:8]
            diffs.append({"mismatched_bytes": best[0],
                          "first_offsets": [int(x) for x in bad]})
    return matched, diffs


def _diff_telemetry(sess, truths):
    """Field-by-field parsed-telemetry diff vs modulated truth."""
    t = sess.telemetry.get(0)
    if t is None:
        return {"error": "no telemetry parsed"}
    out = {}
    ref = truths[-1]
    for f, tol in FIELD_TOL.items():
        want = getattr(ref, f, None)
        gotv = getattr(t, f, None)
        if want is None or gotv is None:
            continue
        ok = abs(float(gotv) - float(want)) <= tol
        out[f] = {"want": float(want), "got": float(gotv), "ok": bool(ok)}
    if getattr(ref, "serial", None) and getattr(t, "serial", ""):
        out["serial"] = {"want": ref.serial, "got": t.serial,
                         "ok": t.serial == ref.serial}
    return out


def selftest_entry(fam, device="cuda") -> dict:
    """One family's self-test: modulate, decode at 30 dB, diff."""
    modpath, mcls, tcls, status, _ = FAMILIES[fam]
    m = importlib.import_module(modpath)
    mod = getattr(m, mcls)()
    truths = _truths(getattr(m, tcls))
    iq = _modulate(fam, m, mod, truths)
    frames, sess = _decode(fam, iq, snr_db=30.0, device=device)
    expected = _expected_frames(fam, m, mod, truths)
    entry = {"status": status, "mode": "selftest",
             "frames_decoded": len(frames)}
    if expected is not None:
        matched, diffs = _diff_frames(expected, frames)
        entry["frames_bit_exact"] = matched
        entry["frames_expected"] = len(expected)
        entry["frame_diffs"] = diffs[:4]
        entry["ok"] = (not diffs) and matched > 0
    else:
        entry["ok"] = None
    entry["telemetry_diff"] = _diff_telemetry(sess, truths)
    tel_ok = all(v.get("ok", True)
                 for v in entry["telemetry_diff"].values()
                 if isinstance(v, dict))
    entry["ok"] = tel_ok if entry["ok"] is None else (entry["ok"] and tel_ok)
    print(f"{fam:8s} selftest: frames={len(frames)} "
          f"bit_exact={entry.get('frames_bit_exact', '-')}"
          f"/{entry.get('frames_expected', '-')} "
          f"ok={entry['ok']}")
    return entry


def selftest(report, device="cuda"):
    for fam in FAMILIES:
        report[fam] = selftest_entry(fam, device)


def build_sondedump(path):
    """Configure + build an upstream sondedump checkout; returns the
    binary path or raises."""
    bdir = os.path.join(path, "build-oracle")
    os.makedirs(bdir, exist_ok=True)
    subprocess.run(["cmake", "-DCMAKE_BUILD_TYPE=Release", ".."],
                   cwd=bdir, check=True, capture_output=True)
    subprocess.run(["cmake", "--build", ".", "-j"], cwd=bdir, check=True,
                   capture_output=True)
    for cand in ("sondedump", "sondedump.exe"):
        p = os.path.join(bdir, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no sondedump binary under {bdir}")


def _write_fm_wav(iq, path, fs=48000.0, dev=None):
    """FM-demodulate IQ to the audio WAV sondedump consumes (the reference
    plugin feeds demodulated audio into the decode lib, decoder.hpp:22)."""
    import wave
    x = iq.astype(np.complex64)
    d = x[1:] * np.conj(x[:-1])
    audio = np.angle(d) / np.pi
    pcm = np.clip(audio * 32767, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(fs))
        w.writeframes(pcm.tobytes())


def run_sondedump(binary, wav, fam):
    """Run sondedump on a WAV; parse its CSV/stdout telemetry lines."""
    type_flag = {"rs41": "rs41", "dfm": "dfm", "m10": "m10",
                 "ims100": "ims100", "imet4": "imet4", "c50": "c50",
                 "mrzn1": "mrz"}.get(fam, fam)
    out = subprocess.run([binary, "-t", type_flag, wav],
                         capture_output=True, text=True, timeout=300)
    return {"returncode": out.returncode,
            "stdout_tail": out.stdout[-2000:],
            "stderr_tail": out.stderr[-500:]}


def _device(name: str):
    """The torch device ``name``, or None (after saying why) when it names
    a CUDA device and there is none."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {name}: no CUDA device "
              "(torch.cuda.is_available() is false); pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return None
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sondedump", default=None,
                    help="path to an upstream sondedump checkout")
    ap.add_argument("--iq", action="append", default=[],
                    metavar="FAMILY=FILE[:RATE]",
                    help="recorded capture to cross-decode (repeatable)")
    ap.add_argument("--selftest", action="store_true",
                    help="synthetic end-to-end diff of every family")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the decode (default cuda)")
    ap.add_argument("--out", default="ORACLE.json")
    args = ap.parse_args(argv)

    device = None
    if args.selftest or args.iq:
        device = _device(args.device)
        if device is None:
            return 2
    report = {}
    if args.selftest:
        selftest(report, device)
    binary = None
    if args.sondedump:
        try:
            binary = build_sondedump(args.sondedump)
            print(f"built sondedump: {binary}")
        except Exception as e:
            print(f"sondedump build FAILED: {e}", file=sys.stderr)
            report["_sondedump"] = {"error": str(e)}
    for spec_arg in args.iq:
        fam, _, rest = spec_arg.partition("=")
        fname, _, rate = rest.partition(":")
        fs = float(rate) if rate else 48000.0
        iq = np.fromfile(fname, np.complex64)
        frames, sess = _decode(fam, iq, fs=fs, device=device)
        entry = report.setdefault(fam, {"status": FAMILIES[fam][3]})
        entry["iq"] = {"file": fname, "rate": fs,
                       "frames_decoded": len(frames),
                       "telemetry": {k: v for k, v in vars(
                           sess.telemetry.get(0, object())).items()
                           if isinstance(v, (int, float, str))}
                       if sess.telemetry else {}}
        if binary:
            wav = fname + ".oracle.wav"
            _write_fm_wav(iq, wav, fs=fs)
            entry["sondedump"] = run_sondedump(binary, wav, fam)
    if binary and not args.iq:
        # no recorded IQ: cross-decode the SYNTHETIC captures
        for fam, (modpath, mcls, tcls, status, reason) in FAMILIES.items():
            m = importlib.import_module(modpath)
            mod = getattr(m, mcls)()
            truths = _truths(getattr(m, tcls))
            iq = _modulate(fam, m, mod, truths)
            wav = os.path.join(tempfile.gettempdir(), f"oracle_{fam}.wav")
            _write_fm_wav(iq, wav)
            entry = report.setdefault(fam, {"status": status})
            entry["sondedump_synthetic"] = run_sondedump(binary, wav, fam)
            print(f"{fam:8s} sondedump rc="
                  f"{entry['sondedump_synthetic']['returncode']}")
    if not args.selftest and not args.iq and not binary:
        # readiness report
        print(f"{'family':8s} {'layout':16s} oracle status")
        for fam, (_, _, _, status, reason) in FAMILIES.items():
            ready = ("READY (awaiting recorded IQ or sondedump checkout)"
                     if status != "framework" else
                     f"BLOCKED: {reason}")
            print(f"{fam:8s} {status:16s} {ready}")
            report[fam] = {"status": status, "ready": status != "framework",
                           "reason": reason}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report -> {args.out}")
    bad = [f for f, e in report.items()
           if isinstance(e, dict) and e.get("ok") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
