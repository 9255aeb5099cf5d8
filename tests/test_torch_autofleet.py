"""The port's AutoFleet (sondetpu_torch/runtime/autofleet.py) against the
JAX package's, block by block, on the scenarios of tests/test_autofleet.py.

Both packages get the same wideband blocks (4 bins of 48 kHz). Per block
the update stream (channel, sonde and the whole telemetry record), the
tracked list and every ``on_change`` must be equal. A tracked carrier's
centre comes from the PSD, which the two packages round differently
(tests/test_torch_scan.py), so centres and seed offsets agree within 1 Hz;
everything decoded from frames agrees exactly. One test shows the
reference's frozen session after a rebuild beside the port's live one
(ROADMAP.md §C); the checkpoint tests load the port's own checkpoints and
one that the JAX package wrote (tests/data/jax_autofleet_checkpoint.py).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import sondetpu.runtime.autofleet as jaf
import sondetpu_torch.runtime.autofleet as taf
from sondetpu_torch.io.iq import write_iq
from sondetpu_torch.runtime import checkpoint as tckpt
from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
from sondetpu_torch.sondes.modulate import freq_shift, gfsk_modulate
from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)
from torch_cli_cases import decode

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "data"))
import jax_autofleet_checkpoint as fixture  # noqa: E402

N_BINS = 4
FS_CHAN = 48000.0
FS_WIDE = N_BINS * FS_CHAN
W = N_BINS * 48000


def _rs41_sig(n_frames, first=40, f_center=FS_CHAN):
    mod = RS41Modulator()
    bits = mod.frames_to_bits(np.stack(
        [mod.build_frame(RS41Truth(frame_no=first + i))
         for i in range(n_frames)]))
    return freq_shift(gfsk_modulate(bits, FS_WIDE / 4800.0, 2400.0 / FS_WIDE),
                      f_center / FS_WIDE)


def _m10_sig(n_frames):
    mod = M10Modulator()
    chips = mod.frames_to_chips(np.stack(
        [mod.build_frame(M10Truth(frame_no=8 + i)) for i in range(n_frames)]))
    return freq_shift(
        gfsk_modulate(chips, FS_WIDE / 9600.0, 12000.0 / FS_WIDE, bt=0.7),
        -FS_CHAN / FS_WIDE)                           # bin -1


def _place(n_blocks, *parts):
    """complex64 [n_blocks * W] with each (signal, start sample) added."""
    wide = np.zeros(n_blocks * W, np.complex64)
    for sig, start in parts:
        seg = sig[:wide.size - start]
        wide[start:start + seg.size] += seg
    return wide


def _discover_and_grow():
    """RS41 from t=0; an M10 launches 3 blocks in."""
    return _place(9, (_rs41_sig(14), 0), (_m10_sig(60), 3 * W))


def _rs41_only(frames, blocks, f_center=FS_CHAN):
    return _place(blocks, (_rs41_sig(frames, f_center=f_center), 0))


def _multi_carrier():
    """Two RS41s (bin 1; bin -2 + 3 kHz) and an M10 (bin -1)."""
    mod = RS41Modulator()
    bits = mod.frames_to_bits(np.stack(
        [mod.build_frame(RS41Truth(frame_no=90 + i)) for i in range(10)]))
    rs_b = freq_shift(gfsk_modulate(bits, FS_WIDE / 4800.0, 2400.0 / FS_WIDE),
                      (-2 * FS_CHAN + 3000.0) / FS_WIDE)
    return _place(6, (_rs41_sig(10), 0), (rs_b, 0), (_m10_sig(40), 0))


# scenario -> (wideband capture, AutoFleet keywords)
SCENARIOS = {
    "discover_and_grow": (_discover_and_grow, dict(
        rescan_blocks=3, probe_blocks=2, families=["rs41", "m10"])),
    "drop_idle": (lambda: _rs41_only(6, 10), dict(
        rescan_blocks=2, probe_blocks=2, families=["rs41"],
        drop_idle_blocks=3)),
    "failed_not_reprobed": (lambda: _rs41_only(14, 6), dict(
        rescan_blocks=2, probe_blocks=1, families=["m10"])),
    "multi_carrier": (_multi_carrier, dict(
        rescan_blocks=3, probe_blocks=2, families=["rs41", "m10"])),
    # one carrier discovered once: no group survives a membership rebuild,
    # so the AFC fold-back reads the same session in both packages
    "afc_refresh": (lambda: _rs41_only(14, 8, FS_CHAN + 3000.0), dict(
        rescan_blocks=2, probe_blocks=2, families=["rs41"], afc=True)),
}


def _telem(t):
    return json.dumps(t.to_dict(), sort_keys=True)


def _tracked(auto):
    return [(t.sonde, t.pfb_bin, t.seed_offset_hz, t.center_hz,
             t.last_update_block, t.found_block,
             None if t.telem is None else _telem(t.telem))
            for t in auto.tracked]


def run(package, wide, kw, form="complex", monkeypatch=None):
    """Drive one package's AutoFleet over ``wide`` block by block; returns
    (the AutoFleet, per-block records, the on_change lists, the number of
    classify_carriers calls). ``form`` "planes" alternates complex blocks
    with plane pairs (tensors for the port, arrays for JAX)."""
    mod = taf if package == "port" else jaf
    calls = []
    if monkeypatch is not None:
        real = mod.classify_carriers
        monkeypatch.setattr(mod, "classify_carriers",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    updates, changes = [], []
    extra = {"device": "cpu"} if package == "port" else {}
    auto = mod.AutoFleet(
        n_bins=N_BINS, min_snr_db=8.0, **kw, **extra,
        on_update=lambda ch, s, t: updates.append((ch, s, _telem(t))),
        on_change=lambda tr: changes.append(
            [(t.sonde, t.pfb_bin) for t in tr]))
    records = []
    for b in range(wide.size // W):
        blk = wide[b * W:(b + 1) * W]
        if form == "planes" and b % 2:
            pi = np.ascontiguousarray(blk.real)
            pq = np.ascontiguousarray(blk.imag)
            blk = ((torch.from_numpy(pi), torch.from_numpy(pq))
                   if package == "port" else (pi, pq))
        n = auto.process_wideband(blk)
        records.append((n, list(updates), _tracked(auto)))
        updates.clear()
    return auto, records, changes, len(calls)


def assert_same_run(port, jax):
    """Equal per-block updates and tracked lists (centres and seed offsets
    within 1 Hz) and equal on_change lists."""
    (_, p_rec, p_chg, p_calls), (_, j_rec, j_chg, j_calls) = port, jax
    assert p_chg == j_chg
    assert p_calls == j_calls
    assert len(p_rec) == len(j_rec)
    for b, ((pn, pu, pt), (jn, ju, jt)) in enumerate(zip(p_rec, j_rec)):
        assert (pn, pu) == (jn, ju), f"block {b}"
        assert len(pt) == len(jt), f"block {b}"
        for p, j in zip(pt, jt):
            assert p[:2] + p[4:] == j[:2] + j[4:], f"block {b}"
            assert abs(p[2] - j[2]) < 1.0 and abs(p[3] - j[3]) < 1.0


@pytest.fixture(scope="module")
def grow_runs():
    wide, kw = SCENARIOS["discover_and_grow"][0](), \
        SCENARIOS["discover_and_grow"][1]
    return run("port", wide, kw), run("jax", wide, kw)


def test_discover_and_grow_equals_the_original(grow_runs):
    port, jax = grow_runs
    assert_same_run(port, jax)
    auto = port[0]
    assert [c[0] for c in port[2][0]] == ["rs41"]
    assert sorted(t.sonde for t in auto.tracked) == ["m10", "rs41"]
    by_type = {s: t for _, (s, t) in auto.telemetry.items()}
    assert by_type["rs41"].serial == "S1234567"
    assert by_type["m10"].serial == "910-2-12345"
    assert by_type["rs41"].seq >= 48


@pytest.mark.parametrize("name", ["drop_idle", "failed_not_reprobed",
                                  "multi_carrier", "afc_refresh"])
def test_scenario_equals_the_original(name, monkeypatch):
    make, kw = SCENARIOS[name]
    wide = make()
    port = run("port", wide, kw, monkeypatch=monkeypatch)
    jax = run("jax", wide, kw, monkeypatch=monkeypatch)
    assert_same_run(port, jax)
    auto = port[0]
    if name == "drop_idle":
        assert max(len(r[2]) for r in port[1]) == 1
        assert auto.tracked == [] and auto.fleet is None
    elif name == "failed_not_reprobed":
        assert auto.tracked == [] and port[3] == 1
    elif name == "multi_carrier":
        assert sorted(t.sonde for t in auto.tracked) == ["m10", "rs41", "rs41"]
        assert auto.fleet.groups["rs41"][1].config.channels == 2
        assert len({t.telem.seq for t in auto.tracked
                    if t.sonde == "rs41"}) == 2
    else:
        (t,) = auto.tracked
        assert abs(t.center_hz - 51000.0) < 1500.0
        assert t.telem.serial == "S1234567"
        # the refreshed centre is the AFC-tracked frequency of the group
        # session both packages step
        freq = float(auto.fleet.groups["rs41"][1].afc_freqs[0])
        assert t.center_hz == pytest.approx(FS_CHAN + freq, abs=1e-6)


def test_plane_pairs_equal_complex_blocks():
    """Blocks alternate between complex arrays and plane pairs (tensors for
    the port): the same run as the original's, and as all-complex input."""
    make, kw = SCENARIOS["drop_idle"]
    wide = make()
    port = run("port", wide, kw, form="planes")
    assert_same_run(port, run("jax", wide, kw, form="planes"))
    assert_same_run(port, run("port", wide, kw))


def test_rebuild_keeps_the_stepped_sessions(grow_runs):
    """After the m10 rebuild the reference's fleet.groups holds the old
    rs41 session, frozen at 4 blocks, while its fused step advances the
    new one; the port's groups and step hold the same live sessions. The
    three places that read a group's session after such a rebuild
    (fleet.telemetry, the AFC fold-back, save_autofleet's group payload)
    therefore read the live session in the port and the frozen one in the
    reference."""
    (pauto, *_), (jauto, *_) = grow_runs
    j_frozen = jauto.fleet.groups["rs41"][1]
    j_stepped = {s: sess for s, _, sess in jauto.fleet._order}
    assert j_frozen is not j_stepped["rs41"]
    assert j_frozen.blocks_seen == 4
    assert j_stepped["rs41"].blocks_seen == 3
    p_stepped = {s: sess for s, _, sess in pauto.fleet._order}
    for sonde, (_idxs, sess) in pauto.fleet.groups.items():
        assert sess is p_stepped[sonde]
    assert pauto.fleet.groups["rs41"][1].blocks_seen == 3
    # fleet.telemetry: the port's rs41 entry is the live one, which the
    # AutoFleet's last-known telemetry also holds; the reference's is older
    ch = next(i for i, t in enumerate(pauto.tracked) if t.sonde == "rs41")
    live = pauto.telemetry[ch][1]
    assert _telem(pauto.fleet.telemetry[ch]) == _telem(live)
    assert _telem(jauto.telemetry[ch][1]) == _telem(live)
    assert jauto.fleet.telemetry[ch].seq < live.seq


def test_port_checkpoint_round_trips(tmp_path):
    """save_autofleet after 3 blocks, load_autofleet into a fresh AutoFleet:
    both continue to the same updates and telemetry."""
    wide = _rs41_only(10, 5)
    kw = dict(n_bins=N_BINS, device="cpu", rescan_blocks=2, probe_blocks=2,
              families=["rs41"], min_snr_db=8.0)
    auto = taf.AutoFleet(**kw)
    for b in range(3):
        auto.process_wideband(wide[b * W:(b + 1) * W])
    assert len(auto.tracked) == 1
    path = str(tmp_path / "auto.ckpt")
    tckpt.save_autofleet(auto, path)
    auto2 = taf.AutoFleet(**kw)
    tckpt.load_autofleet(auto2, path)
    assert _tracked(auto2) == _tracked(auto)
    assert auto2.blocks_seen == 3
    for a in (auto, auto2):
        for b in range(3, 5):
            a.process_wideband(wide[b * W:(b + 1) * W])
    assert _tracked(auto2) == _tracked(auto)
    assert auto2.telemetry[0][1].serial == "S1234567"
    with pytest.raises(ValueError, match="n_bins"):
        tckpt.load_autofleet(taf.AutoFleet(8, "cpu"), path)
    tckpt.save_session(auto.fleet.groups["rs41"][1], str(tmp_path / "s.ckpt"))
    with pytest.raises(ValueError, match="autofleet"):
        tckpt.load_autofleet(taf.AutoFleet(**kw), str(tmp_path / "s.ckpt"))


def test_jax_checkpoint_continues_as_the_original():
    """The JAX package's AutoFleet checkpoint (tests/data) loads into the
    port, without JAX in the loader, and the port's continuation equals
    the JAX package's own continuation from it."""
    with open(fixture.EXPECTED) as f:
        want = json.load(f)
    r = want["recipe"]
    assert r == fixture.RECIPE
    wide = fixture.wideband(r)
    w = r["n_bins"] * r["block_len"]
    updates = []
    block = [0]
    auto = taf.AutoFleet(device="cpu", **fixture.autofleet_kwargs(r),
                         on_update=lambda ch, s, t: updates.append(
                             fixture.update_record(block[0], ch, s, t)))
    tckpt.load_autofleet(auto, fixture.CKPT)
    assert all(type(t) is taf.TrackedSonde for t in auto.tracked)
    for block[0] in range(r["blocks_saved"], r["blocks"]):
        auto.process_wideband(wide[block[0] * w:(block[0] + 1) * w])
    assert updates == want["updates"]
    assert {u[2] for u in updates} == {"rs41", "m10"}
    got = [[t.sonde, t.pfb_bin, t.center_hz] for t in auto.tracked]
    assert [g[:2] for g in got] == [t[:2] for t in want["tracked"]]
    for g, t in zip(got, want["tracked"]):
        assert abs(g[2] - t[2]) < 1.0


def test_cli_auto_decode_equals_the_original(tmp_path):
    """``decode --wideband --auto`` of tests/test_autofleet.py's capture
    with --drop-idle, --families, --min-snr, --probe-blocks and
    --checkpoint, then --resume on a second file: the port's JSONL and GPX
    equal the JAX CLI's in both runs, and the port resumes from the JAX
    package's checkpoint to the same lines."""
    first = str(tmp_path / "first.cf32")
    write_iq(first, _rs41_only(10, 6))
    rest = str(tmp_path / "rest.cf32")
    write_iq(rest, _rs41_only(14, 7)[3 * W:])
    base = ["--wideband", "--bins", "4", "--auto", "--rescan", "3",
            "--drop-idle", "5", "--families", "rs41,m10", "--min-snr", "8",
            "--probe-blocks", "2"]
    out = {}
    for who in ("jax", "port"):
        ck = str(tmp_path / f"{who}.ckpt")
        a = decode(who, ["--iq", first, "--checkpoint", ck] + base,
                   str(tmp_path / f"{who}_a"), sinks=("jsonl", "gpx"))
        b = decode(who, ["--iq", rest, "--resume", ck] + base,
                   str(tmp_path / f"{who}_b"), sinks=("jsonl",))
        out[who] = (a, b)
    lines = out["jax"][0]["jsonl"].decode().splitlines()
    assert len(lines) >= 3 and '"serial": "S1234567"' in lines[-1]
    assert out["port"][0]["jsonl"].decode().splitlines() == lines
    assert out["port"][0]["gpx"] == out["jax"][0]["gpx"]
    resumed = out["jax"][1]["jsonl"].decode().splitlines()
    assert len(resumed) >= 3
    assert out["port"][1]["jsonl"].decode().splitlines() == resumed
    cross = decode("port", ["--iq", rest, "--resume",
                            str(tmp_path / "jax.ckpt")] + base,
                   str(tmp_path / "cross"), sinks=("jsonl",))
    assert cross["jsonl"].decode().splitlines() == resumed


def test_cli_auto_needs_a_card_or_cpu(tmp_path, capsys):
    from sondetpu_torch.cli import main as tcli

    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    path = str(tmp_path / "wide.cf32")
    write_iq(path, np.zeros(W, np.complex64))
    assert tcli.main(["decode", "--iq", path, "--wideband", "--bins", "4",
                      "--auto"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
