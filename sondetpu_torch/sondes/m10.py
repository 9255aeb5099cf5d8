"""Meteomodem M10/M20 protocol: 9600 cps biphase-mark + rolling checksum
(counterpart: ``sondetpu/sondes/m10.py``).

A jax-free copy of the original, which is reached only through
``sondetpu.sondes``, whose package import pulls in every family and
jax. It registers the m10 family in the port's registry.

Re-creates sondedump's M10 decoder capability (SURVEY.md S3; reference API
decoder.hpp:11; 9600 Bd GFSK + Manchester/biphase deframe + checksum verify
per BASELINE.json:8; 50 kHz channel bandwidth per main.hpp:48; M10 has RH,
M20 does not, README.md:11,13).

REAL on-air layout (public protocol; per-field provenance in PROTOCOLS.md
"m10"). The gather window is [2 preamble-tail bytes 0xAA 0xAA][frame]:

  M10 frame (101 bytes, all multi-byte fields BIG-endian):
    0x00  u8   0x64  (= 100, bytes following the length byte)
    0x01  2B   0x9F 0x20 frame type (Trimble GPS variant)
    0x04  3 x i16  vE, vN, vU  cm/s
    0x0A  u32  GPS time of week, ms
    0x0E  i32  latitude,  1e-6 deg
    0x12  i32  longitude, 1e-6 deg
    0x16  i32  altitude,  mm
    0x20  u16  GPS week
    0x32  u24  RH reference-capacitance counts   [public-partial]
    0x35  u24  RH sensor-capacitance counts      [public-partial]
    0x49  u16  NTC ADC counts (Shibaura PB5-41E thermistor; PROTOCOLS.md)
    0x5D  5B   serial number bytes -> printed id "XNN-T-NNNNN"
    0x63  u16  rolling checksum over bytes 0x00..0x62
  RH is derived from the capacitance ratio r = C/C_ref as
  RH = (r - 0.8955) / 0.002 % (capacitive-sensor model first published by
  DF9DQ and carried by the open M10 decoders; offsets/constants
  public-partial — reconstructed, unverified against recorded IQ).

  M20 frame (70 bytes, big-endian; public layout of the open decoder
  ecosystem, per-field provenance in PROTOCOLS.md "m10"):
    0x00  u8   0x45  (= 69, bytes following the length byte)
    0x01  u8   0x20  frame type
    0x02  u16  NTC ADC counts (position reconstructed, low confidence)
    0x08  u24  altitude, cm
    0x0F  u24  GPS time of week, s
    0x12  3B   serial number bytes
    0x15  u8   frame counter
    0x16  u16  inner block checksum over 0x02..0x15 (same rolling alg)
    0x18  i16  vE cm/s;  0x1A  i16  vN cm/s
    0x1C  i32  latitude,  1e-6 deg
    0x20  i32  longitude, 1e-6 deg
    0x24  i16  vU cm/s
    0x26  u16  GPS week
    0x44  u16  rolling checksum over bytes 0x00..0x43
  No RH sensor (README.md:13). When the outer checksum fails but the inner
  block checksum passes, the 0x02..0x15 block (alt/time/serial/counter) is
  still accepted — the blocked layout exists exactly so receivers can
  salvage the inner packet.

Both subtypes decode on the same "m10" channel — the gather window is 103
bytes and frames dispatch on the length/type bytes (mirroring the
reference's single M10/M20 entry, main.hpp:48).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from sondetpu_torch.sondes import geo
from sondetpu_torch.sondes.base import ProtocolSpec, SondeDecoderBase, register_sonde
from sondetpu_torch.sondes.modulate import gfsk_modulate
from sondetpu_torch.sync.coding import np_bytes_to_bits
from sondetpu_torch.telemetry import Fields, TelemetryFragment

CHIP_RATE = 9600.0
M10_LEN = 101                 # 0x64 + 1
M20_LEN = 70                  # 0x45 + 1
FRAME_BYTES = 2 + M10_LEN     # window: preamble tail + longest frame
SYNCWORD = bytes([0xAA, 0xAA, 0x64, 0x9F, 0x20])

SPEC = ProtocolSpec(
    name="m10",
    display_name="M10/M20",
    bandwidth=5e4,            # main.hpp:48
    baud=CHIP_RATE,
    modulation="gfsk",
    syncword=SYNCWORD,
    lsb_first=False,
    frame_bytes=FRAME_BYTES,
    line_code="biphase_m",
    deviation=12000.0,
    extra={"abs_corr": True,     # biphase-M polarity ambiguity
           # dev 12 kHz >> baud: the FM discriminator clicks below ~8 dB
           # SNR; the dual-tone noncoherent front end has no threshold
           # (runtime/pipeline.py _dualtone)
           "fsk_dualtone": True,
           # M20 subtype shares the channel but has its own length/type
           "alt_syncword": bytes([0xAA, 0xAA, 0x45, 0x20]),
           # soft-decision assist: device ranks the 8 weakest decoded
           # bits per frame for the host's Chase checksum repair — once
           # over the full M10 window and once over the M20 subframe span
           # so short M20 frames get in-frame candidates (PROTOCOLS.md)
           "chase_m": 12,
           "chase_spans": ((0, (2 + M10_LEN) * 8), (0, (2 + M20_LEN) * 8))},
)

# Shibaura PB5-41E NTC Steinhart-Hart (1/T = p0+p1*L+p2*L^2+p3*L^3, L=lnR)
_P = (1.07303516e-3, 2.41296733e-4, 2.26744154e-6, 6.52855181e-8)
_RS = 12.1e3                  # series resistor of the ADC divider

# M10 capacitive RH model (DF9DQ-derived, public-partial; PROTOCOLS.md):
# RH% = (C/C_ref - _RH_C0) / _RH_C1
_RH_C0, _RH_C1 = 0.8955, 0.002


def m10_rh(counts: int, ref_counts: int) -> float:
    """RH%% from the sensor/reference capacitance count pair."""
    if ref_counts <= 0 or counts <= 0:
        return float("nan")
    rh = (counts / float(ref_counts) - _RH_C0) / _RH_C1
    return float(min(100.0, max(0.0, rh)))


def m10_rh_counts(rh: float, ref_counts: int = 1 << 20) -> Tuple[int, int]:
    """Inverse of m10_rh (for the modulator)."""
    return int(round(ref_counts * (_RH_C0 + _RH_C1 * rh))), ref_counts


def m10_checksum(data: np.ndarray) -> int:
    """The M10/M20 rolling 16-bit checksum (public algorithm).

    Per-byte update: the byte is rotated and self-XORed, the low state byte
    feeds back through a parity-tap permutation, the high state byte shifts
    down (PROTOCOLS.md m10)."""
    c = 0
    for x in np.asarray(data, dtype=np.uint8):
        b = int(x)
        c1 = c & 0xFF
        b = ((b >> 1) | ((b & 1) << 7))
        b ^= (b >> 2) & 0xFF
        t6 = (c & 1) ^ ((c >> 2) & 1) ^ ((c >> 4) & 1)
        t7 = ((c >> 1) & 1) ^ ((c >> 3) & 1) ^ ((c >> 5) & 1)
        t = (c & 0x3F) | (t6 << 6) | (t7 << 7)
        s = (c >> 7) & 0xFF
        s ^= (s >> 2) & 0xFF
        c0 = b ^ t ^ s
        c = ((c1 << 8) | (c0 & 0xFF)) & 0xFFFF
    return c


def m10_checksum_many(data: np.ndarray) -> np.ndarray:
    """Vectorized m10_checksum over rows: [n, L] uint8 -> [n] uint16."""
    data = np.atleast_2d(np.asarray(data, dtype=np.uint8))
    c = np.zeros(data.shape[0], np.uint32)
    for k in range(data.shape[1]):
        b = data[:, k].astype(np.uint32)
        c1 = c & 0xFF
        b = (b >> 1) | ((b & 1) << 7)
        b ^= (b >> 2) & 0xFF
        t6 = (c ^ (c >> 2) ^ (c >> 4)) & 1
        t7 = ((c >> 1) ^ (c >> 3) ^ (c >> 5)) & 1
        t = (c & 0x3F) | (t6 << 6) | (t7 << 7)
        s = (c >> 7) & 0xFF
        s ^= (s >> 2) & 0xFF
        c = ((c1 << 8) | ((b ^ t ^ s) & 0xFF)) & 0xFFFF
    return c.astype(np.uint16)


_SYND_CACHE: dict = {}
_SYND_POS_CACHE: dict = {}


def syndrome_positions(span_bytes: int) -> dict:
    """syndrome value -> array of span/check positions producing it (for
    O(1) completion lookups in the pair/triple search)."""
    m = _SYND_POS_CACHE.get(span_bytes)
    if m is None:
        synd = checksum_syndromes(span_bytes)
        allv = np.concatenate([synd, (1 << np.arange(15, -1, -1))
                               .astype(np.uint32)])
        order = np.argsort(allv, kind="stable")
        sv = allv[order]
        starts = np.searchsorted(sv, np.arange(1 << 16))
        m = (allv, order, sv, starts)
        _SYND_POS_CACHE[span_bytes] = m
    return m


def syndrome_lookup(span_bytes: int, value: int) -> np.ndarray:
    """Positions (indices into the span+check flip table) whose single-flip
    syndrome equals ``value``."""
    allv, order, sv, starts = syndrome_positions(span_bytes)
    v = int(value) & 0xFFFF
    a = int(starts[v])
    b = int(starts[v + 1]) if v + 1 < starts.size else sv.size
    return order[a:b]


def checksum_syndromes(span_bytes: int) -> np.ndarray:
    """S[j] = checksum delta from flipping bit j (MSB-first) of a
    span_bytes-long checksummed span.

    The rolling checksum is GF(2)-LINEAR (every update step is built from
    XORs, shifts, rotations and parity taps; checksum(0) == 0 — asserted
    in tests), so check(x ^ e) == check(x) ^ check(e): repairing a failed
    frame reduces to finding a small set of bit flips whose syndromes XOR
    to the observed checksum mismatch. This is what lets the Chase search
    cover EVERY bit position, not just the device-ranked weak bits."""
    tab = _SYND_CACHE.get(span_bytes)
    if tab is None:
        nbits = span_bytes * 8
        eye = np.zeros((nbits, span_bytes), np.uint8)
        j = np.arange(nbits)
        eye[j, j >> 3] = (0x80 >> (j & 7)).astype(np.uint8)
        tab = m10_checksum_many(eye).astype(np.uint32)
        _SYND_CACHE[span_bytes] = tab
    return tab


def ntc_temp(adc: int) -> float:
    """Temperature (degC) from the 12-bit NTC ADC divider reading."""
    adc = int(adc) & 0xFFF
    if adc <= 0 or adc >= 4095:
        return float("nan")
    r = _RS * adc / (4096.0 - adc)
    ln = np.log(r)
    inv_t = _P[0] + _P[1] * ln + _P[2] * ln * ln + _P[3] * ln ** 3
    return float(1.0 / inv_t - 273.15)


def ntc_adc(temp_c: float) -> int:
    """Inverse of ntc_temp (for the modulator)."""
    target = 1.0 / (temp_c + 273.15)
    roots = np.roots([_P[3], _P[2], _P[1], _P[0] - target])
    real = [x.real for x in roots if abs(x.imag) < 1e-9 and 0.0 < x.real < 20.0]
    r = float(np.exp(min(real, key=lambda x: abs(x - 9.5))))
    return int(round(4096.0 * r / (_RS + r)))


def m20_serial(b: np.ndarray) -> str:
    """Printed-id reconstruction from the 3 serial bytes @0x12
    (public-partial formatting, PROTOCOLS.md m10)."""
    num = (int(b[1]) << 8) | int(b[2])
    return "%1X%02u-%05u" % (int(b[0]) >> 4, int(b[0]) & 0xF, num)


def m10_serial(b: np.ndarray) -> str:
    """Printed-id reconstruction from the 5 serial bytes @0x5D
    (public-partial, PROTOCOLS.md m10)."""
    num = ((int(b[2]) << 16) | (int(b[3]) << 8) | int(b[4])) % 100000
    return "%1X%02u-%1u-%05u" % (int(b[0]) >> 4, int(b[0]) & 0xF,
                                 int(b[1]) & 0xF, num)


class M10Decoder(SondeDecoderBase):
    spec = SPEC
    # the device ships per-frame weakest-bit ranks (spec extra['chase_m']);
    # checksum failures get a Chase-2 style flip search over them
    wants_weak_bits = True

    # consecutive chase-only anchor refreshes allowed before the anchor
    # expires: each accepted repair passes the gate against the PREVIOUS
    # anchor, so a chain of mis-repairs each within the 0.1 deg / 2 km
    # bound could otherwise walk the anchor arbitrarily far from truth
    # under sustained low SNR; only a clean full-checksum frame re-grounds
    MAX_CHASE_STREAK = 8

    def __init__(self) -> None:
        # last checksum-clean fix per channel: the temporal-consistency
        # gate for chase repairs (see _consistent)
        self._last: dict = {}
        # consecutive chase-refreshes since the last clean frame per channel
        self._chase_streak: dict = {}

    def reset_channel(self, channel: int) -> None:
        self._last.pop(channel, None)
        self._chase_streak.pop(channel, None)

    def decode_byte_frames(self, frames: np.ndarray, channels,
                           weak_bits: Optional[np.ndarray] = None
                           ) -> List[Tuple[int, TelemetryFragment]]:
        frames = np.atleast_2d(np.asarray(frames, dtype=np.uint8))
        out = []
        for fi in range(frames.shape[0]):
            w = frames[fi]
            ch = int(np.asarray(channels)[fi])
            frag = self._try_window(w)
            if frag is not None:
                # a clean full-checksum pass anchors the channel's
                # consistency reference for future chase repairs
                if frag.fields & Fields.POS:
                    self._last[ch] = frag
                    self._chase_streak[ch] = 0
            elif weak_bits is not None:
                frag = self._chase(w, weak_bits[fi], ch)
            if frag is not None and frag.fields:
                out.append((ch, frag))
        return out

    def _try_window(self, w: np.ndarray) -> Optional[TelemetryFragment]:
        if w[0:2].tobytes() != b"\xaa\xaa":
            return None
        f = w[2:]                              # the real frame
        if f[0] == 0x64 and f[1] == 0x9F and f[2] == 0x20:
            want = (int(f[0x63]) << 8) | int(f[0x64])
            if m10_checksum(f[0:0x63]) != want:
                return None
            return self._parse(f)
        if f[0] == 0x45 and f[1] == 0x20:
            want = (int(f[0x44]) << 8) | int(f[0x45])
            if m10_checksum(f[0:0x44]) == want:
                return self._parse_m20(f, full=True)
            # outer failed: salvage the inner 0x02..0x15 block if its own
            # checksum (0x16) passes — alt/time/serial survive
            blk = (int(f[0x16]) << 8) | int(f[0x17])
            if m10_checksum(f[0x02:0x16]) == blk:
                return self._parse_m20(f, full=False)
            return None
        return None

    # layouts the chase solver knows: (span_start, span_len, check_off)
    # in FRAME byte coordinates (window bytes shift by +2 for the preamble)
    _CHASE_LAYOUTS = {
        "m10": (0x00, 0x63, 0x63),
        "m20": (0x00, 0x44, 0x44),
        "m20_inner": (0x02, 0x14, 0x16),
    }

    def _chase(self, w: np.ndarray, weak, ch: int
               ) -> Optional[TelemetryFragment]:
        """Soft-decision checksum repair by SYNDROME DECODING (PROTOCOLS.md
        m10 — the checksum-only protocol has no FEC; reliability-ordered
        re-slicing is the only way to buy back SNR).

        The rolling checksum is GF(2)-linear (checksum_syndromes), so a
        failing frame's checksum mismatch D identifies repair candidates
        directly: any flip set whose syndromes XOR to D. The search covers
        - single flips ANYWHERE in the span or the stored check bytes,
        - pairs with at least one device-ranked weak bit,
        - pairs and triples entirely within the weak set,
        ordered by reliability, with every hit re-verified by a real
        checksum pass (_try_window) plus a telemetry plausibility gate (a
        16-bit check admits ~2e-5 false accepts per candidate; the gate
        keeps repaired noise from fabricating telemetry at fleet scale)."""
        nbits = w.size * 8
        weak = [int(b) for b in dict.fromkeys(           # dedupe span lists
            int(b) for b in np.asarray(weak).ravel()) if 0 <= int(b) < nbits]
        f = w[2:]
        # dispatch on the closer frame-type header (it rode the correlated
        # syncword, so it is almost always intact)
        d10 = bin(int(f[0]) ^ 0x64).count("1") + bin(int(f[1]) ^ 0x9F).count("1")
        d20 = bin(int(f[0]) ^ 0x45).count("1") + bin(int(f[1]) ^ 0x20).count("1")
        layouts = ["m10"] if d10 <= d20 else ["m20", "m20_inner"]
        for lay in layouts:
            frag = self._chase_layout(w, weak, lay, ch=ch)
            if frag is not None:
                return frag
        return None

    def _chase_layout(self, w: np.ndarray, weak, lay: str,
                      max_tries: int = 160, ch: int = -1
                      ) -> Optional[TelemetryFragment]:
        span0, span_len, chk = self._CHASE_LAYOUTS[lay]
        f = w[2:]
        if chk + 2 > f.size:
            return None
        stored = (int(f[chk]) << 8) | int(f[chk + 1])
        d = int(m10_checksum_many(f[span0:span0 + span_len][None])[0]) ^ stored
        if d == 0:
            return None                       # hard parse already handled it
        synd = checksum_syndromes(span_len)   # [span_len*8] uint32
        # window-bit coordinate of span bit j / stored-check bit b
        span_w0 = (2 + span0) * 8
        chk_w0 = (2 + chk) * 8
        all_synd = np.concatenate([synd, (1 << np.arange(15, -1, -1))
                                   .astype(np.uint32)])
        all_wbit = np.concatenate([span_w0 + np.arange(span_len * 8),
                                   chk_w0 + np.arange(16)])
        # weak bits that fall inside this layout's span/check region
        widx = [np.nonzero(all_wbit == b)[0] for b in weak]
        widx = [int(i[0]) for i in widx if i.size]
        wsynd = [int(all_synd[i]) for i in widx]

        cands: List[Tuple[int, ...]] = []
        seen = set()

        def push(*idxs):
            key = tuple(sorted(idxs))
            if key not in seen:
                seen.add(key)
                cands.append(key)

        nw = len(widx)
        # 1. weak singles, then singles anywhere
        for i, s in zip(widx, wsynd):
            if s == d:
                push(i)
        for i in syndrome_lookup(span_len, d):
            push(int(i))
        # 2. pairs within the weak set (most reliable flips first)
        for a in range(nw):
            for b in range(a + 1, nw):
                if wsynd[a] ^ wsynd[b] == d:
                    push(widx[a], widx[b])
        # 3. pairs with exactly one weak bit (dict completion lookups)
        for i, s in zip(widx, wsynd):
            for j in syndrome_lookup(span_len, d ^ s):
                if int(j) != i:
                    push(i, int(j))
        # 4. triples within the weak set
        for a in range(nw):
            for b in range(a + 1, nw):
                t = d ^ wsynd[a] ^ wsynd[b]
                for c in range(b + 1, nw):
                    if wsynd[c] == t:
                        push(widx[a], widx[b], widx[c])
        # 5. pairs with NO weak bit: complete every position against d in
        #    one vectorized sorted-table probe (~(span_bits^2)/2^16 real
        #    candidates — a handful; a per-position Python loop would cost
        #    milliseconds per failing window at fleet scale)
        allv, order, sv, tab = syndrome_positions(span_len)
        targets = (np.uint32(d) ^ all_synd).astype(np.int64)
        a = tab[targets]
        # targets <= 0xFFFF, so targets+1 == tab.size falls to the else
        # branch (sv.size) here — no separate boundary fixup needed
        b = np.where(targets + 1 < tab.size, tab[np.minimum(targets + 1,
                                                            tab.size - 1)],
                     sv.size)
        for i in np.nonzero(b > a)[0]:
            for j in order[a[i]:b[i]]:
                if int(j) > int(i):
                    push(int(i), int(j))
            if len(cands) > 4 * max_tries:
                break
        # 6. triples with two weak bits + one anywhere
        for a in range(nw):
            for b in range(a + 1, nw):
                t = d ^ wsynd[a] ^ wsynd[b]
                for j in syndrome_lookup(span_len, t):
                    if int(j) not in (widx[a], widx[b]):
                        push(widx[a], widx[b], int(j))
        # 7. quads within the weak set
        for a in range(nw):
            for b in range(a + 1, nw):
                t2 = d ^ wsynd[a] ^ wsynd[b]
                for c in range(b + 1, nw):
                    t3 = t2 ^ wsynd[c]
                    for e in range(c + 1, nw):
                        if wsynd[e] == t3:
                            push(widx[a], widx[b], widx[c], widx[e])

        # anchorless channels accept only RELIABILITY-SUPPORTED repairs:
        # without a prior fix the temporal gate can't fire, and an
        # anywhere-position flip that happens to match the syndrome
        # fabricates a checksum-valid frame ~1.3% of failing windows
        # (824 single positions / 2^16). Flips entirely inside the
        # device-ranked weak set carry soft-decision evidence; the full
        # anywhere search unlocks once a POSITION fix anchors the channel
        # (a POS-less fragment, e.g. an m20_inner salvage, must NOT anchor:
        # _consistent would pass trivially against it). The weak filter
        # runs BEFORE the max_tries truncation so anywhere-position
        # candidates never crowd all-weak triples/quads out of the budget.
        anchored = self._anchor(ch) is not None
        wset = set(widx)
        if not anchored:
            cands = [cd for cd in cands if all(i in wset for i in cd)]
        for cand in cands[:max_tries]:
            w2 = w.copy()
            for i in cand:
                b = int(all_wbit[i])
                w2[b >> 3] ^= 0x80 >> (b & 7)
            frag = self._try_window(w2)
            if frag is not None and not (frag.fields & Fields.POS) \
                    and not all(i in wset for i in cand):
                # a POS-less result (m20_inner salvage) slips past the
                # temporal gate trivially, so anywhere-position flips may
                # not produce one — only reliability-supported flips can
                continue
            if (frag is not None and self._plausible(frag)
                    and self._consistent(ch, frag)):
                # an accepted repair REFRESHES the anchor (it just passed
                # the gate against the previous one): under sustained low
                # SNR the reference tracks the moving sonde instead of
                # rejecting every correct repair once the flight drifts
                # past the gate bounds of a stale fix — but only for
                # MAX_CHASE_STREAK consecutive repairs; after that the
                # anchor EXPIRES (repair-derived anchors must not compound
                # indefinitely) and the channel falls back to the
                # anchorless weak-set-only policy until a clean frame
                if frag.fields & Fields.POS:
                    streak = self._chase_streak.get(ch, 0) + 1
                    if streak > self.MAX_CHASE_STREAK:
                        self._last.pop(ch, None)
                        self._chase_streak.pop(ch, None)
                    else:
                        self._last[ch] = frag
                        self._chase_streak[ch] = streak
                return frag
        return None

    def _anchor(self, ch: int) -> Optional[TelemetryFragment]:
        """The channel's anchor fix, valid only if it carries a position."""
        prev = self._last.get(ch)
        if prev is not None and (prev.fields & Fields.POS):
            return prev
        return None

    def _consistent(self, ch: int, frag: TelemetryFragment) -> bool:
        """Temporal-consistency gate for chase repairs: a syndrome-matched
        flip set satisfies the 16-bit checksum BY CONSTRUCTION, so when the
        true error count exceeds the flip size the repaired frame passes
        the checksum with corrupted fields remaining (measured at 2 dB:
        correct serial/lat but lon off by 130 deg). Against the channel's
        last checksum-clean fix a sonde moves < ~0.1 deg and < ~2 km
        between frames; anything further is a mis-repair. Channels with no
        prior fix fall back to the static range gate only."""
        prev = self._last.get(ch)
        if prev is None:
            return True
        if (frag.fields & Fields.POS) and (prev.fields & Fields.POS):
            if (abs(frag.lat - prev.lat) > 0.1
                    or abs(frag.lon - prev.lon) > 0.2
                    or abs(frag.alt - prev.alt) > 2000.0):
                return False
        if (frag.fields & Fields.TIME) and (prev.fields & Fields.TIME):
            if abs(frag.time - prev.time) > 600.0:
                return False
        return True

    @staticmethod
    def _plausible(frag: TelemetryFragment) -> bool:
        """Sanity gate on chase-repaired telemetry (a repaired frame proved
        only a 16-bit check; reject physically impossible fixes)."""
        if frag.fields & Fields.POS:
            if not (np.isfinite(frag.lat) and np.isfinite(frag.lon)
                    and np.isfinite(frag.alt)):
                return False
            if abs(frag.lat) > 90.0 or abs(frag.lon) > 180.0:
                return False
            if not (-1000.0 < frag.alt < 60000.0):
                return False
        if frag.fields & Fields.SPEED:
            if frag.speed > 200.0 or abs(frag.climb) > 150.0:
                return False
        if frag.fields & Fields.PTU and np.isfinite(frag.temp):
            if not (-120.0 < frag.temp < 80.0):
                return False
        return True

    def _parse(self, f: np.ndarray) -> TelemetryFragment:
        frag = TelemetryFragment()
        ve, vn, vu = struct.unpack(">hhh", f[0x04:0x0A].tobytes())
        tow_ms, = struct.unpack(">I", f[0x0A:0x0E].tobytes())
        lat, lon, alt_mm = struct.unpack(">iii", f[0x0E:0x1A].tobytes())
        week, = struct.unpack(">H", f[0x20:0x22].tobytes())
        frag.time = float(geo.gps_time_to_utc(week, tow_ms / 1000.0))
        frag.fields |= Fields.TIME
        frag.seq = int(tow_ms // 1000) & 0xFFFF      # no explicit counter
        frag.fields |= Fields.SEQ
        if not (lat == 0 and lon == 0):
            frag.lat, frag.lon, frag.alt = lat * 1e-6, lon * 1e-6, alt_mm / 1000.0
            spd, hdg, climb = geo.speed_heading_climb(ve / 100.0, vn / 100.0,
                                                      vu / 100.0)
            frag.speed, frag.heading, frag.climb = float(spd), float(hdg), float(climb)
            frag.fields |= Fields.POS | Fields.SPEED
        adc, = struct.unpack(">H", f[0x49:0x4B].tobytes())
        frag.temp = ntc_temp(adc)
        rh_ref = int.from_bytes(f[0x32:0x35].tobytes(), "big")
        rh_cnt = int.from_bytes(f[0x35:0x38].tobytes(), "big")
        frag.rh = m10_rh(rh_cnt, rh_ref)      # M10 carries RH (README.md:11)
        frag.pressure = 0.0
        frag.calib_percent = 100.0            # no calibration accumulation
        frag.fields |= Fields.PTU
        serial = m10_serial(f[0x5D:0x62])
        frag.serial = serial
        frag.fields |= Fields.SERIAL
        return frag

    def _parse_m20(self, f: np.ndarray, full: bool) -> TelemetryFragment:
        """M20 public layout (docstring above; PROTOCOLS.md 'm10').

        full=False means only the inner 0x02..0x15 block verified."""
        frag = TelemetryFragment()
        frag.seq = int(f[0x15])
        frag.fields |= Fields.SEQ
        alt_cm = int.from_bytes(f[0x08:0x0B].tobytes(), "big")
        tow_s = int.from_bytes(f[0x0F:0x12].tobytes(), "big")
        adc, = struct.unpack(">H", f[0x02:0x04].tobytes())
        frag.temp = ntc_temp(adc)
        frag.rh = float("nan")                # no RH on M20 (README.md:13)
        frag.pressure = 0.0
        frag.calib_percent = 100.0
        frag.fields |= Fields.PTU
        frag.serial = m20_serial(f[0x12:0x15])
        frag.fields |= Fields.SERIAL
        if not full:
            # week/lat/lon/velocity live outside the verified inner block;
            # the salvage delivers seq + PTU + serial only (alt alone has no
            # POS flag to ride on)
            return frag
        week, = struct.unpack(">H", f[0x26:0x28].tobytes())
        frag.time = float(geo.gps_time_to_utc(week, float(tow_s)))
        frag.fields |= Fields.TIME
        ve, vn = struct.unpack(">hh", f[0x18:0x1C].tobytes())
        lat, lon = struct.unpack(">ii", f[0x1C:0x24].tobytes())
        vu, = struct.unpack(">h", f[0x24:0x26].tobytes())
        if not (lat == 0 and lon == 0):
            frag.lat, frag.lon, frag.alt = lat * 1e-6, lon * 1e-6, alt_cm / 100.0
            spd, hdg, climb = geo.speed_heading_climb(ve / 100.0, vn / 100.0,
                                                      vu / 100.0)
            frag.speed, frag.heading, frag.climb = float(spd), float(hdg), float(climb)
            frag.fields |= Fields.POS | Fields.SPEED
        return frag


class M10Truth:
    def __init__(self, serial="910-2-12345", frame_no=1, lat=52.2, lon=21.0,
                 alt=15000.0, ve=-4.0, vn=9.0, vu=5.0, temp=-55.0, rh=12.0,
                 time_utc=1.7e9, m20=False):
        self.serial, self.frame_no = serial, frame_no
        self.lat, self.lon, self.alt = lat, lon, alt
        self.ve, self.vn, self.vu = ve, vn, vu
        self.temp, self.rh, self.time_utc = temp, rh, time_utc
        self.m20 = m20

    @property
    def time_eff(self):
        """Frames are distinguished by GPS time (M10 has no frame counter)."""
        return self.time_utc + float(self.frame_no)


def _serial_bytes(serial: str) -> np.ndarray:
    """Inverse of m10_serial for the modulator ("XNN-T-NNNNN")."""
    a, t, num = serial.split("-")
    b = np.zeros(5, np.uint8)
    b[0] = (int(a[0], 16) << 4) | int(a[1:])
    b[1] = int(t) & 0xF
    n = int(num)
    b[2], b[3], b[4] = (n >> 16) & 0xFF, (n >> 8) & 0xFF, n & 0xFF
    return b


def _m20_serial_bytes(serial: str) -> np.ndarray:
    """Inverse of m20_serial ("XNN-NNNNN" with X a hex digit and NN <= 15;
    tolerates the 3-part M10 form by dropping the middle group). Rejects
    out-of-range groups rather than silently corrupting the round trip."""
    parts = serial.split("-")
    a, num = parts[0], int(parts[-1]) & 0xFFFF
    grp = int(a[1:])
    if not 0 <= grp <= 15:
        raise ValueError(f"M20 serial group {grp} exceeds the 4-bit field "
                         f"of the printed form ({serial!r})")
    b = np.zeros(3, np.uint8)
    b[0] = (int(a[0], 16) << 4) | grp
    b[1], b[2] = (num >> 8) & 0xFF, num & 0xFF
    return b


class M10Modulator:
    spec = SPEC

    def build_frame(self, t: M10Truth) -> np.ndarray:
        """On-air window image: [0xAA 0xAA][frame], zero-padded to the
        gather width so back-to-back frames keep fixed chip spacing."""
        w = np.zeros(FRAME_BYTES, dtype=np.uint8)
        w[0:2] = (0xAA, 0xAA)
        f = w[2:]
        week, tow = geo.utc_to_gps_time(t.time_eff)
        if t.m20:
            f[0], f[1] = 0x45, 0x20
            f[0x02:0x04] = np.frombuffer(struct.pack(
                ">H", ntc_adc(t.temp)), np.uint8)
            f[0x08:0x0B] = np.frombuffer(int(round(t.alt * 100)).to_bytes(
                3, "big"), np.uint8)
            f[0x0F:0x12] = np.frombuffer(int(round(tow)).to_bytes(
                3, "big"), np.uint8)
            f[0x12:0x15] = _m20_serial_bytes(t.serial)
            f[0x15] = t.frame_no & 0xFF
            f[0x16:0x18] = np.frombuffer(struct.pack(
                ">H", m10_checksum(f[0x02:0x16])), np.uint8)
            f[0x18:0x1C] = np.frombuffer(struct.pack(
                ">hh", int(round(t.ve * 100)), int(round(t.vn * 100))), np.uint8)
            f[0x1C:0x24] = np.frombuffer(struct.pack(
                ">ii", int(round(t.lat * 1e6)), int(round(t.lon * 1e6))), np.uint8)
            f[0x24:0x26] = np.frombuffer(struct.pack(
                ">h", int(round(t.vu * 100))), np.uint8)
            f[0x26:0x28] = np.frombuffer(struct.pack(">H", int(week)), np.uint8)
            f[0x44:0x46] = np.frombuffer(struct.pack(
                ">H", m10_checksum(f[0:0x44])), np.uint8)
            return w
        f[0], f[1], f[2] = 0x64, 0x9F, 0x20
        f[0x04:0x0A] = np.frombuffer(struct.pack(
            ">hhh", int(round(t.ve * 100)), int(round(t.vn * 100)),
            int(round(t.vu * 100))), np.uint8)
        f[0x0A:0x0E] = np.frombuffer(struct.pack(
            ">I", int(round(tow * 1000))), np.uint8)
        f[0x0E:0x1A] = np.frombuffer(struct.pack(
            ">iii", int(round(t.lat * 1e6)), int(round(t.lon * 1e6)),
            int(round(t.alt * 1000))), np.uint8)
        f[0x20:0x22] = np.frombuffer(struct.pack(">H", int(week)), np.uint8)
        rh_cnt, rh_ref = m10_rh_counts(t.rh)
        f[0x32:0x35] = np.frombuffer(rh_ref.to_bytes(3, "big"), np.uint8)
        f[0x35:0x38] = np.frombuffer(rh_cnt.to_bytes(3, "big"), np.uint8)
        f[0x49:0x4B] = np.frombuffer(struct.pack(
            ">H", ntc_adc(t.temp)), np.uint8)
        f[0x5D:0x62] = _serial_bytes(t.serial)
        f[0x63:0x65] = np.frombuffer(struct.pack(
            ">H", m10_checksum(f[0:0x63])), np.uint8)
        return w

    def frames_to_chips(self, frames: np.ndarray) -> np.ndarray:
        """Biphase-mark encode (continuous level across the whole stream)."""
        bits = np_bytes_to_bits(np.atleast_2d(frames), lsb_first=False).reshape(-1)
        chips = np.empty(bits.size * 2, dtype=np.uint8)
        level = 0
        for k, b in enumerate(bits):
            level ^= 1
            chips[2 * k] = level
            if b:
                level ^= 1
            chips[2 * k + 1] = level
        return chips

    def modulate(self, truths: List[M10Truth], fs: float = 48000.0,
                 bt: float = 0.7) -> np.ndarray:
        frames = np.stack([self.build_frame(t) for t in truths])
        chips = self.frames_to_chips(frames)
        return gfsk_modulate(chips, fs / CHIP_RATE, SPEC.dev / fs, bt=bt)


register_sonde("m10", SPEC, M10Decoder, M10Modulator)
