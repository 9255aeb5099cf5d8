"""The per-block decoding pipeline (counterpart:
``sondetpu/runtime/pipeline.py``).

``PipelineConfig`` and ``unpack_block_output`` are copies of the originals
(the original module imports jax), so one config drives both packages and
the wire layout agrees by construction; the copy refuses what the original
refuses (bf16 with AFSK, or with use_pallas outside the dual-tone
families). ``Pipeline`` is the torch form of the original's step for every
config the original accepts, on the front end that the original's gates
pick (``_route``):

- ``use_pallas=True`` where the gates hold (channels a multiple of 8, a
  block of at least HALO samples, the taps inside the carried tail), the
  kernel path (in the port: the Hopper kernels): rs41/rs41x/dfm on the
  fused front end; the dual-tone families (m10, ims100, mrzn1) on the
  fused dual-tone front end (ims100 and mrzn1 keep its channel filter);
  imet4/c50 on the fused front end at decim 1 with an identity matched
  filter, then the AFSK tone kernel. A dual-tone family whose dual-tone
  gates fail falls back to the FM discriminator with the original's
  warning: m10 on the fused front end, ims100 and mrzn1 on the plain-op
  front end, since the fused one has no midpoint DC. The kernels read the
  sample-rate planes in the compute dtype (bfloat16 on a bf16 dual-tone
  config) and compute in float32.
- Every other config, the plain-op path, in float32 or bfloat16: the
  original's jnp branch, which runs no kernel: the channel filter, then the
  ``atan2`` discriminator and matched FIR, or for the dual-tone families
  the +/-dev mix, the one-chip boxcar and the envelope metric, or for the
  AFSK families the discriminator and the jnp mark/space front end with its
  carried tails and LO phase counter; the block DC; the plain correlation
  and the GF(2) matmul RS flag.

The sample-rate arrays are stored in the compute dtype where the original
casts them. The block DC is the block mean, or for the unwhitened NRZ
families (``dc_mode == "midpoint"``: ims100, mrzn1) the midpoint of the
10th and 90th percentiles, ``midpoint_dc``, equal to ``jnp.quantile``'s bit
for bit.

On every path, ``fine_offsets`` or ``afc`` put the per-channel DDC (plain
torch ops, the original's float32 formula) between the dequant and the
front end; with ``afc`` its frequency is state, nudged each block by the
front end's block DC (the dual-tone envelope-rotation angle on that
family's path).

Both go on through Oerder-Meyr timing, symbol sampling (integer sps,
rational sps in whole segments, or ``linear_interp`` for any other), the
chip ring, syncword correlation (the correlator kernel on the fused front
end's path; the plain correlation on the other paths, as in the original),
peak pick, then either the NRZ byte pack and frame gather, or the frame
gather with Manchester/biphase-M decoding and the Chase weak bits, then
de-whitening, RS syndrome flag, and the flat packed buffer. With
``profile_stop`` the step returns the original's checksum scalar of the
named stage instead. Each of these stages runs inside a span of the same
name (``sondetpu.ingest``, ``.ddc``, ``.frontend``, ``.afc``, ``.timing``,
``.sample``, ``.ring``, ``.corr``, ``.peaks``, ``.gather``, ``.syndrome``,
``.pack``; ``runtime.metrics.span``), and ``step`` inside
``sondetpu.step``: ranges of a running ``torch.profiler`` session, no-ops
otherwise.

Carry-over state is an explicit tuple of tensors with the original's field
names and dtypes; ``state_from_numpy``/``state_to_numpy`` move it between
the two packages.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from fractions import Fraction
from typing import NamedTuple, Optional

import numpy as np
import torch

from sondetpu_torch.dsp.fir import FIRState, apply_windows, design_lowpass
from sondetpu_torch.fec.syndrome import rs_clean_flags
from sondetpu_torch.io.iq import c64_to_planes
from sondetpu_torch.kernels.afsk import afsk_tables, fused_afsk_frontend
from sondetpu_torch.kernels.corr import corr_kernel
from sondetpu_torch.kernels.dualtone import (fused_dualtone_frontend,
                                             mixer_tables)
from sondetpu_torch.kernels.frontend import HALO, fused_frontend
from sondetpu_torch.kernels.syndrome import rs_clean_flags_kernel
from sondetpu_torch.runtime.metrics import span
from sondetpu_torch.sondes.base import get_sonde
from sondetpu_torch.sync.coding import biphase_m_decode, manchester_decode
from sondetpu_torch.sync.correlator import (correlate_syncword,
                                            find_frame_starts, gather_frames)
from sondetpu_torch.sync.timing import (TimingState, linear_interp,
                                        oerder_meyr_tau,
                                        spectral_line_tables)

@dataclass(frozen=True)
class PipelineConfig:
    """Static compile-time parameters of a per-type chain."""

    sonde: str = "rs41"
    channels: int = 8
    fs: float = 48000.0            # channel IQ sample rate
    block_len: int = 48000         # IQ samples per step (1 s)
    max_frames: Optional[int] = None  # frame slots per channel per block;
                                   # None = auto (just enough for the block)
    sync_threshold: float = 0.6    # normalized correlation acceptance
    ntaps: int = 41                # matched/lowpass filter taps
    dc_block: bool = True          # remove residual carrier offset per block
    use_pallas: bool = False       # fused Pallas kernels for demod+FIR, corr
    # per-channel fine frequency offsets (Hz), length == channels: digital
    # downconversion below the PFB grid — the analogue of the reference
    # VFO's free tuning with 1 kHz snap (main.cpp:56). None = all on-grid.
    fine_offsets: Optional[tuple] = None
    # automatic frequency control: the DDC frequency becomes per-channel
    # STATE, nudged each block by the FM discriminator's DC (mean audio of
    # 1.0 == spec.dev Hz of residual carrier offset). Tracks transmitter
    # drift the reference handles by the human re-dragging the VFO on the
    # waterfall (main.cpp:55-56). fine_offsets (or zeros) seed the loop.
    afc: bool = False
    afc_beta: float = 0.5          # per-block loop gain (0 < beta <= 1)
    afc_max_hz: Optional[float] = None   # clamp; default spec.bandwidth/2
    # input plane dtype: "f32" (default), or "i16"/"i8" — raw SDR sample
    # planes (cs16/cs8 sources) upload as integers and dequantize ON DEVICE,
    # cutting host->device transfer 2x/4x (the reference converts to float
    # on the host because its DSP chain is host-side; ours isn't)
    input_dtype: str = "f32"
    # on-device storage dtype for the sample-rate arrays (IQ planes,
    # filtered audio, soft chips): "bf16" halves the HBM traffic of the
    # memory-bound convs; every reduction/accumulation (conv accumulators,
    # timing estimate, correlation) stays float32. bf16's ~0.4% relative
    # quantization sits ~40 dB under the signal — far below the noise at
    # any decodable SNR (FER tests assert parity). GFSK/FSK families only.
    compute_dtype: str = "f32"
    # profiling ablation: truncate the compiled step after the named stage
    # ("chanfilt"|"demod"|"timing"|"sample"|"corr"|"peaks"|"gather"|
    # "syndrome") and return only a checksum scalar. Stage-by-stage timing
    # differences give per-stage device cost (tools/profile_stages.py).
    profile_stop: Optional[str] = None

    def __post_init__(self):
        if self.input_dtype not in ("f32", "i16", "i8"):
            raise ValueError(f"input_dtype {self.input_dtype!r}")
        if self.ntaps % 2 == 0:
            raise ValueError("ntaps must be odd (carry widths derive "
                             "from it)")
        if self.compute_dtype not in ("f32", "bf16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        spec = get_sonde(self.sonde)["spec"]
        if self.compute_dtype == "bf16" and (
                spec.modulation == "afsk"
                or (self.use_pallas
                    and not spec.extra.get("fsk_dualtone"))):
            # bf16 + Pallas coexist ONLY on the dual-tone path (its kernel
            # loads any dtype and computes f32; chipbuf/corr downstream
            # then ride bf16); the NRZ/AFSK kernels remain f32-only
            raise ValueError("bf16 compute supports the jnp GFSK/FSK "
                             "path and the dual-tone kernel path only")
        # afc + use_pallas COEXIST since r5: the fused kernels export the
        # discriminator DC (NRZ) / envelope-rotation sums (dual-tone) the
        # AFC loop feeds on
        # AFSK families track carrier drift with the SAME discriminator-DC
        # loop: the Bell-202 audio is a pair of (near) zero-mean tones, so
        # the block mean of the discriminator output measures carrier
        # offset with only a small partial-cycle data residue (the space
        # tone's 1.83 cycles/symbol truncation) — bounded well below the
        # loop's clamp and averaged down over the block. Verified by the
        # drifting-iMet-4 test (tests/test_afc.py).
        sps = self.fs / spec.baud
        if abs(self.block_len / sps - round(self.block_len / sps)) > 1e-9:
            raise ValueError("block_len must be an integer number of symbols")

    @property
    def spec(self):
        return get_sonde(self.sonde)["spec"]

    @property
    def decim(self) -> int:
        """Decimation fused into the pre-demod channel filter.

        Narrowband types (channel bandwidth well below the half-rate
        Nyquist and >= 4 samples/symbol after decimation) process the
        demod/timing/slicing chain at fs/2 — the channel filter's strided
        conv halves every downstream stage's cost. AFSK needs the full
        audio bandwidth for its tones, so it stays at fs.
        """
        spec = self.spec
        if (spec.modulation != "afsk"
                and self.fs / 2.0 >= 2.2 * spec.bandwidth
                and (self.fs / 2.0) / spec.baud >= 4.0
                and self.block_len % 2 == 0):
            return 2
        return 1

    @property
    def fs_proc(self) -> float:
        return self.fs / self.decim

    @property
    def sps(self) -> float:
        return self.fs_proc / self.spec.baud

    @property
    def chips_per_block(self) -> int:
        return int(round(self.block_len / self.decim / self.sps))

    @property
    def chip_cap(self) -> int:
        # block_len is an integer number of symbols and the NCO phase stays
        # in [0, sps), so every block emits EXACTLY chips_per_block chips —
        # which makes the ring-buffer shift a static slice (no gather)
        return self.chips_per_block

    @property
    def frame_chips(self) -> int:
        return self.spec.chips_per_frame

    @property
    def min_frame_chips(self) -> int:
        """Smallest on-air unit the sync can legitimately repeat at. For
        most families this is the frame itself; packetized protocols whose
        gather window is wider than the shortest packet (iMet-4) declare
        extra['min_frame_chips'] so slot capacity and the peak-suppression
        distance track real packet spacing."""
        return int(self.spec.extra.get("min_frame_chips", self.frame_chips))

    @property
    def k_slots(self) -> int:
        """Frame slots per channel per block. Frames are deduped on "end
        lies in this block's new chips", so at most ceil(cpb/min_frame_chips)
        can complete per block; +1 margin for sync jitter. Sizing the slots
        to the block keeps the (RTT-dominated) host readback minimal."""
        if self.max_frames is not None:
            return self.max_frames
        return int(np.ceil(self.chips_per_block / self.min_frame_chips)) + 1

    @property
    def buf_len(self) -> int:
        # ring holds one full frame of history plus a block of new chips
        return self.frame_chips + self.chip_cap

    @property
    def wire_columns(self):
        """Byte columns of each frame that cross the device->host wire in
        the packed buffer (None = whole frame). Specs that define
        extra['wire_columns'] (the offsets their host parser reads) cut the
        readback ~2.6x; full frames for host FEC of RS-suspect rows are
        fetched separately via fetch_frames()."""
        return self.spec.extra.get("wire_columns")

    @property
    def wire_ncols(self) -> int:
        cols = self.wire_columns
        return self.spec.frame_bytes if cols is None else len(cols)

    @property
    def chase_m(self) -> int:
        """Soft-decision assist for checksum-only families (spec
        extra['chase_m']): the device ranks every decoded bit's reliability
        (min |soft chip| of its line-code pair) and ships the M weakest bit
        indices per frame; the host flips single/pair combinations of them
        when the checksum fails (a Chase-2 style repair). 0 = off."""
        return int(self.spec.extra.get("chase_m", 0))

    @property
    def chase_spans(self) -> tuple:
        """Bit ranges the weakest-bit ranking runs over — one top-M list
        per span. Multi-subtype windows declare extra['chase_spans'] so a
        SHORT subtype (M20 inside the M10-sized window) gets candidates
        inside ITS checksum span rather than in the noise tail beyond its
        frame; the host chases over the union of all lists."""
        if not self.chase_m:
            return ()
        spans = self.spec.extra.get("chase_spans")
        if spans is None:
            return ((0, self.spec.frame_bytes * 8),)
        return tuple(tuple(s) for s in spans)

    @property
    def chase_total(self) -> int:
        """Weak indices per frame on the wire: M per span."""
        return self.chase_m * len(self.chase_spans)

    @property
    def packed_row_bytes(self) -> int:
        """Per-channel width of the flat packed readback buffer."""
        k = self.k_slots
        return k * self.wire_ncols + 2 * k + 4 + 2 * k * self.chase_total


class PipelineState(NamedTuple):
    # the original's field names and layout, as tensors on one device; the
    # plain path stores the sample-rate fields in the compute dtype
    chan_tail_i: torch.Tensor  # [C, HALO] raw input carry (I); the plain
                               # path's [C, ntaps-1]
    chan_tail_q: torch.Tensor  # the same for Q
    fm_prev: torch.Tensor      # [C, 2]: the plain path's last filtered
                               # sample; carried, unused on the kernel path
    fir: FIRState              # [C, ntaps-1] audio tail of the plain path;
                               # carried, unused on the kernel path too
    timing: TimingState
    chipbuf: torch.Tensor      # [C, buf_len] soft chips (zeros before lock)
    buf_fill: torch.Tensor     # [C] int32, how many chips in buffer are real
    aux: tuple = ()


class BlockOutput(NamedTuple):
    frames: torch.Tensor       # [C, K, frame_bytes] uint8 descrambled bytes
    frame_valid: torch.Tensor  # [C, K] bool
    frame_score: torch.Tensor  # [C, K] float32 sync correlation
    soft_rms: torch.Tensor     # [C] float32 chip-level signal quality
    rs_clean: torch.Tensor     # [C, K] bool: frame's RS syndromes all zero
    packed: torch.Tensor       # flat uint8: wire columns, valid, rs_clean,
                               # soft_rms (see unpack_block_output)


def unpack_block_output(packed: np.ndarray, k_slots: int, frame_bytes: int,
                        chase_m: int = 0):
    """Split a host copy of BlockOutput.packed into (frames [C, K, fb] uint8,
    valid [C, K] bool, rs_clean [C, K] bool, soft_rms [C] float32[,
    weak_bits [C, K, M] int]).

    ``frame_bytes`` is the per-frame wire width: config.wire_ncols (== the
    full spec.frame_bytes unless the spec defines compact wire_columns);
    ``chase_m`` adds the per-frame weakest-bit indices (config.chase_m)."""
    row = k_slots * frame_bytes + 2 * k_slots + 4 + 2 * k_slots * chase_m
    c = packed.size // row
    packed = packed.reshape(c, row)
    fbk = k_slots * frame_bytes
    frames = packed[:, :fbk].reshape(c, k_slots, frame_bytes)
    valid = packed[:, fbk:fbk + k_slots].astype(bool)
    rs_clean = packed[:, fbk + k_slots: fbk + 2 * k_slots].astype(bool)
    off = fbk + 2 * k_slots
    soft_rms = np.ascontiguousarray(packed[:, off:off + 4]
                                    ).view(np.float32)[:, 0]
    if not chase_m:
        return frames, valid, rs_clean, soft_rms
    wb = np.ascontiguousarray(packed[:, off + 4:]).view(np.uint16)
    weak = wb.reshape(c, k_slots, chase_m).astype(np.int64)
    return frames, valid, rs_clean, soft_rms, weak


def _map_state(state, fn):
    return PipelineState(
        chan_tail_i=fn(state.chan_tail_i), chan_tail_q=fn(state.chan_tail_q),
        fm_prev=fn(state.fm_prev), fir=FIRState(tail=fn(state.fir.tail)),
        timing=TimingState(pos=fn(state.timing.pos),
                           locked=fn(state.timing.locked)),
        chipbuf=fn(state.chipbuf), buf_fill=fn(state.buf_fill),
        aux=tuple(fn(a) for a in state.aux))


class BFloat16Words(NamedTuple):
    """A bfloat16 array held as its 16-bit words (an int16 NumPy array): a
    host copy of a bfloat16 leaf that needs no NumPy bfloat16 type, which
    only ml_dtypes provides (runtime/checkpoint.py stores bf16 leaves so)."""

    words: np.ndarray


def _leaf_from_numpy(x, dev) -> torch.Tensor:
    if isinstance(x, BFloat16Words):
        return torch.from_numpy(np.array(x.words, np.int16)).view(
            torch.bfloat16).to(dev)
    a = np.array(np.asarray(x))
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (the JAX package's) holds the same 16 bits as
        # torch.bfloat16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError("state_to_numpy: a bfloat16 leaf needs NumPy's "
                        "bfloat16 type, which ml_dtypes registers when the "
                        "caller has loaded it (the JAX package does)") from None
    return t.view(torch.int16).numpy().view(bf16)


def state_from_numpy(jax_state, device) -> PipelineState:
    """The JAX package's PipelineState (or any tuple with its field layout)
    -> the port's state on ``device``; every leaf goes through
    ``np.asarray``, a bfloat16 leaf (an ml_dtypes array, or
    ``BFloat16Words``) bit for bit to torch.bfloat16."""
    dev = torch.device(device)
    return _map_state(jax_state, lambda x: _leaf_from_numpy(x, dev))


def state_to_numpy(state: PipelineState) -> PipelineState:
    """The port's state -> the same field layout with NumPy leaves; a
    bfloat16 leaf becomes a NumPy bfloat16 array with the same bits."""
    return _map_state(state, _leaf_to_numpy)


def _channel_rows(t: torch.Tensor, channels: int, lo: int, hi: int):
    """Rows of channels [lo, hi) of a per-channel leaf of ``channels``
    channels: [k * C, ...] holds k planes of C rows, plane-major (the
    dual-tone FIR tail's four mixed planes: row p * C + c), so a channel's
    rows are p * C + c for every plane p."""
    k = t.shape[0] // channels
    return t.reshape(k, channels, *t.shape[1:])[:, lo:hi].reshape(
        k * (hi - lo), *t.shape[1:])


def _state_leaves(state: PipelineState) -> list:
    """The leaves in _map_state's order."""
    return [state.chan_tail_i, state.chan_tail_q, state.fm_prev,
            state.fir.tail, state.timing.pos, state.timing.locked,
            state.chipbuf, state.buf_fill, *state.aux]


def _from_leaves(template: PipelineState, leaves: list) -> PipelineState:
    """A state of ``template``'s layout with ``leaves`` (in _state_leaves'
    order)."""
    it = iter(leaves)
    return _map_state(template, lambda _: next(it))


def _shared(j: int, leaf: torch.Tensor) -> bool:
    """Whether leaf j is the same for every channel: an aux leaf of an
    integer type (the jnp AFSK front end's [1] LO phase counter). Every
    other leaf is per channel."""
    return j >= 8 and not leaf.is_floating_point()


def shard_state(state: PipelineState, lo: int, hi: int,
                device=None) -> PipelineState:
    """The state of channels [lo, hi) of ``state``, as copies on ``device``
    (default: the state's); a shared leaf (:func:`_shared`) goes to every
    shard whole."""
    c = state.timing.pos.shape[0]
    dev = device if device is not None else state.timing.pos.device
    return _from_leaves(state, [
        (t if _shared(j, t) else _channel_rows(t, c, lo, hi)).to(
            dev, copy=True)
        for j, t in enumerate(_state_leaves(state))])


def merge_state(parts, device=None) -> PipelineState:
    """The state of the channels of ``parts`` (states of consecutive
    channel slabs, in order) as one state on ``device`` (default: the first
    part's): :func:`shard_state` undone. A shared leaf comes from the first
    part."""
    parts = list(parts)
    dev = torch.device(device) if device is not None else \
        parts[0].timing.pos.device
    counts = [p.timing.pos.shape[0] for p in parts]
    per_part = [_state_leaves(p) for p in parts]
    merged = []
    for j, first in enumerate(per_part[0]):
        if _shared(j, first):
            merged.append(first.to(dev))
            continue
        k = first.shape[0] // counts[0]
        merged.append(torch.cat(
            [ls[j].to(dev).reshape(k, n, *first.shape[1:])
             for ls, n in zip(per_part, counts)], dim=1).reshape(
                 k * sum(counts), *first.shape[1:]))
    return _from_leaves(parts[0], merged)


def _dualtone_gates(c):
    """(dualtone, skip_chanfilt): the original's gates for the noncoherent
    dual-tone front end and for skipping its channel filter
    (``sondetpu/runtime/pipeline.py:331-339, 366-367``)."""
    spec = c.spec
    n_proc = c.block_len // c.decim
    turns = spec.dev * n_proc / c.fs_proc
    dualtone = (spec.modulation in ("gfsk", "fsk")
                and bool(spec.extra.get("fsk_dualtone"))
                and abs(turns - round(turns)) < 1e-6
                and 2 <= round(c.sps) <= c.ntaps)
    return dualtone, dualtone and spec.bandwidth / 2.0 >= 0.45 * c.fs_proc


def _afsk_params(c):
    """(win, L) of an AFSK family: the one-symbol boxcar width and the
    joint period in samples of its mark and space tones
    (``sondetpu/runtime/pipeline.py:369-379``)."""
    spec = c.spec
    win = max(int(c.fs / spec.baud), 2)
    L = int(np.lcm(
        Fraction(spec.afsk_mark / c.fs).limit_denominator(1 << 20).denominator,
        Fraction(spec.afsk_space / c.fs).limit_denominator(1 << 20)
        .denominator))
    return win, L


def _rational_sps(c):
    """(p, q) with sps = p/q, q <= 16, when the block splits into whole
    p-sample segments of q chips each (the segmented sampling of the
    original); None otherwise."""
    fr = Fraction(c.sps).limit_denominator(16)
    p, q = fr.numerator, fr.denominator
    cpb = c.chips_per_block
    if (abs(float(fr) - float(c.sps)) < 1e-9 and q > 1 and cpb % q == 0
            and c.block_len // c.decim == (cpb // q) * p):
        return p, q
    return None


def _route(c):
    """The front end that the original's gates pick for ``c``
    (``sondetpu/runtime/pipeline.py:380-417``): "afsk" (K1, then K8),
    "dualtone" (K7) or "fused" (K1) on the kernel path, or None for the
    jnp path, which the plain-op front end ports. Every kernel route needs
    use_pallas, channels % 8 == 0 and a block of at least HALO samples (the
    original's ``frontend_chunk`` is None only below HALO); then AFSK needs
    2 * ntaps - 1 <= HALO, win - 1 <= HALO and the tones' joint period L
    to divide the block; a dual-tone family on its gates needs decim 1 and
    the boxcar inside the carried tail; any other family
    decim * ntaps + ntaps - 1 <= HALO and mean DC (the fused front end
    implements no midpoint DC). A dual-tone family off its gates takes the
    FM discriminator, on K1 where its gates hold."""
    if not c.use_pallas or c.channels % 8 or c.block_len < HALO:
        return None
    if c.spec.modulation == "afsk":
        win, L = _afsk_params(c)
        ok = (2 * c.ntaps - 1 <= HALO and win - 1 <= HALO
              and c.block_len % L == 0)
        return "afsk" if ok else None
    if _dualtone_gates(c)[0]:
        nb = max(2, round(c.sps))
        return ("dualtone" if c.decim == 1 and nb + c.ntaps - 1 <= HALO
                else None)
    if (c.decim * c.ntaps + c.ntaps - 1 > HALO
            or c.spec.extra.get("dc_mode") == "midpoint"):
        return None
    return "fused"


def _fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """fl32(a * b + c) rounded once, for float32 ``a``, ``c`` and a float32
    value ``b``: the fused multiply-add that XLA on the CPU makes of
    ``jnp.quantile``'s ``lo * (1 - w) + hi * w``. In float64 the product is
    exact; the sum is taken with its rounding error (TwoSum) and rounded to
    odd, so that the final rounding to float32 is the single one."""
    f64 = torch.float64
    x = a.to(f64) * b
    y = c.to(f64)
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def midpoint_dc(x: torch.Tensor) -> torch.Tensor:
    """Per-row midpoint ``0.5 * (q10 + q90)`` of ``x`` [C, n] in x's dtype:
    the original's ``0.5 * (jnp.quantile(x, 0.10, axis=-1) +
    jnp.quantile(x, 0.90, axis=-1))`` bit for bit (midpoint DC,
    ``sondetpu/runtime/pipeline.py:715-718, 881-889``).

    As ``jnp.quantile`` computes it: the position q * (n - 1) in float32
    (0.1 and 0.9 rounded to float32 first) sets the order statistics at its
    floor and ceil and the weight w of the upper one; the quantile is
    ``lo * (1 - w) + hi * w`` in float32, the first product fused into the
    sum as XLA on the CPU fuses it, cast back to x's dtype; the midpoint is
    formed in x's dtype. A row holding a NaN gives NaN. The order
    statistics come from ``torch.kthvalue`` (exact, whatever the method of
    selection); ``torch.quantile`` refuses rows of more than 2**24
    elements in all and interpolates with lerp."""
    n = x.shape[-1]
    f32 = torch.float32
    stats = {}

    def order_stat(k):
        if k not in stats:
            stats[k] = torch.kthvalue(x, k + 1, dim=-1).values.to(f32)
        return stats[k]

    qs = []
    for q in (np.float32(0.1), np.float32(0.9)):
        pos = np.float32(q * np.float32(n - 1))
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        w = np.float32(pos - np.floor(pos))
        hw = order_stat(hi) * torch.tensor(w, dtype=f32, device=x.device)
        qs.append(_fma_f32(order_stat(lo), float(np.float32(1.0) - w),
                           hw).to(x.dtype))
    mid = (qs[0] + qs[1]) * 0.5
    return torch.where(torch.isnan(x).any(dim=-1),
                       torch.full_like(mid, float("nan")), mid)


def _int32_sum(x: torch.Tensor) -> torch.Tensor:
    """jnp.sum of an int32, bool or uint8 array as the original's
    profile_stop takes it (``frames.astype(int32)`` for the bytes): an
    int32 scalar."""
    return torch.sum(x.to(torch.int32), dtype=torch.int32)


class Pipeline:
    """Per-block decoder front end for one sonde type, on ``device``."""

    def __init__(self, config: PipelineConfig, device,
                 shard_of: Optional[PipelineConfig] = None):
        """``shard_of``: the global config of which ``config`` is a slab of
        channels (a mesh shard); the shard takes the global config's route,
        so that it computes what the global step computes on its rows
        (the kernels take any row count, the gates' channels % 8 is the
        global step's)."""
        self.config = config
        self.device = torch.device(device)
        c = config
        spec = config.spec
        dev = self.device
        # the same taps, template and syndrome layout as the original,
        # made by the same NumPy code
        self._taps = design_lowpass(0.55 * spec.baud, c.fs_proc, c.ntaps)
        self._chan_taps = design_lowpass(
            min(spec.bandwidth / 2.0, 0.45 * c.fs_proc), c.fs, c.ntaps)
        self._template = spec.sync_chip_template()
        templates = [self._template]
        alt = spec.extra.get("alt_syncword")
        if alt:
            templates.append(spec.sync_chip_template(alt))
        for b in spec.extra.get("alt_sync_bits", ()):
            templates.append(spec.sync_chip_template(bits=np.asarray(b)))
        # host arrays: the correlator kernel takes its taps from the host
        self._np_templates = [np.asarray(t, np.float32) for t in templates]
        self._dualtone, self._skip_chanfilt = _dualtone_gates(c)
        if (spec.extra.get("fsk_dualtone") and not self._dualtone
                and spec.modulation in ("gfsk", "fsk")):
            # the original's warning, word for word
            # (sondetpu/runtime/pipeline.py:340-356)
            turns = spec.dev * (c.block_len // c.decim) / c.fs_proc
            why = ("dev*block/fs_proc=%g not integer (mixer would lose "
                   "phase continuity)" % turns
                   if abs(turns - round(turns)) >= 1e-6 else
                   "sps=%g outside [2, ntaps=%d]" % (c.sps, c.ntaps))
            warnings.warn(
                f"{c.sonde}: fsk_dualtone requested but unavailable for "
                f"this config ({why}); falling back to the FM "
                f"discriminator (worse low-SNR FER)", stacklevel=3)
        self._afsk = spec.modulation == "afsk"
        self._midpoint = spec.extra.get("dc_mode") == "midpoint"
        self._route = _route(shard_of if shard_of is not None else c)
        self._plain = self._route is None
        # the sample-rate arrays are stored in this dtype from the
        # original's cast after the dequant and the DDC on
        self._cdt = (torch.bfloat16 if c.compute_dtype == "bf16"
                     else torch.float32)
        if self._afsk:
            self._afsk_win, self._afsk_L = _afsk_params(c)
        if self._route == "afsk":
            # stage 1 is the fused front end with an identity matched
            # filter; stage 2 mixes by the host f64 mark/space tables
            self._delta = np.zeros(c.ntaps, np.float32)
            self._delta[-1] = 1.0
            self._afsk_tabs = tuple(torch.from_numpy(t).to(dev)
                                    for t in afsk_tables(
                                        c.block_len, spec.afsk_mark / c.fs,
                                        spec.afsk_space / c.fs))
        elif self._afsk:
            # the jnp front end's tone frequencies in rad/sample, the
            # Python float 2*pi*f/fs rounded to float32 as jnp takes it,
            # its win-tap boxcar and its 1e-9
            self._afsk_w = tuple(
                torch.tensor(np.float32(2.0 * np.pi * f / c.fs), device=dev)
                for f in (spec.afsk_mark, spec.afsk_space))
            self._afsk_box = np.ones(self._afsk_win, np.float32) / \
                self._afsk_win
            self._afsk_eps = torch.tensor(np.float32(1e-9), device=dev)
        if self._dualtone:
            # +/-dev mixer, block-periodic: one host f64 table per block
            cos_m, sin_m = mixer_tables(c.block_len // c.decim,
                                        spec.dev / c.fs_proc)
            self._mix_cos = torch.from_numpy(cos_m).to(dev)
            self._mix_sin = torch.from_numpy(sin_m).to(dev)
            # the plain path's one-chip boxcar, padded to ntaps so its
            # carried tail has the state's width
            self._box = np.zeros(c.ntaps, np.float32)
            self._nb = max(2, int(round(c.sps)))
            self._box[-self._nb:] = 1.0 / self._nb
        # FM discriminator scale at the processing rate, rounded to f32 as
        # the original hands it to its kernel (and as its jnp branch
        # multiplies by it)
        self._scale = float(np.float32(c.fs_proc / (2.0 * np.pi * spec.dev)))
        self._scale_t = torch.tensor(self._scale, dtype=torch.float32,
                                     device=dev)
        cos_w, sin_w = spectral_line_tables(c.block_len // c.decim, c.sps)
        self._cos_w = torch.from_numpy(cos_w).to(dev)
        self._sin_w = torch.from_numpy(sin_w).to(dev)
        mask = spec.extra.get("whitening")
        self._whiten = (None if mask is None else torch.from_numpy(
            np.resize(np.asarray(mask, np.uint8), spec.frame_bytes)).to(dev))
        cols = c.wire_columns
        self._wire_cols = (None if cols is None else torch.from_numpy(
            np.asarray(cols, np.int64)).to(dev))
        self._bit_shift = torch.arange(8, device=dev, dtype=torch.int32)
        if not spec.lsb_first:
            self._bit_shift = 7 - self._bit_shift
        self._bit_weight = torch.ones_like(self._bit_shift) << self._bit_shift
        # the DDC's and the AFC loop's constants: the divisor on the device
        # (CUDA multiplies by the reciprocal of a Python number), the
        # fine_offsets and the loop's seed (fine_offsets, or zeros)
        self._ddc = c.fine_offsets is not None or c.afc
        self._fs_t = torch.full((), c.fs, dtype=torch.float32, device=dev)
        self._f_seed = torch.from_numpy(
            np.asarray(c.fine_offsets, np.float32) if c.fine_offsets is not None
            else np.zeros(c.channels, np.float32)).to(dev)

    # -- state -------------------------------------------------------------

    def init_state(self) -> PipelineState:
        c = self.config

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        # the kernel path carries HALO raw input samples per plane, the
        # plain path ntaps - 1 of them, in the compute dtype as the rest of
        # the sample-rate carries
        tail_w = c.ntaps - 1 if self._plain else HALO
        sdt = self._cdt
        # aux in the original's order (sondetpu/runtime/pipeline.py:418-447):
        # the AFSK kernel path's last HALO DC-removed audio samples, or the
        # jnp AFSK front end's four [C, win - 1] mixed-tone tails and its
        # int32 [1] LO phase counter; the DDC's phase in cycles; the
        # AFC-tracked frequency in Hz seeded by fine_offsets (or zeros)
        aux = ()
        if self._route == "afsk":
            aux = (z(c.channels, HALO),)
        elif self._afsk:
            aux = tuple(z(c.channels, self._afsk_win - 1) for _ in range(4)) \
                + (z(1, dtype=torch.int32),)
        if self._ddc:
            aux += (z(c.channels),)
        if c.afc:
            aux += (self._f_seed.clone(),)
        return PipelineState(
            chan_tail_i=z(c.channels, tail_w, dtype=sdt),
            chan_tail_q=z(c.channels, tail_w, dtype=sdt),
            fm_prev=z(c.channels, 2, dtype=sdt),
            # the dual-tone path's layout carries 4 mixed planes per channel
            fir=FIRState(tail=z(c.channels * (4 if self._dualtone else 1),
                                c.ntaps - 1, dtype=sdt)),
            timing=TimingState(pos=z(c.channels), locked=z(c.channels)),
            chipbuf=z(c.channels, c.buf_len, dtype=sdt),
            buf_fill=z(c.channels, dtype=torch.int32),
            aux=aux)

    # -- the step ------------------------------------------------------------

    def step(self, state: PipelineState, iq):
        """iq: [channels, block_len] complex64 (host) or an (i, q) plane pair
        (NumPy arrays or tensors; integer planes when input_dtype is
        "i16"/"i8") -> (state, BlockOutput), or with ``profile_stop`` the
        original's checksum scalar of that stage."""
        if isinstance(iq, tuple):
            i, q = iq
        else:
            if self.config.input_dtype != "f32":
                raise TypeError("input_dtype %r needs raw integer (i, q) "
                                "planes, not complex" % self.config.input_dtype)
            i, q = c64_to_planes(np.asarray(iq))
        shape = (self.config.channels, self.config.block_len)
        with span("sondetpu.step"):
            planes = []
            for x in (i, q):
                x = torch.as_tensor(x).to(self.device).contiguous()
                if tuple(x.shape) != shape:
                    raise ValueError(f"iq planes {tuple(x.shape)}, "
                                     f"expected {shape}")
                planes.append(x)
            return self._step_impl(state, *planes)

    def fetch_frames(self, frames_dev: torch.Tensor, ch_idx, slot_idx
                     ) -> np.ndarray:
        """Pull specific (channel, slot) full frames from a device-resident
        BlockOutput.frames: the suspect path of the compact wire-column
        readback (frames the host must RS-correct)."""
        fb = self.config.spec.frame_bytes
        if len(ch_idx) == 0:
            return np.zeros((0, fb), np.uint8)
        flat = (np.asarray(ch_idx, np.int64) * self.config.k_slots
                + np.asarray(slot_idx, np.int64))
        idx = torch.from_numpy(flat).to(frames_dev.device)
        return frames_dev.reshape(-1, fb)[idx].cpu().numpy()

    def _sample_symbols(self, filt: torch.Tensor, start: torch.Tensor,
                        sps: float, cpb: int) -> torch.Tensor:
        """Linear-interpolate symbol centers at start + k*sps, k < cpb.

        Integer sps: the fractional position is constant per channel;
        ``(1-frac)*filt[s0 + k*sps] + frac*filt[s0 + 1 + k*sps]``, the two
        terms the original's strided weighted sum leaves non-zero, added in
        its order; reads past the block take its last sample.

        Rational sps = p/q (dfm: 19.2 = 96/5): the block splits into n/p
        segments of p samples holding q chips each, at the same positions
        ``start + j*sps`` (j < q) in every segment. The original contracts
        each segment with a one-hot interpolation matrix; this takes the
        same two non-zero terms of that contraction directly, in float32,
        so no matrix product (and no TF32) is involved. Position p reads
        the next segment's first sample.

        Any other sps: the original's ``_linear_interp`` at positions
        ``start + k * sps``."""
        if float(sps).is_integer():
            isps = int(sps)
            s0 = torch.floor(start).to(torch.int64)        # [C] in [0, sps)
            frac = (start - s0.to(torch.float32))[:, None]
            fp = torch.cat([filt, filt[:, -1:].expand(-1, isps + 1)], dim=-1)
            idx = s0[:, None] + isps * torch.arange(cpb, device=filt.device)
            a = torch.gather(fp, 1, idx)
            b = torch.gather(fp, 1, idx + 1)
            return (1.0 - frac) * a + frac * b
        rational = _rational_sps(self.config)
        if rational is None:
            k = torch.arange(cpb, dtype=torch.float32, device=filt.device)
            pos = start[:, None] + k[None, :] * torch.tensor(
                np.float32(sps), device=filt.device)
            return linear_interp(filt, pos)
        p, q = rational
        c = filt.shape[0]
        g = filt.shape[-1] // p
        j = torch.arange(q, dtype=torch.float32, device=filt.device)
        pos = start[:, None] + j[None, :] * torch.tensor(
            np.float32(sps), device=filt.device)               # [C, q]
        i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, p - 1)
        frac = torch.clamp(pos - i0.to(torch.float32), 0.0, 1.0)
        # segments with the next segment's first sample appended (the
        # block's last sample repeats past its end): [C, G, p + 1]
        nxt = torch.cat([filt[:, p::p], filt[:, -1:]], dim=-1)[:, :g]
        ext = torch.cat([filt.reshape(c, g, p), nxt[:, :, None]], dim=-1)
        idx = i0[:, None, :].expand(c, g, q)
        a = torch.gather(ext, 2, idx)
        b = torch.gather(ext, 2, idx + 1)
        soft = (1.0 - frac)[:, None, :] * a + frac[:, None, :] * b
        # chips in temporal order: segment-major, j-minor
        return soft.reshape(c, cpb)

    def _correlate(self, chipbuf: torch.Tensor, k: int) -> torch.Tensor:
        """Correlation with template k: the correlator kernel on the fused
        front end's path, the plain correlation on the plain-op, dual-tone
        and AFSK paths (the original's choice, ``pipeline.py:948-970``)."""
        if self._route != "fused":
            return correlate_syncword(chipbuf, self._np_templates[k])
        return corr_kernel(chipbuf, self._np_templates[k])

    def _downconvert(self, iq_i: torch.Tensor, iq_q: torch.Tensor,
                     freq_hz: torch.Tensor, phase0: torch.Tensor):
        """The per-channel DDC (``sondetpu/runtime/pipeline.py:647-667``):
        rotate each row by -2*pi*freq_hz*t from its carried phase (in
        cycles). Returns (i, q, new phase). The original's float32 formula
        in its order: f_norm = freq_hz / fs on the device, cyc = phase0 +
        f_norm * k (the product and the sum rounded apart), ang =
        fl32(-2*pi) * cyc, accurate cos and sin (the angle reaches ~1e5 rad
        on a 4 s block), and the new phase (phase0 + n * f_norm) mod 1,
        floored as jnp.mod. Three [C, n] temporaries besides the outputs,
        freed on return."""
        n = iq_i.shape[-1]
        f_norm = freq_hz / self._fs_t
        ang = f_norm[:, None] * torch.arange(n, dtype=torch.float32,
                                             device=iq_i.device)
        ang.add_(phase0[:, None]).mul_(-2.0 * np.pi)
        cosv = torch.cos(ang)
        sinv = ang.sin_()
        out_i = (iq_i * cosv).sub_(iq_q * sinv)
        out_q = (iq_i * sinv).add_(iq_q * cosv)
        phase = torch.remainder(phase0 + f_norm * float(n), 1.0)
        return out_i, out_q, phase

    def _afc_update(self, freq_hz: torch.Tensor, dc: torch.Tensor):
        """First-order AFC loop (``sondetpu/runtime/pipeline.py:612-629``):
        ``dc`` is the residual offset in audio/dev units; the clamp bounds
        the excursion from each channel's seed, not the DDC frequency."""
        c = self.config
        maxhz = float(np.float32(c.afc_max_hz if c.afc_max_hz is not None
                                 else c.spec.bandwidth / 2.0))
        beta = float(np.float32(c.afc_beta))
        dev = float(np.float32(c.spec.dev))
        return self._f_seed + torch.clamp(
            freq_hz + beta * dc * dev - self._f_seed, -maxhz, maxhz)

    def _plain_frontend(self, state: PipelineState, planes: list):
        """The original's jnp front end (``sondetpu/runtime/pipeline.py:
        765-910``) on ``planes`` = [i, q] in the compute dtype, which it
        empties, so that each plane is freed as soon as it is used: the
        channel filter over [carried tail | block] at stride decim (skipped
        where the dual-tone gate skips it), then the FM discriminator with
        atan2 in float32 or, for a dual-tone family, the mix, boxcar and
        envelope metric of :meth:`_plain_dualtone`; the block DC (mean or
        midpoint); then the matched FIR over [carried audio tail | audio],
        or for AFSK :meth:`_plain_afsk`. The filters read the compute dtype,
        round bfloat16 taps as the original's conv does, and sum in float32,
        and the filtered planes are stored in the compute dtype. Returns
        (filt in float32, the new [C, ntaps - 1] chan tails, fm_prev, fir,
        the residual offset the AFC loop reads in audio/dev units or None
        when neither dc_block nor afc is set, the AFSK aux or ()); with
        profile_stop "chanfilt" the original's sum of the filtered planes
        instead."""
        c = self.config
        cdt, f32 = self._cdt, torch.float32
        h = c.ntaps - 1
        iq_i, iq_q = planes
        planes.clear()
        # the carried tails as copies: views would keep the whole block
        # alive until the next step
        tail_i, tail_q = iq_i[:, -h:].contiguous(), iq_q[:, -h:].contiguous()
        ci, cq = iq_i, iq_q
        if not self._skip_chanfilt:
            ci = apply_windows(torch.cat([state.chan_tail_i, iq_i], dim=-1),
                               self._chan_taps, stride=c.decim).to(cdt)
            cq = apply_windows(torch.cat([state.chan_tail_q, iq_q], dim=-1),
                               self._chan_taps, stride=c.decim).to(cdt)
        del iq_i, iq_q
        if c.profile_stop == "chanfilt":
            return torch.sum(ci) + torch.sum(cq)
        fm_prev = torch.stack([ci[:, -1], cq[:, -1]], dim=-1)
        rot_dc = None
        if self._dualtone:
            audio, fir, rot_dc = self._plain_dualtone(state.fir, ci, cq)
        else:
            ip = torch.cat([state.fm_prev[:, 0:1], ci[:, :-1]], dim=-1).to(f32)
            qp = torch.cat([state.fm_prev[:, 1:2], cq[:, :-1]], dim=-1).to(f32)
            ii, qq = ci.to(f32), cq.to(f32)
            audio = torch.atan2(qq * ip - ii * qp,
                                ii * ip + qq * qp) * self._scale_t
            del ip, qp, ii, qq
        del ci, cq
        dc = None
        if c.dc_block or c.afc:
            # jnp.mean: the sum over a divisor on the device (CUDA
            # multiplies by the reciprocal of a Python number)
            dc = (midpoint_dc(audio) if self._midpoint
                  else torch.sum(audio, dim=-1) / torch.full(
                      (), float(audio.shape[-1]), dtype=f32,
                      device=audio.device))
        if c.dc_block:
            audio = audio - dc[:, None]
        aux = ()
        if self._afsk:
            filt, aux = self._plain_afsk(state.aux, audio)
            fir = state.fir
        elif self._dualtone:
            # the envelope metric is already matched-filtered
            filt = audio
        else:
            xp = torch.cat([state.fir.tail, audio.to(cdt)], dim=-1)
            del audio
            filt = apply_windows(xp, self._taps)
            fir = FIRState(tail=xp[:, -h:].contiguous())
        return (filt, tail_i, tail_q, fm_prev, fir,
                rot_dc if rot_dc is not None else dc, aux)

    def _plain_afsk(self, aux: tuple, audio: torch.Tensor):
        """The original's jnp AFSK front end (``sondetpu/runtime/
        pipeline.py:510-541``) on the DC-removed float32 audio: mix by the
        mark and space tones, cos and sin of ``w * (count + k)`` in float32
        (w the float32 2*pi*f/fs, count the carried LO phase counter), a
        ``win``-tap boxcar over [carried mixed tail | mixed] per tone and
        plane, and ``soft = (Em - Es) / (Em + Es + 1e-9)``. Returns (soft
        [C, n] float32, the new aux: the four [C, win - 1] mixed tails, then
        the counter (count + n) mod L as int32 [1]); each plane's
        temporaries are freed before the next is made."""
        f32 = torch.float32
        n = audio.shape[-1]
        h = self._afsk_win - 1
        count = aux[4]
        idx = count.to(f32) + torch.arange(n, dtype=f32, device=audio.device)
        energies, tails = [], []
        for j, w in enumerate(self._afsk_w):
            arg = w * idx
            fl = []
            for k, trig in enumerate((torch.cos, torch.sin)):
                xp = torch.cat([aux[2 * j + k], audio * trig(arg)], dim=-1)
                tails.append(xp[:, -h:].contiguous())
                fl.append(apply_windows(xp, self._afsk_box))
                del xp
            fi, fq = fl
            energies.append(fi * fi + fq * fq)
            del fl, fi, fq
        em, es = energies
        soft = (em - es) / (em + es + self._afsk_eps)
        new_count = torch.remainder(count + n, self._afsk_L).to(torch.int32)
        return soft, tuple(tails) + (new_count,)

    def _plain_dualtone(self, fir: FIRState, ci: torch.Tensor,
                        cq: torch.Tensor):
        """The original's jnp dual-tone branch (``sondetpu/runtime/
        pipeline.py:790-865``) on the channel-filtered planes: mix both by
        the host f64 +/-dev table into four planes (formed in float32,
        stored in the compute dtype behind the carried [4C, ntaps - 1]
        tail), one ``apply_windows`` of the nb-tap boxcar padded to ntaps
        over all four, and the metric ``(P+ - P-) / (P+ + P- + 1e-12)`` in
        float32. With ``afc`` also the power-weighted envelope rotation of
        the lowpassed planes, as an angle in audio/dev units. Returns
        (metric [C, n], FIRState, that angle or None)."""
        c = self.config
        f32 = torch.float32
        h = c.ntaps - 1
        cc, n = ci.shape
        ii, qq = ci.to(f32), cq.to(f32)
        cv, sv = self._mix_cos, self._mix_sin
        # [tail | planes] written in place, each plane rounded once to the
        # compute dtype: no [4C, n] float32 copy of the planes
        xp4 = torch.empty((4 * cc, h + n), dtype=self._cdt, device=ci.device)
        xp4[:, :h] = fir.tail
        xp4[0 * cc:1 * cc, h:] = ii * cv + qq * sv     # +tone I (x e^{-j})
        xp4[1 * cc:2 * cc, h:] = qq * cv - ii * sv     # +tone Q
        xp4[2 * cc:3 * cc, h:] = ii * cv - qq * sv     # -tone I (x e^{+j})
        xp4[3 * cc:4 * cc, h:] = qq * cv + ii * sv     # -tone Q
        del ii, qq
        new_fir = FIRState(tail=xp4[:, -h:].contiguous())
        lp = apply_windows(xp4, self._box)
        del xp4
        pi_, pq_, mi_, mq_ = lp[:cc], lp[cc:2 * cc], lp[2 * cc:3 * cc], \
            lp[3 * cc:]
        pp = pi_ * pi_ + pq_ * pq_
        pm = mi_ * mi_ + mq_ * mq_
        eps = torch.tensor(np.float32(1e-12), device=ci.device)
        audio = (pp - pm) / (pp + pm + eps)
        del pp, pm
        rot_dc = None
        if c.afc:
            rot_re = (pi_[:, 1:] * pi_[:, :-1] + pq_[:, 1:] * pq_[:, :-1]
                      + mi_[:, 1:] * mi_[:, :-1] + mq_[:, 1:] * mq_[:, :-1])
            rot_im = (pq_[:, 1:] * pi_[:, :-1] - pi_[:, 1:] * pq_[:, :-1]
                      + mq_[:, 1:] * mi_[:, :-1] - mi_[:, 1:] * mq_[:, :-1])
            rot_dc = torch.atan2(torch.sum(rot_im, dim=-1),
                                 torch.sum(rot_re, dim=-1)) * self._scale_t
        return audio, new_fir, rot_dc

    def _step_impl(self, state: PipelineState, iq_i: torch.Tensor,
                   iq_q: torch.Tensor):
        c = self.config
        spec = c.spec
        cdt, f32 = self._cdt, torch.float32
        stop = c.profile_stop
        with span("sondetpu.ingest"):
            if c.input_dtype != "f32":
                # device-side dequant of raw SDR integer planes
                qs = float(np.float32(1.0 / 32768.0 if c.input_dtype == "i16"
                                      else 1.0 / 128.0))
                iq_i = iq_i.to(f32) * qs
                iq_q = iq_q.to(f32) * qs
            elif self._ddc or iq_i.dtype not in (f32, torch.bfloat16):
                # the DDC's arithmetic is float32 (a bfloat16 plane, as a
                # bf16 fleet hands it over, widens exactly); any other type
                # becomes float32 first, as the original's float32 upload
                # does
                iq_i, iq_q = iq_i.to(f32), iq_q.to(f32)
        sps = c.sps
        ddc_aux = ()
        if self._ddc:
            # with afc the frequency is state (aux[-1]) and the phase comes
            # before it; without, the constant fine_offsets and the phase
            # in aux[-1]
            if c.afc:
                freq_hz, phase0 = state.aux[-1], state.aux[-2]
            else:
                freq_hz, phase0 = self._f_seed, state.aux[-1]
            with span("sondetpu.ddc"):
                iq_i, iq_q, phase = self._downconvert(iq_i, iq_q, freq_hz,
                                                      phase0)
            ddc_aux = (phase,)
        # the sample-rate planes are stored in the compute dtype from here
        # on (sondetpu/runtime/pipeline.py:668-671); every front end reads
        # them so
        with span("sondetpu.ingest"):
            iq_i = iq_i.to(cdt).contiguous()
            iq_q = iq_q.to(cdt).contiguous()
        # the kernel paths carry fm_prev and fir as they are; the plain
        # path replaces them. afc_dc: the loop's residual offset in
        # audio/dev units, per branch as in the original
        fm_prev, fir, aux = state.fm_prev, state.fir, ()

        with span("sondetpu.frontend"):
            if self._plain:
                planes = [iq_i, iq_q]
                del iq_i, iq_q
                out = self._plain_frontend(state, planes)
                if stop == "chanfilt":
                    return out
                filt, new_ctail_i, new_ctail_q, fm_prev, fir, afc_dc, aux = \
                    out
                del out
            elif self._route == "dualtone":
                # fused dual-tone noncoherent front end: (chanfilt) + +/-dev
                # mix + one-chip boxcar + envelope metric; mean DC from the
                # kernel's sums or the midpoint of its metric, AFC from its
                # envelope-rotation sums. The boxcar is the matched filter.
                filt, new_ctail_i, new_ctail_q, dc, rot_re, rot_im = \
                    fused_dualtone_frontend(
                        iq_i, iq_q, state.chan_tail_i, state.chan_tail_q,
                        self._chan_taps, self._mix_cos, self._mix_sin,
                        self._nb, want_afc=c.afc,
                        skip_chanfilt=self._skip_chanfilt)
                if c.dc_block:
                    if self._midpoint:
                        dc = midpoint_dc(filt)
                    filt = filt - dc[:, None]
                afc_dc = (torch.atan2(rot_im, rot_re) * self._scale_t
                          if c.afc else None)
                if stop == "chanfilt":
                    return torch.sum(filt)
            elif self._route == "afsk":
                # K1 at decim 1 with an identity matched filter gives the
                # DC-removed discriminator audio and its DC; K8 mixes it by
                # the mark and space tones, boxcars one symbol and forms the
                # soft chips
                audio, new_ctail_i, new_ctail_q, afc_dc = fused_frontend(
                    iq_i, iq_q, state.chan_tail_i, state.chan_tail_q,
                    self._chan_taps, self._delta, self._scale, 1, c.dc_block)
                if stop == "chanfilt":
                    return torch.sum(audio)
                filt, new_atail = fused_afsk_frontend(
                    audio, state.aux[0], self._afsk_tabs, self._afsk_win)
                aux = (new_atail,)
            else:
                # K1: channel filter + decimate + FM discriminator + matched
                # FIR, and the block DC; the carry is the raw HALO-sample
                # input tail per plane
                filt, new_ctail_i, new_ctail_q, afc_dc = fused_frontend(
                    iq_i, iq_q, state.chan_tail_i, state.chan_tail_q,
                    self._chan_taps, self._taps, self._scale, c.decim,
                    c.dc_block)
                if stop == "chanfilt":   # chanfilt is demod here, as there
                    return torch.sum(filt)
        if c.afc:
            with span("sondetpu.afc"):
                ddc_aux += (self._afc_update(freq_hz, afc_dc),)
        if stop == "demod":
            return torch.sum(filt)

        # symbol timing: feed-forward estimate + slew-limited NCO carry.
        # torch.remainder is the floored mod of jnp.mod; next_pos keeps the
        # original's order of operations (it rounds to 1/64 sample at
        # n = 96000, and the carried state must follow the reference)
        with span("sondetpu.timing"):
            # the compute dtype for the strided sample reads (:912-913)
            filt = filt.to(cdt)
            n = filt.shape[-1]
            tau = oerder_meyr_tau(filt, sps, self._cos_w, self._sin_w)
            pos = state.timing.pos
            err = torch.remainder(tau - pos + sps / 2.0, sps) - sps / 2.0
            corrected = pos + torch.clamp(err, -0.5, 0.5)
            start = torch.where(state.timing.locked > 0, corrected, tau)
            start = torch.clamp(start, 0.0, sps - 1e-3)
            cpb = c.chips_per_block
            next_pos = start + cpb * sps - n
            timing_state = TimingState(
                pos=next_pos, locked=torch.ones_like(state.timing.locked))
            if stop == "timing":
                return torch.sum(start) + torch.sum(next_pos)
        with span("sondetpu.sample"):
            soft = self._sample_symbols(filt, start, sps, cpb)
            if stop == "sample":
                return torch.sum(soft)

        # chip ring buffer: a constant cpb new chips -> static slice, stored
        # in the compute dtype
        with span("sondetpu.ring"):
            chipbuf = torch.cat([state.chipbuf, soft.to(self._cdt)],
                                dim=-1)[:, cpb:].contiguous()
            buf_fill = torch.clamp_max(state.buf_fill + cpb, c.buf_len)

        # syncword correlation (K2 on the fused front end's path only, see
        # _correlate); alternates go through the same correlator
        with span("sondetpu.corr"):
            corr = self._correlate(chipbuf, 0)
            if spec.extra.get("abs_corr"):
                corr = corr.abs()
            for k in range(1, len(self._np_templates)):
                corr2 = self._correlate(chipbuf, k)
                if spec.extra.get("abs_corr"):
                    corr2 = corr2.abs()
                m = min(corr.shape[-1], corr2.shape[-1])
                corr = torch.maximum(corr[:, :m], corr2[:, :m])
            if stop == "corr":
                return torch.sum(corr)
        with span("sondetpu.peaks"):
            min_dist = max(c.min_frame_chips // 4, self._template.shape[0])
            starts, ok = find_frame_starts(corr, c.sync_threshold, c.k_slots,
                                           min_dist)
            if stop == "peaks":
                return _int32_sum(starts) + _int32_sum(ok)
            # dedup across blocks: only frames whose END lies in the new
            # chips, and whose start lies within real (filled) history
            is_new = (starts + c.frame_chips) > (c.buf_len - cpb)
            in_hist = starts >= (c.buf_len - buf_fill)[:, None]
            fit = (starts + c.frame_chips) <= c.buf_len
            frame_valid = ok & fit & is_new & in_hist

        with span("sondetpu.gather"):
            frames, weak = self._gather(chipbuf, starts, ok)
            if stop == "gather":
                return _int32_sum(frames)
            if self._whiten is not None:
                frames = torch.bitwise_xor(frames, self._whiten)
            score = torch.gather(
                torch.nn.functional.pad(corr, (0, c.frame_chips)), 1,
                starts.to(torch.int64))
            soft_rms = torch.sqrt(torch.mean(soft * soft, dim=-1))

        # RS syndrome flag (K3; the GF(2) matmul on the plain path, as in
        # the original); frames flagged clean skip host FEC
        with span("sondetpu.syndrome"):
            rs_layout = spec.extra.get("rs")
            if rs_layout is not None:
                flags = (rs_clean_flags_kernel if self._route == "fused"
                         else rs_clean_flags)
                rs_clean = flags(frames, rs_layout) & frame_valid
            else:
                rs_clean = torch.zeros_like(frame_valid)
            if stop == "syndrome":
                return _int32_sum(rs_clean) + _int32_sum(frame_valid)

        with span("sondetpu.pack"):
            cc = chipbuf.shape[0]
            wire = frames if self._wire_cols is None else \
                frames.index_select(-1, self._wire_cols)
            parts = [
                wire.reshape(cc, -1),
                frame_valid.to(torch.uint8),
                rs_clean.to(torch.uint8),
                soft_rms.contiguous().view(torch.uint8).reshape(cc, 4),
            ]
            if c.chase_m:
                # weakest-bit indices as u16 little-endian pairs
                parts.append(weak.to(torch.int16).contiguous().view(
                    torch.uint8).reshape(cc, -1))
            packed = torch.cat(parts, dim=-1).reshape(-1)
        out = BlockOutput(frames=frames, frame_valid=frame_valid,
                          frame_score=score, soft_rms=soft_rms,
                          rs_clean=rs_clean, packed=packed)
        new_state = PipelineState(
            chan_tail_i=new_ctail_i, chan_tail_q=new_ctail_q,
            fm_prev=fm_prev, fir=fir, timing=timing_state,
            chipbuf=chipbuf, buf_fill=buf_fill, aux=aux + ddc_aux)
        return new_state, out

    def _gather(self, chipbuf: torch.Tensor, starts: torch.Tensor,
                ok: torch.Tensor):
        """The frames' bytes [C, K, frame_bytes] uint8 at the picked
        starts, and the Chase weak bits (or None): the NRZ byte pack at
        every chip offset, or the frame gather with the line decoding."""
        c, spec = self.config, self.config.spec
        cc, kk, fb = chipbuf.shape[0], starts.shape[1], spec.frame_bytes
        weak = None
        if spec.line_code == "nrz":
            # NRZ byte pack at every chip offset, with integer shifts:
            # byte_at[i] = sum_k hard[i + k] << shift[k]
            hard = (chipbuf > 0).to(torch.int32)
            m = c.buf_len - 7
            byte_at = hard[:, 0:m] << self._bit_shift[0]
            for k in range(1, 8):
                byte_at = byte_at + (hard[:, k:k + m] << self._bit_shift[k])
            # the original regroups byte_at as [C, 8, bq] (zero-padded to a
            # multiple of 8) and takes fb consecutive bytes of row r = safe % 8
            # from column q = min(safe // 8, bq - fb): frame byte t is
            # byte_at[8*q + r + 8*t]
            byte_at = torch.nn.functional.pad(byte_at, (0, (-m) % 8))
            bq = byte_at.shape[-1] // 8
            safe = torch.clamp(starts, 0, max(c.buf_len - c.frame_chips, 0)
                               ).to(torch.int64)
            q = torch.clamp_max(safe // 8, bq - fb)
            first = 8 * q + (safe - 8 * (safe // 8))
            idx = first[:, :, None] + 8 * torch.arange(fb, device=self.device)
            frames = torch.gather(byte_at, 1, idx.reshape(cc, kk * fb)
                                  ).reshape(cc, kk, fb).to(torch.uint8)
            return frames, weak
        if c.chase_m:
            # soft-decision assist: gather soft chips, slice them, and
            # rank each decoded bit's reliability as min(|a|, |b|) of
            # its chip pair; the chase_m weakest per span ride the
            # packed buffer (an exact ranking in place of approx_max_k,
            # by (reliability, index) through a stable sort: bfloat16
            # reliabilities tie often, and torch.topk breaks ties one
            # way on the CPU and another on a CUDA device)
            soft_fr, _ = gather_frames(chipbuf, starts, ok, c.frame_chips)
            chips = (soft_fr > 0).to(torch.uint8)
            rel = torch.minimum(soft_fr[..., 0::2].abs(),
                                soft_fr[..., 1::2].abs())
            weak = torch.cat([
                torch.sort(rel[..., a:b], dim=-1, stable=True
                           ).indices[..., :c.chase_m] + a
                for a, b in c.chase_spans], dim=-1)    # [C, K, S*M]
        else:
            chips, _ = gather_frames((chipbuf > 0).to(torch.uint8),
                                     starts, ok, c.frame_chips)
        if spec.line_code == "manchester":
            chips = manchester_decode(chips)
        elif spec.line_code == "biphase_m":
            chips = biphase_m_decode(chips)
        bits8 = chips.reshape(cc, kk, fb, 8).to(torch.int32)
        frames = torch.sum(bits8 * self._bit_weight, dim=-1).to(torch.uint8)
        return frames, weak
