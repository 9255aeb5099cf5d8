"""Checkpoint / resume of streaming decode state (counterpart:
``sondetpu/runtime/checkpoint.py``).

The complete per-channel carry-over of a ``DecoderSession`` or a
``FleetSession`` (device pipeline state, host decoder state, running
telemetry) serializes to one pickle with the original's payload keys and
``FORMAT_VERSION``, so a run resumes at a block boundary. Device leaves
come to the host as NumPy arrays; a bfloat16 leaf as its 16-bit words
(``BFloat16Words``), so saving and loading a bf16 state needs no NumPy
bfloat16 type (ml_dtypes).

A checkpoint that the JAX package wrote loads here too: the unpickler maps
each class such a checkpoint holds (``sondetpu.<module>.<name>``) to the
port's copy (``sondetpu_torch.<module>.<name>``) and the ml_dtypes
bfloat16 dtype to a reader of its raw words, without importing
``sondetpu``, jax or ml_dtypes, and refuses every other class. Fleet
groups hold different pad rows in the two packages (the original pads a
group of 64 or more channels to a multiple of 64, the port a kernel-path
group to a multiple of 8), so a fleet group restores its logical rows,
the first ``len(idxs)`` of each leaf's channel axis, into the port's own
``init_state``; its pad rows start afresh. Every mismatch (sonde, channel
count, block length, AFC setting, layout, dtype) raises before any state
is touched. The AutoFleet checkpoints are not ported.

Checkpoint files are trusted input (this framework writes them), as in the
original; the restricted unpickler keeps a foreign class out all the same.
"""

from __future__ import annotations

import importlib
import pickle
from typing import Dict

import numpy as np
import torch

from sondetpu_torch.dsp.channelizer import ChannelizerState
from sondetpu_torch.runtime.pipeline import (BFloat16Words,
                                             _leaf_from_numpy, _map_state,
                                             state_from_numpy)

FORMAT_VERSION = 2    # v2: fleet group payloads record layout

# the classes a checkpoint holds, by module under sondetpu (the JAX
# package's) or sondetpu_torch (the port's): each loads as the port's copy
_CLASSES = {
    "runtime.pipeline": ("PipelineState", "BFloat16Words"),
    "dsp.fir": ("FIRState",),
    "sync.timing": ("TimingState",),
    "dsp.channelizer": ("ChannelizerState",),
    "telemetry": ("SondeTelemetry", "TelemetryFragment", "Fields"),
    "sondes.rs41": ("_ChannelCal",),
}
_NUMPY = {("numpy", "ndarray"), ("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "scalar"),
          ("numpy.core.multiarray", "scalar")}


class _BFloat16Tag:
    """Stands for ``ml_dtypes.bfloat16`` while a JAX checkpoint loads."""


class _BFloat16Dtype:
    """Stands for ``numpy.dtype(ml_dtypes.bfloat16)``; an array that
    unpickles with it becomes ``BFloat16Words``."""

    def __setstate__(self, state):
        pass


def _dtype(spec, align=False, copy=False):
    if spec is _BFloat16Tag:
        return _BFloat16Dtype()
    return np.dtype(spec, align, copy)


class _Unpickler(pickle._Unpickler):
    """The pure-Python unpickler, restricted to the classes above; BUILD of
    an array whose dtype is the bfloat16 stand-in takes its bytes as int16
    words."""

    def find_class(self, module, name):
        top, _, sub = module.partition(".")
        if top in ("sondetpu", "sondetpu_torch") and \
                name in _CLASSES.get(sub, ()):
            return getattr(importlib.import_module("sondetpu_torch." + sub),
                           name)
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _BFloat16Tag
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if (module, name) in _NUMPY:
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(
            f"a checkpoint may not hold {module}.{name}")

    def _load_build(self):
        state, inst = self.stack[-1], self.stack[-2]
        if not (isinstance(inst, np.ndarray) and isinstance(state, tuple)
                and len(state) == 5 and isinstance(state[2], _BFloat16Dtype)):
            return pickle._Unpickler.load_build(self)
        self.stack.pop()
        inst.__setstate__(state[:2] + (np.dtype("<i2"),) + state[3:])
        words = BFloat16Words(inst)
        self.stack[-1] = words
        for k, v in self.memo.items():      # later references to the array
            if v is inst:
                self.memo[k] = words

    dispatch = dict(pickle._Unpickler.dispatch)
    dispatch[pickle.BUILD[0]] = _load_build


def _load(path: str) -> dict:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _leaf_to_host(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return BFloat16Words(t.view(torch.int16).numpy())
    return t.numpy()


def _to_host(state):
    return _map_state(state, _leaf_to_host)


def _leaves(state) -> list:
    return [state.chan_tail_i, state.chan_tail_q, state.fm_prev,
            state.fir.tail, state.timing.pos, state.timing.locked,
            state.chipbuf, state.buf_fill, *state.aux]


def _from_leaves(template, leaves: list):
    """A state of ``template``'s layout with ``leaves`` (in _leaves order)."""
    it = iter(leaves)
    return _map_state(template, lambda _: next(it))


def _check_state_layout(saved, current, what: str, n=None) -> list:
    """The pipeline state layout is config-dependent (AFSK aux tails, DDC
    phase, AFC frequency): a checkpoint saved under one config must not
    restore into another (e.g. --afc toggled between runs). ``saved`` is
    the checkpoint's state on the CPU; with ``n`` (a fleet group's logical
    channels) the leaves are compared on their first n channel rows.
    Returns the per-leaf row mappings for :func:`_restore_rows`."""
    s_leaves, c_leaves = _leaves(saved), _leaves(current)
    if len(saved.aux) != len(current.aux):
        raise ValueError(
            f"{what}: checkpoint state layout ({len(saved.aux)} aux leaves) "
            f"!= session ({len(current.aux)}) (config mismatch — e.g. "
            "afc/fine_offsets toggled?)")
    p = saved.timing.pos.shape[0]
    q = current.timing.pos.shape[0]
    maps = []
    for i, (s, c) in enumerate(zip(s_leaves, c_leaves)):
        m = "all" if s.shape == c.shape else None
        if m is None and n is not None and s.dim() == c.dim() >= 1 \
                and s.shape[1:] == c.shape[1:] and p >= n and q >= n:
            k = s.shape[0] // p
            if k >= 1 and s.shape[0] == k * p and c.shape[0] == k * q:
                m = (k, p, q)
        if m is None:
            raise ValueError(
                f"{what}: state leaf {i} shape {tuple(s.shape)} != "
                f"{tuple(c.shape)} (config mismatch — e.g. afc/fine_offsets "
                "toggled)")
        if s.dtype != c.dtype:
            raise ValueError(
                f"{what}: state leaf {i} dtype {s.dtype} != {c.dtype} "
                "(compute_dtype mismatch?)")
        maps.append(m)
    return maps


def _restore_rows(saved, current, maps, n: int, device):
    """``current`` with the saved leaves, or their first n channel rows,
    written in (on ``device``)."""
    out = []
    for s, c, m in zip(_leaves(saved), _leaves(current), maps):
        if m == "all":
            out.append(s.to(device))
            continue
        k, p, q = m
        o = c.clone()
        o.view(k, q, *c.shape[1:])[:, :n] = \
            s.view(k, p, *s.shape[1:])[:, :n].to(device)
        out.append(o)
    return _from_leaves(current, out)


def save_session(session, path: str) -> None:
    """Snapshot a DecoderSession (device state is pulled to host)."""
    payload = {
        "version": FORMAT_VERSION,
        "sonde": session.config.sonde,
        "channels": session.config.channels,
        "block_len": session.config.block_len,
        "pipeline_state": _to_host(session.state),
        "decoder": session.decoder.__dict__,
        "telemetry": session.telemetry,
        "frames_seen": session.frames_seen,
        "blocks_seen": session.blocks_seen,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_session(session, path: str) -> None:
    """Restore a snapshot (the port's or the JAX package's) into a freshly
    constructed DecoderSession with a matching config; raises on
    sonde/shape mismatch before touching the session."""
    payload = _load(path)
    # v1 single-session payloads are layout-identical to v2 (only the
    # fleet/autofleet payloads gained fields in v2)
    if payload["version"] not in (1, FORMAT_VERSION):
        raise ValueError(f"checkpoint version {payload['version']} unsupported")
    for key in ("sonde", "channels", "block_len"):
        have = getattr(session.config, key)
        want = payload[key]
        if have != want:
            raise ValueError(f"checkpoint {key}={want!r} != session {key}={have!r}")
    saved = state_from_numpy(payload["pipeline_state"], "cpu")
    _check_state_layout(saved, session.state, "session")
    session.state = _map_state(saved, lambda t: t.to(session.device))
    session.decoder.__dict__.update(payload["decoder"])
    session.telemetry = payload["telemetry"]
    session.frames_seen = payload["frames_seen"]
    session.blocks_seen = payload["blocks_seen"]


def _fleet_payload(fleet) -> dict:
    groups = {}
    for sonde, (idxs, sess) in fleet.groups.items():
        groups[sonde] = {
            "idxs": list(idxs),
            "layout": [(fleet.channels[i].pfb_bin, fleet.channels[i].offset_hz)
                       for i in idxs],
            "pipeline_state": _to_host(sess.state),
            "decoder": sess.decoder.__dict__,
            "telemetry": sess.telemetry,
            "frames_seen": sess.frames_seen,
            "blocks_seen": sess.blocks_seen,
        }
    pfb = fleet.pfb_state
    return {
        "version": FORMAT_VERSION,
        "fleet": True,
        "n_bins": fleet.n_bins,
        "block_len": fleet.block_len,
        "pfb_state": ChannelizerState(tail_i=_leaf_to_host(pfb.tail_i),
                                      tail_q=_leaf_to_host(pfb.tail_q)),
        "groups": groups,
    }


def save_fleet(fleet, path: str) -> None:
    """Snapshot a FleetSession: the PFB channelizer carry plus every
    per-type group's full session payload (keyed by sonde type)."""
    with open(path, "wb") as f:
        pickle.dump(_fleet_payload(fleet), f)


def load_fleet(fleet, path: str) -> None:
    """Restore a fleet snapshot (the port's or the JAX package's) into a
    freshly constructed FleetSession with the same channel map; raises on
    layout mismatch before touching the fleet."""
    _restore_fleet(fleet, _load(path))


def _logical(d: Dict, n: int) -> Dict:
    """A per-channel dict without the pad rows' entries (int keys >= n)."""
    return {k: v for k, v in d.items() if not (isinstance(k, int) and k >= n)}


def _restore_fleet(fleet, payload: dict) -> None:
    if payload.get("version") != FORMAT_VERSION or not payload.get("fleet"):
        raise ValueError("not a fleet checkpoint of a supported version")
    for key in ("n_bins", "block_len"):
        if payload[key] != getattr(fleet, key):
            raise ValueError(f"checkpoint {key}={payload[key]!r} != fleet "
                             f"{key}={getattr(fleet, key)!r}")
    if set(payload["groups"]) != set(fleet.groups):
        raise ValueError(f"checkpoint groups {sorted(payload['groups'])} != "
                         f"fleet groups {sorted(fleet.groups)}")
    pfb = [_leaf_from_numpy(x, torch.device("cpu"))
           for x in payload["pfb_state"]]
    for s, c in zip(pfb, fleet.pfb_state):
        if s.shape != c.shape or s.dtype != c.dtype:
            raise ValueError(f"PFB state {tuple(s.shape)} {s.dtype} != "
                             f"fleet {tuple(c.shape)} {c.dtype}")
    # validate EVERY group before mutating anything: a half-restored fleet
    # would run desynced if the caller catches the error and carries on
    restored = {}
    for sonde, g in payload["groups"].items():
        idxs, sess = fleet.groups[sonde]
        layout = [(fleet.channels[i].pfb_bin, fleet.channels[i].offset_hz)
                  for i in idxs]
        if list(idxs) != g["idxs"] or layout != g.get("layout", layout):
            raise ValueError(f"channel layout changed for group {sonde!r}")
        saved = state_from_numpy(g["pipeline_state"], "cpu")
        maps = _check_state_layout(saved, sess.state,
                                   f"fleet group {sonde!r}", n=len(idxs))
        restored[sonde] = (saved, maps)
    dev = fleet.device
    fleet.pfb_state = ChannelizerState(*(t.to(dev) for t in pfb))
    for sonde, g in payload["groups"].items():
        idxs, sess = fleet.groups[sonde]
        n = len(idxs)
        saved, maps = restored[sonde]
        padded = any(m != "all" for m in maps)
        sess.state = _restore_rows(saved, sess.pipeline.init_state()
                                   if padded else sess.state, maps, n,
                                   sess.device)
        decoder, telemetry = g["decoder"], g["telemetry"]
        if padded:
            decoder = {k: _logical(v, n) if isinstance(v, dict) else v
                       for k, v in decoder.items()}
            telemetry = _logical(telemetry, n)
        sess.decoder.__dict__.update(decoder)
        sess.telemetry = telemetry
        sess.frames_seen = g["frames_seen"]
        sess.blocks_seen = g["blocks_seen"]
