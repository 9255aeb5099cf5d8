"""Typed configuration with JSON persistence (SURVEY.md §5.6; a copy of
``sondetpu/cli/config.py``).

Replaces the reference's SDR++ ConfigManager usage (main.cpp:26,39-49:
per-instance JSON keys gpxPath/ptuPath/sondeType with write-through
persistence): a dataclass tree serialized to JSON, per-channel entries
{center_freq, sonde type}, CLI flags overriding file values, and explicit
save() (write-through helpers call it after every mutation, matching
main.cpp:343-347,359-363,384-387).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional


def _default_output(name: str) -> str:
    """Temp-dir default like the reference (utils.cpp:3-11) — with a correct
    path join (the reference's win/unix separators are inverted,
    utils.cpp:12-16; SURVEY.md P11 says fix, don't replicate)."""
    return os.path.join(tempfile.gettempdir(), name)


@dataclass
class ChannelConfig:
    """One decoded channel (the analogue of one reference module instance +
    VFO, main.cpp:23,55-56)."""

    center_freq: float = 0.0        # Hz within the wideband input
    sonde: str = "rs41"


@dataclass
class SinkConfig:
    gpx_enabled: bool = False
    gpx_path: str = field(default_factory=lambda: _default_output("radiosonde.gpx"))
    ptu_enabled: bool = False
    ptu_path: str = field(default_factory=lambda: _default_output("radiosonde_ptu.csv"))
    jsonl_enabled: bool = True
    jsonl_path: str = "-"           # stdout


@dataclass
class FrameworkConfig:
    sonde: str = "rs41"             # default type (ref key "sondeType")
    channels: int = 1
    fs: float = 48000.0             # per-channel IQ rate
    wideband: bool = False          # input is wideband -> PFB channelize
    wide_bins: int = 0              # PFB bin count (0 = take CLI --bins)
    block_len: int = 48000
    sync_threshold: float = 0.6
    use_pallas: bool = False
    # cs16/cs8 inputs: upload raw integer planes and dequantize ON DEVICE
    # (2x/4x less host->device traffic); no effect on float formats
    device_dequant: bool = False
    # "bf16" stores sample-rate device arrays in bfloat16 (halves HBM
    # traffic of the memory-bound convs; reductions stay f32). GFSK/FSK only.
    compute_dtype: str = "f32"
    # automatic frequency control: track per-channel transmitter drift with
    # a device-side DDC whose frequency is state (GFSK/FSK families)
    afc: bool = False
    sinks: SinkConfig = field(default_factory=SinkConfig)
    channel_map: List[ChannelConfig] = field(default_factory=list)
    _path: Optional[str] = field(default=None, repr=False, compare=False)

    # -- persistence --------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "FrameworkConfig":
        with open(path) as f:
            raw = json.load(f)
        cfg = cls.from_dict(raw)
        cfg._path = path
        return cfg

    @classmethod
    def from_dict(cls, raw: dict) -> "FrameworkConfig":
        raw = dict(raw)                      # never mutate the caller's dict

        def known_only(dc, d):
            names = {f.name for f in dataclasses.fields(dc)}
            # unknown keys are IGNORED like top-level fields: configs from
            # newer versions / hand edits must not abort the decode
            return {k: v for k, v in d.items() if k in names}

        sinks = SinkConfig(**known_only(SinkConfig, raw.pop("sinks", {})))
        chans = [ChannelConfig(**known_only(ChannelConfig, c))
                 for c in raw.pop("channel_map", [])]
        known = {f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")}
        cfg = cls(**{k: v for k, v in raw.items() if k in known and k not in ("sinks", "channel_map")})
        cfg.sinks = sinks
        cfg.channel_map = chans
        return cfg

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("_path", None)
        return d

    def save(self, path: Optional[str] = None) -> None:
        path = path or self._path
        if not path:
            return
        self._path = path
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        os.replace(tmp, path)

    def set(self, key: str, value) -> None:
        """Write-through update (ref main.cpp:343-347 pattern)."""
        setattr(self, key, value)
        self.save()
