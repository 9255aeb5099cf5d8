"""Protocol spec and the sonde registry (counterpart:
``sondetpu/sondes/base.py``), frozen for the benchmark.

A jax-free copy: the original is reached only through ``sondetpu.sondes``,
whose package import pulls in every family and with them jax. The port's
registry holds the families of the port (rs41, rs41x, m10, dfm,
imet4 and c50).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np



@dataclass(frozen=True)
class ProtocolSpec:
    name: str                 # registry key, e.g. "rs41"
    display_name: str         # UI name
    bandwidth: float          # channel bandwidth, Hz
    baud: float               # symbol rate on air, Bd
    modulation: str           # "gfsk" | "fsk" | "afsk"
    syncword: bytes           # on-air sync pattern (scrambled domain)
    lsb_first: bool           # on-air bit order within bytes
    frame_bytes: int          # frame length in bytes incl. syncword
    line_code: str = "nrz"    # "nrz" | "manchester" | "biphase_m"
    deviation: Optional[float] = None   # FSK deviation; default bandwidth/2
    afsk_mark: Optional[float] = None   # AFSK tone frequencies
    afsk_space: Optional[float] = None
    extra: dict = field(default_factory=dict)

    @property
    def dev(self) -> float:
        return self.deviation if self.deviation is not None else self.bandwidth / 2.0

    @property
    def chips_per_frame(self) -> int:
        """On-air chips per frame (after any line-code expansion)."""
        mult = 2 if self.line_code in ("manchester", "biphase_m") else 1
        return self.frame_bytes * 8 * mult

    def sync_chip_template(self, syncword: "bytes | None" = None,
                           bits: "np.ndarray | None" = None) -> "np.ndarray":
        """+/-1 chip-domain correlation template for the syncword (see the
        original for the line-code and alternate-sync conventions)."""
        from benchmark.frozen.sync.coding import np_bytes_to_bits

        if bits is None and syncword is None:
            bits = self.extra.get("sync_bits")
        if bits is not None:
            bits = np.asarray(bits, dtype=np.float32)
        else:
            bits = np_bytes_to_bits(
                np.frombuffer(syncword or self.syncword, dtype=np.uint8),
                self.lsb_first)
        if self.line_code == "manchester":
            chips = np.empty(bits.size * 2, dtype=np.float32)
            chips[0::2] = bits
            chips[1::2] = 1 - bits
        elif self.line_code == "biphase_m":
            chips = np.empty(bits.size * 2, dtype=np.float32)
            level = 0
            for k, b in enumerate(bits):
                level ^= 1
                chips[2 * k] = level
                if b:
                    level ^= 1
                chips[2 * k + 1] = level
        else:
            chips = bits.astype(np.float32)
        return chips * 2.0 - 1.0


_REGISTRY: Dict[str, dict] = {}


def register_sonde(name: str, spec: ProtocolSpec, modulator_cls):
    _REGISTRY[name] = {"spec": spec, "modulator": modulator_cls}


def get_sonde(name: str) -> dict:
    if name not in _REGISTRY:
        raise KeyError(f"unknown sonde type {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
