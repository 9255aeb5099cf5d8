"""Telemetry data model and fragment merging (a copy of
``sondetpu/telemetry.py``; its classes are the port's own, so compare them
with the original's through ``to_dict``/``asdict``, never with ``==``).

Re-designs the reference's L5 aggregation layer: the fragment bitmask protocol
(``SondeData.fields``) and the running full-telemetry merge performed by the
decoder adapter (reference: src/decode/decoder.hpp:61-115, field masks
decoder.hpp:64-106) and the full data model (src/decode/common.hpp:4-28).

Decoders emit :class:`TelemetryFragment` objects — partial observations with a
``fields`` bitmask saying which members are valid — and a per-channel
:class:`SondeTelemetry` accumulates them into the latest complete picture,
computing derived quantities (dew point, ISA pressure fallback) exactly as the
reference does (decoder.hpp:91-110,132-174).
"""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass

from sondetpu_torch.physics import altitude_to_pressure, dewpt


class Fields(enum.IntFlag):
    """Validity bitmask for a telemetry fragment.

    Mirrors the semantics of the reference's DATA_* flags consumed at
    decoder.hpp:64-106 (DATA_SEQ, DATA_POS, DATA_SPEED, DATA_TIME, DATA_PTU,
    DATA_SERIAL, DATA_SHUTDOWN, DATA_OZONE).
    """

    NONE = 0
    SEQ = 1 << 0
    POS = 1 << 1
    SPEED = 1 << 2
    TIME = 1 << 3
    PTU = 1 << 4
    SERIAL = 1 << 5
    SHUTDOWN = 1 << 6
    OZONE = 1 << 7


@dataclass
class TelemetryFragment:
    """One decoder output: a partial telemetry observation.

    Only members whose flag is set in ``fields`` are meaningful — exactly the
    contract of the reference's ``SondeData`` fragment (decoder.hpp:61-106).
    """

    fields: Fields = Fields.NONE
    seq: int = 0                    # frame sequence number        [SEQ]
    lat: float = 0.0                # degrees                      [POS]
    lon: float = 0.0                # degrees                      [POS]
    alt: float = 0.0                # metres                       [POS]
    speed: float = 0.0              # m/s ground speed             [SPEED]
    heading: float = 0.0            # degrees                      [SPEED]
    climb: float = 0.0              # m/s                          [SPEED]
    time: float = 0.0               # onboard UTC epoch seconds    [TIME]
    calib_percent: float = 0.0      # 0-100                        [PTU]
    temp: float = 0.0               # degrees C                    [PTU]
    rh: float = 0.0                 # percent                      [PTU]
    pressure: float = 0.0           # hPa; <=0 means "no sensor"   [PTU]
    serial: str = ""                # sonde serial number          [SERIAL]
    shutdown: int = -1              # burstkill countdown seconds  [SHUTDOWN]
    o3_mpa: float = 0.0             # ozone partial pressure, mPa  [OZONE]


@dataclass
class SondeTelemetry:
    """Running full telemetry for one channel.

    The merge semantics replicate the reference adapter's accumulation loop
    (decoder.hpp:63-110): each fragment overwrites only the field groups it
    carries; dew point is recomputed on every PTU update; the ISA barometric
    model supplies pressure when the sonde has no pressure sensor
    (decoder.hpp:108-110); ozone is formatted into the freeform aux string
    (decoder.hpp:102-106).
    """

    serial: str = ""
    seq: int = 0
    time: float = 0.0
    burstkill: int = 0
    lat: float = 0.0
    lon: float = 0.0
    alt: float = 0.0
    spd: float = 0.0
    hdg: float = 0.0
    climb: float = 0.0
    temp: float = 0.0
    rh: float = 0.0
    dewpt: float = 0.0
    pressure: float = 0.0
    calibrated: bool = False
    calib_percent: float = 0.0
    aux_data: str = ""

    def reset(self) -> None:
        """Reinitialize, as the reference does on type switch (common.hpp:6-15)."""
        fresh = SondeTelemetry()
        for k, v in asdict(fresh).items():
            setattr(self, k, v)

    def merge(self, frag: TelemetryFragment) -> bool:
        """Merge a fragment into the running telemetry.

        Returns True when the fragment carried any data (the reference only
        fires its sink callback in that case, decoder.hpp:112-114).

        Bitmask tests run on plain ints: at >100k fragments/s per host this
        loop is hot, and enum.Flag.__and__ costs ~10x an int and
        (profiled: 55% of merge time).
        """
        f = int(frag.fields)
        if f & 1:                       # Fields.SEQ
            self.seq = frag.seq
        if f & 2:                       # Fields.POS
            self.lat = frag.lat
            self.lon = frag.lon
            self.alt = frag.alt
        if f & 4:                       # Fields.SPEED
            self.spd = frag.speed
            self.hdg = frag.heading
            self.climb = frag.climb
        if f & 8:                       # Fields.TIME
            self.time = frag.time
        if f & 16:                      # Fields.PTU
            self.calib_percent = frag.calib_percent
            self.calibrated = frag.calib_percent >= 100.0
            self.temp = frag.temp
            self.rh = frag.rh
            self.pressure = frag.pressure
            self._isa_pressure = False
            self.dewpt = dewpt(frag.temp, frag.rh)
        if f & 32:                      # Fields.SERIAL
            self.serial = frag.serial
        if f & 64:                      # Fields.SHUTDOWN
            self.burstkill = frag.shutdown
        if f & 128:                     # Fields.OZONE
            # Reference formats ozone into the aux string with 2 decimals
            # (decoder.hpp:102-106).
            self.aux_data = f"O3={frag.o3_mpa:.2f}mPa"
        if self.pressure <= 0 or (getattr(self, "_isa_pressure", False)
                                  and f & 2):
            # ISA barometric fallback (decoder.hpp:108-110). Recomputed on
            # every POS update while the value is ISA-derived — otherwise a
            # stretch of POS-only fragments (MEAS CRC failures) would leave
            # the reported pressure frozen at an old altitude.
            self.pressure = altitude_to_pressure(self.alt)
            self._isa_pressure = True
        return f != 0

    def snapshot(self) -> "SondeTelemetry":
        """Cheap copy for update fan-out (~5x faster than
        dataclasses.replace, which re-runs __init__ field processing)."""
        s = SondeTelemetry.__new__(SondeTelemetry)
        s.__dict__.update(self.__dict__)
        return s

    def to_dict(self) -> dict:
        return asdict(self)
