"""Derived atmospheric quantities (counterpart: ``sondetpu/physics.py``).

A copy of the original's host functions, which telemetry needs: the Magnus
dew point and the 7-layer ISA altitude-to-pressure model the reference uses
as a fallback for sondes without a pressure sensor (reference
src/decode/decoder.hpp:132-174). The original's jnp variants are not
carried.
"""

from __future__ import annotations

import math

# ISA layer tables — identical physical constants to the standard atmosphere
# model the reference implements at decoder.hpp:143-151.
_G0 = 9.80665           # gravity, m/s^2
_M = 0.0289644          # molar mass of dry air, kg/mol
_R_STAR = 8.3144598     # universal gas constant, J/(mol K)

_HBS = (0.0, 11000.0, 20000.0, 32000.0, 47000.0, 51000.0, 77000.0)
_LBS = (-0.0065, 0.0, 0.001, 0.0028, 0.0, -0.0028, -0.002)
_PBS = (101325.0, 22632.1, 5474.89, 868.02, 110.91, 66.94, 3.96)
_TBS = (288.15, 216.65, 216.65, 228.65, 270.65, 270.65, 214.65)

_MAGNUS_A = 17.27
_MAGNUS_B = 237.3


def dewpt(temp: float, rh: float) -> float:
    """Magnus-formula dew point from temperature (C) and RH (%).

    Matches reference decoder.hpp:132-137. Returns NaN for rh <= 0 (the
    reference computes log of a non-positive number there too).
    """
    if rh <= 0.0:
        return float("nan")
    tmp = (math.log(rh / 100.0) + (_MAGNUS_A * temp / (_MAGNUS_B + temp))) / _MAGNUS_A
    return _MAGNUS_B * tmp / (1.0 - tmp)


def altitude_to_pressure(alt: float) -> float:
    """ISA barometric pressure (hPa) from altitude (m).

    7-layer standard atmosphere, matching reference decoder.hpp:138-174:
    layer selected as the first whose upper boundary exceeds ``alt`` (so
    negative altitudes use layer 0 and altitudes above the last boundary use
    the top layer).
    """
    b = len(_LBS) - 1
    for i in range(len(_LBS) - 1):
        if alt < _HBS[i + 1]:
            b = i
            break
    Lb, Pb, Tb, hb = _LBS[b], _PBS[b], _TBS[b], _HBS[b]
    if Lb != 0.0:
        return 1e-2 * Pb * ((Tb + Lb * (alt - hb)) / Tb) ** (-(_G0 * _M) / (_R_STAR * Lb))
    return 1e-2 * Pb * math.exp(-_G0 * _M * (alt - hb) / (_R_STAR * Tb))
