"""Derived atmospheric quantities (counterpart: ``sondetpu/physics.py``).

A copy of the original's host functions, which telemetry needs: the Magnus
dew point and the 7-layer ISA altitude-to-pressure model the reference uses
as a fallback for sondes without a pressure sensor (reference
src/decode/decoder.hpp:132-174). ``dewpt_torch`` and
``altitude_to_pressure_torch`` are the original's batched jnp variants in
float32 tensors (its layer tables are float32, as ``jnp.asarray`` makes
them without float64); the original's names ``dewpt_jnp`` and
``altitude_to_pressure_jnp`` resolve to them. Their divisions by constants
are divisions by 0-d tensors: on a CUDA tensor ``x / c`` would multiply by
fl(1/c), and ``c / x`` is a reciprocal times c.
"""

from __future__ import annotations

import math

import torch

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


def _f32(x, device) -> torch.Tensor:
    """x as a tensor: one stays on its device (float64 and integers made
    float32, as the original runs without float64); anything else goes to
    ``device`` as float32."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float64 or not x.is_floating_point():
            return x.to(torch.float32)
        return x
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def dewpt_torch(temp, rh, device="cuda") -> torch.Tensor:
    """Batched Magnus dew point (the tensor variant of :func:`dewpt`; NaN
    for rh <= 0 through the log). A non-tensor input goes to the device of
    the other when that is a tensor, else to ``device``."""
    dev = next((v.device for v in (temp, rh) if isinstance(v, torch.Tensor)),
               device)
    temp, rh = _f32(temp, dev), _f32(rh, dev)
    tmp = (torch.log(rh / _c(100.0, rh))
           + (_MAGNUS_A * temp / (_MAGNUS_B + temp))) / _c(_MAGNUS_A, rh)
    return _MAGNUS_B * tmp / (1.0 - tmp)


def altitude_to_pressure_torch(alt, device="cuda") -> torch.Tensor:
    """Batched ISA pressure in hPa (the tensor variant of
    :func:`altitude_to_pressure`): the first layer whose upper boundary
    exceeds ``alt``, the top layer above the last boundary."""
    alt = _f32(alt, device)
    dev = alt.device
    hbs, lbs, pbs, tbs = (torch.tensor(t, dtype=torch.float32, device=dev)
                          for t in (_HBS, _LBS, _PBS, _TBS))
    b = torch.clamp(torch.searchsorted(hbs[1:], alt.reshape(-1).contiguous(),
                                       right=True), 0, len(_LBS) - 1
                    ).reshape(alt.shape)
    Lb, Pb, Tb, hb = lbs[b], pbs[b], tbs[b], hbs[b]
    expo = _c(-(_G0 * _M), alt) / (
        _R_STAR * torch.where(Lb == 0, _c(1.0, alt), Lb))
    grad = 1e-2 * Pb * torch.pow(
        torch.clamp_min((Tb + Lb * (alt - hb)) / Tb, 1e-9), expo)
    iso = 1e-2 * Pb * torch.exp(-_G0 * _M * (alt - hb) / (_R_STAR * Tb))
    return torch.where(Lb == 0.0, iso, grad)


# the original's names
dewpt_jnp = dewpt_torch
altitude_to_pressure_jnp = altitude_to_pressure_torch
