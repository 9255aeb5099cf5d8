"""Geodesy and GPS time conversions (counterpart: ``sondetpu/sondes/geo.py``).

A copy of the original: it is reached only through ``sondetpu.sondes``,
whose package import pulls in jax.

ECEF <-> WGS84 geodetic, ECEF velocity -> speed/heading/climb, and GPS
week/time-of-week -> UTC — the telemetry/geo math sondedump performs before
filling SondeData (outputs consumed at reference decoder.hpp:64-99).
Vectorized NumPy (host-side; a handful of frames per channel per second).
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_B = _A * (1.0 - _F)
_E2 = _F * (2.0 - _F)
_EP2 = (_A * _A - _B * _B) / (_B * _B)

# GPS epoch 1980-01-06T00:00:00Z as Unix epoch seconds; current leap offset.
GPS_EPOCH_UNIX = 315964800
GPS_UTC_LEAP_SECONDS = 18


def geodetic_to_ecef(lat_deg, lon_deg, alt_m):
    """WGS84 geodetic -> ECEF metres. Arrays or scalars."""
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    alt = np.asarray(alt_m, dtype=np.float64)
    n = _A / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - _E2) + alt) * np.sin(lat)
    return x, y, z


def ecef_to_geodetic(x, y, z):
    """ECEF metres -> WGS84 geodetic (Bowring's closed-form approximation,
    sub-millimetre for terrestrial/stratospheric altitudes)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    theta = np.arctan2(z * _A, p * _B)
    lat = np.arctan2(z + _EP2 * _B * np.sin(theta) ** 3,
                     p - _E2 * _A * np.cos(theta) ** 3)
    n = _A / np.sqrt(1.0 - _E2 * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    return np.degrees(lat), np.degrees(lon), alt


def ecef_velocity_to_enu(vx, vy, vz, lat_deg, lon_deg):
    """ECEF velocity -> local East/North/Up components."""
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    ve = -np.sin(lon) * vx + np.cos(lon) * vy
    vn = (-np.sin(lat) * np.cos(lon) * vx - np.sin(lat) * np.sin(lon) * vy
          + np.cos(lat) * vz)
    vu = (np.cos(lat) * np.cos(lon) * vx + np.cos(lat) * np.sin(lon) * vy
          + np.sin(lat) * vz)
    return ve, vn, vu


def enu_to_ecef_velocity(ve, vn, vu, lat_deg, lon_deg):
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    vx = -np.sin(lon) * ve - np.sin(lat) * np.cos(lon) * vn + np.cos(lat) * np.cos(lon) * vu
    vy = np.cos(lon) * ve - np.sin(lat) * np.sin(lon) * vn + np.cos(lat) * np.sin(lon) * vu
    vz = np.cos(lat) * vn + np.sin(lat) * vu
    return vx, vy, vz


def speed_heading_climb(ve, vn, vu):
    """ENU velocity -> (ground speed m/s, heading deg from north, climb m/s)."""
    spd = np.hypot(ve, vn)
    hdg = np.degrees(np.arctan2(ve, vn)) % 360.0
    return spd, hdg, vu


def gps_time_to_utc(week, tow_seconds, leap=GPS_UTC_LEAP_SECONDS):
    """GPS week + time-of-week -> Unix UTC epoch seconds."""
    return GPS_EPOCH_UNIX + np.asarray(week, dtype=np.float64) * 604800.0 \
        + np.asarray(tow_seconds, dtype=np.float64) - leap


def utc_to_gps_time(utc_epoch, leap=GPS_UTC_LEAP_SECONDS):
    """Unix UTC epoch seconds -> (week, tow_seconds)."""
    t = np.asarray(utc_epoch, dtype=np.float64) - GPS_EPOCH_UNIX + leap
    week = np.floor(t / 604800.0)
    tow = t - week * 604800.0
    return week.astype(np.int64), tow


def ymd_sod_to_utc(year, month, day, seconds_of_day):
    """Calendar date (UTC) + seconds-of-day -> Unix epoch seconds.

    Civil-date arithmetic (Howard Hinnant's days_from_civil algorithm) —
    no libc dependency, valid for any Gregorian date."""
    y = int(year) - (1 if int(month) <= 2 else 0)
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    m = int(month)
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + int(day) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    days = era * 146097 + doe - 719468
    return days * 86400.0 + float(seconds_of_day)


def utc_to_ymd_sod(utc_epoch):
    """Unix epoch seconds -> (year, month, day, seconds_of_day), UTC."""
    t = float(utc_epoch)
    days = int(np.floor(t / 86400.0))
    sod = t - days * 86400.0
    z = days + 719468
    era = (z if z >= 0 else z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + (3 if mp < 10 else -9)
    return y + (1 if m <= 2 else 0), m, d, sod
