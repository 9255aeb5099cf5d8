"""Sonde families of the port (counterpart: ``sondetpu/sondes``): rs41,
rs41x, m10, dfm, imet4 and c50. Importing this package registers them."""

from sondetpu_torch.sondes.base import (ProtocolSpec, SondeDecoderBase,
                                        get_sonde, register_sonde)
from sondetpu_torch.sondes import rs41 as _rs41  # noqa: F401
from sondetpu_torch.sondes import m10 as _m10  # noqa: F401
from sondetpu_torch.sondes import dfm as _dfm  # noqa: F401
from sondetpu_torch.sondes import imet4 as _imet4  # noqa: F401
from sondetpu_torch.sondes import c50 as _c50  # noqa: F401

__all__ = ["ProtocolSpec", "SondeDecoderBase", "get_sonde", "register_sonde"]
