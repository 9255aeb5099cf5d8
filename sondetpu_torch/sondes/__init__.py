"""Sonde families of the port (counterpart: ``sondetpu/sondes``): all eight
of the original's (rs41 with rs41x, m10, dfm, ims100, imet4, c50, mrzn1),
registered in its order; ``SUPPORTED_TYPES`` names them sorted, as the
original's does. Importing this package registers them."""

from sondetpu_torch.sondes.base import (ProtocolSpec, SondeDecoderBase,
                                        get_sonde, register_sonde)
from sondetpu_torch.sondes import rs41 as _rs41  # noqa: F401
from sondetpu_torch.sondes import m10 as _m10  # noqa: F401
from sondetpu_torch.sondes import dfm as _dfm  # noqa: F401
from sondetpu_torch.sondes import ims100 as _ims100  # noqa: F401
from sondetpu_torch.sondes import imet4 as _imet4  # noqa: F401
from sondetpu_torch.sondes import c50 as _c50  # noqa: F401
from sondetpu_torch.sondes import mrzn1 as _mrzn1  # noqa: F401

from sondetpu_torch.sondes.base import _REGISTRY

SUPPORTED_TYPES = tuple(sorted(_REGISTRY))

__all__ = ["ProtocolSpec", "SondeDecoderBase", "get_sonde", "register_sonde",
           "SUPPORTED_TYPES"]
