"""Sonde families of the port (counterpart: ``sondetpu/sondes``): rs41 and
rs41x. Importing this package registers them."""

from sondetpu_torch.sondes.base import (ProtocolSpec, SondeDecoderBase,
                                        get_sonde, register_sonde)
from sondetpu_torch.sondes import rs41 as _rs41  # noqa: F401

__all__ = ["ProtocolSpec", "SondeDecoderBase", "get_sonde", "register_sonde"]
