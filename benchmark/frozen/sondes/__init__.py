"""The frozen sonde families: rs41 (and rs41x), m10, dfm."""

from benchmark.frozen.sondes.base import ProtocolSpec, get_sonde  # noqa: F401
from benchmark.frozen.sondes import rs41 as _rs41  # noqa: F401
from benchmark.frozen.sondes import m10 as _m10  # noqa: F401
from benchmark.frozen.sondes import dfm as _dfm  # noqa: F401
