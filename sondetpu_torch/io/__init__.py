"""IO: IQ sources and telemetry sinks (a copy of ``sondetpu/io``)."""

from sondetpu_torch.io.gpx import GPXWriter, MultiGPXWriter
from sondetpu_torch.io.ptu import PTUWriter
from sondetpu_torch.io.jsonl import JSONLWriter
from sondetpu_torch.io.iq import IQFileSource, iq_from_file, write_iq

__all__ = [
    "GPXWriter", "MultiGPXWriter",
    "PTUWriter",
    "JSONLWriter",
    "IQFileSource",
    "iq_from_file",
    "write_iq",
]
