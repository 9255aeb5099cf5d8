"""Benchmarks: the FER-vs-SNR sweep (counterpart: ``sondetpu/bench``)."""

from sondetpu_torch.bench.fer import fer_sweep

__all__ = ["fer_sweep"]
