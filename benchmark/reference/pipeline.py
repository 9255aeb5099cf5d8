"""The reference of a ``pipeline`` configuration: one family per channel."""

from benchmark.reference.cells import PipelineReference


def build(config, traffic, ring, seed, device):
    return PipelineReference(config, traffic, ring, seed, device)
