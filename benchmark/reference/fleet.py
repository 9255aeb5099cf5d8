"""The reference of a ``fleet`` configuration: the PFB and its groups."""

from benchmark.reference.cells import FleetReference


def build(config, traffic, ring, seed, device):
    return FleetReference(config, traffic, ring, seed, device)
