"""The system under test: thin adapters over ``sondetpu_torch``.

A configuration names its adapter by its ``entry`` key. An adapter module
exposes ``build(torch, config, device, ring)``, returning an object with
``step(inputs) -> (packed, frames)``, the program's entry called once a
block (``packed``: the flat buffer the program reads back; ``frames``: its
per-group full-frame tensors), and ``host_decode(rows, frames)``, the
program's host decode of the sampled rows of one block. These are the only
modules of the benchmark that import the program.
"""
