"""Frozen copies of the program's protocol code, for the benchmark.

The sonde families' specs, frame assembly and modulators (RS41, M10,
DFM; their decoders left out), with the FEC, line coding and filter design
they need, copied from ``sondetpu_torch`` as they stood when the benchmark
was written. The traffic generators and the reference read these and never the
program, so that a later change to the program cannot move the yardstick.
``roofline`` holds the frozen operation and byte counts of the kernels.
"""
