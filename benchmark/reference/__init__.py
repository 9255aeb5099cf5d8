"""The plain reference the benchmark judges the program against.

Plain PyTorch and NumPy, on the frozen protocol code of
``benchmark.frozen``; nothing here imports the program, JAX, or the JAX
package. A configuration names its reference module by its ``reference``
key (``pipeline`` or ``fleet``), which exposes ``build(config, traffic,
ring, seed, device)``.
"""
