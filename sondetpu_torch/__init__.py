"""sondetpu_torch — the decode paths of sondetpu in PyTorch and CUDA.

A second package beside :mod:`sondetpu` (the JAX reference). Plain tensor
code is PyTorch; each Pallas kernel on the path is a hand-written CUDA
kernel for Hopper (``csrc/``), built with nvcc at first use and bound with
ctypes. Every kernel has a plain-torch twin in its module: the twin runs
when the inputs lie on the CPU, the kernel when they lie on a CUDA device.

Module names mirror the JAX package (``runtime.pipeline`` <->
``sondetpu.runtime.pipeline`` and so on). The package imports torch and
numpy and nothing of :mod:`sondetpu`: the host modules it needs (telemetry,
physics, the FEC with its native C++, the families' parsers) are carried
here as copies, each held equal to its original by a test.
"""

__version__ = "0.1.0"

from sondetpu_torch.telemetry import SondeTelemetry, TelemetryFragment, Fields

__all__ = ["SondeTelemetry", "TelemetryFragment", "Fields", "__version__"]
