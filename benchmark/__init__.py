"""The benchmark of the PyTorch and CUDA port (``sondetpu_torch``)."""
