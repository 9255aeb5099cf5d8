"""Hand-written CUDA kernels of the port and their plain torch twins
(counterpart: ``sondetpu/pallas``).

- ``frontend.fused_frontend``: channel filter + decimation + FM
  discriminator + matched FIR (``csrc/frontend.cu``);
- ``corr.corr_kernel``: syncword correlation (``csrc/corr.cu``);
- ``syndrome.rs_clean_flags_kernel``: RS syndrome flag (``csrc/syndrome.cu``).

``cuda`` builds and loads the library and counts launches.
"""
