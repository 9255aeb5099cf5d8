"""Hand-written CUDA kernels of the port and their plain torch twins
(counterpart: ``sondetpu/pallas`` and ``tools/exp_chanfilt.py:lane_fir``).

- ``frontend.fused_frontend``: channel filter + decimation + FM
  discriminator + matched FIR (``csrc/frontend.cu``);
- ``corr.corr_kernel``: syncword correlation (``csrc/corr.cu``);
- ``syndrome.rs_clean_flags_kernel``: RS syndrome flag (``csrc/syndrome.cu``);
- ``pfb.pfb_fir_stream``/``pfb_fir_timemajor``/``pfb_dft``: the PFB
  channelizer (``csrc/pfb.cu``, ``csrc/pfb_dft.cu``); ``pfb_cases``: the
  edge-value planes its bf16 FIR is held to the twin on;
- ``dualtone.fused_dualtone_frontend``: the m10 front end
  (``csrc/dualtone.cu``);
- ``afsk.fused_afsk_frontend``: the AFSK tone discriminator
  (``csrc/afsk.cu``);
- ``frontend.fused_demod_fir``: FM discriminator + DC + FIR without a
  channel filter (``csrc/demod_fir.cu``);
- ``lane_fir.lane_fir``: the lane experiment's FIR (``csrc/lane_fir.cu``);
  ``lane_fir.plain_corr``: the plain syncword correlation on the same
  design (the second entry of ``csrc/lane_fir.cu``), which
  ``sync.correlate_syncword`` launches on the card.

``cuda`` builds and loads the library and counts launches.
"""
