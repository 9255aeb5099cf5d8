"""Batched DSP: filter design and streaming FIR, demodulation, AGC and
resampling (counterpart: ``sondetpu/dsp``, with the same exports).

The channelizer and the spectrum scan live in ``dsp.channelizer`` and
``dsp.scan``; like the original, the package exports only the filter,
demodulator and resampler API.
"""

from sondetpu_torch.dsp.fir import (
    design_lowpass,
    gaussian_taps,
    fir_filter,
    FIRState,
    fir_init,
    fir_apply,
)
from sondetpu_torch.dsp.demod import (fm_demod, FMState, fm_init, fm_apply,
                                      afsk_discriminate)
from sondetpu_torch.dsp.resample import polyphase_decimate, rational_resample

__all__ = [
    "design_lowpass",
    "gaussian_taps",
    "fir_filter",
    "FIRState",
    "fir_init",
    "fir_apply",
    "fm_demod",
    "FMState",
    "fm_init",
    "fm_apply",
    "afsk_discriminate",
    "polyphase_decimate",
    "rational_resample",
]
