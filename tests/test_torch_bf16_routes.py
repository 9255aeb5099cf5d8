"""bfloat16 on the port's kernel routes against the JAX package on the CPU:
the dual-tone kernel (K7) in bfloat16 through both packages' sessions, and
the K1 and K7 twins on bfloat16 planes against the Pallas kernels in
interpret mode on the same bfloat16 arrays. The signals, the recording of
each block and the tolerances are tests/test_torch_gates.py's (its module
docstring says what must be equal and why the chips are held by
tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sondetpu.dsp.fir import design_lowpass
from sondetpu.pallas.frontend import frontend_chunk
from sondetpu.pallas.frontend import fused_dualtone_frontend as jdual
from sondetpu.pallas.frontend import fused_frontend as jfront
from sondetpu.sondes.m10 import SPEC as M10
from sondetpu_torch.kernels.dualtone import (fused_dualtone_frontend,
                                             mixer_tables)
from sondetpu_torch.kernels.frontend import HALO, fused_frontend
from test_torch_gates import (BLOCK, _config, _np32, _planes, _run_both,
                              _valid)
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

@pytest.mark.parametrize("sonde,afc", [("ims100", False), ("m10", True)],
                         ids=["ims100", "m10-afc"])
def test_bf16_kernel_route_matches_jax(sonde, afc):
    """ims100 on K7's chanfilt body with midpoint DC and m10 on its skip
    body with afc (the envelope-rotation sums feed the loop), use_pallas=
    True in bfloat16: the planes are stored in bfloat16 before K7, as the
    original stores them before its Pallas kernel; 3 blocks as the module
    docstring says; the carried tails are the raw bfloat16 input, HALO
    wide, and without afc equal to JAX's bit for bit (with afc they are
    the DDC's output, which the tracked frequency moves: that within 0.05
    Hz)."""
    kw = _config(sonde=sonde, compute_dtype="bf16", afc=afc)
    qi, qq = _planes(sonde, 8, 3 * BLOCK)
    jrec, _, jsess, tsess = _run_both(kw, qi, qq, route="dualtone")
    js, ts = jsess.state, tsess.state
    assert ts.chan_tail_i.dtype == torch.bfloat16
    assert ts.chan_tail_i.shape == (8, 256)
    if not afc:
        for a, b in ((ts.chan_tail_i, js.chan_tail_i),
                     (ts.chan_tail_q, js.chan_tail_q)):
            np.testing.assert_array_equal(_np32(a), _np32(b))
    else:
        np.testing.assert_allclose(_np32(ts.aux[-1]), _np32(js.aux[-1]),
                                   rtol=0, atol=0.05)
    assert _valid(jrec) >= 8 * 3


def _bf16_np(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("kernel", ["k1-decim1", "k1-decim2",
                                    "k1-m10-fallback", "k7-skip",
                                    "k7-chanfilt-afc"])
def test_bf16_twins_match_pallas(kernel):
    """The K1 and K7 twins on bfloat16 planes and tails against the Pallas
    kernels in interpret mode on the same bfloat16 arrays (both widen to
    float32 and compute there): within the float32 tolerances of
    tests/test_torch_kernels.py and tests/test_torch_families.py (the two
    sum the channel filter's taps in different orders), tails exact; and
    each twin on bfloat16 input equals itself on the widened input bit for
    bit. k1-m10-fallback takes m10's FM fallback's parameters (decim 1,
    its channel filter, lowpass matched taps and scale, as
    sondetpu/runtime/pipeline.py makes them) on a block of 5 mod 8
    samples, as M10_FALLBACK_BLOCK in chip_smoke.py."""
    rng = np.random.default_rng(len(kernel))
    c, n = 8, 9605 if kernel == "k1-m10-fallback" else 9600
    planes = [_bf16_np(rng.normal(size=s).astype(np.float32))
              for s in ((c, n), (c, n), (c, HALO), (c, HALO))]
    jx = [jnp.asarray(p.view(torch.int16).numpy()).view(jnp.bfloat16)
          for p in planes]
    widened = [p.to(torch.float32) for p in planes]
    if kernel.startswith("k1"):
        if kernel == "k1-m10-fallback":
            decim = 1
            ct = design_lowpass(min(M10.bandwidth / 2.0, 0.45 * 48000.0),
                                48000.0, 41)
            mt = design_lowpass(0.55 * M10.baud, 48000.0, 41)
            scale = np.float32(48000.0 / (2.0 * np.pi * M10.dev))
        else:
            decim = int(kernel[-1])
            ct = design_lowpass(5000.0, 48000.0, 41)
            mt = design_lowpass(2640.0, 48000.0 / decim, 41)
            scale = np.float32(48000.0 / decim / (2 * np.pi * 2400.0))
        want = jfront(*jx, jnp.asarray(ct[None]), jnp.asarray(mt[None]),
                      jnp.asarray([[scale]]), ntaps=41, decim=decim,
                      chunk=frontend_chunk(n), dc_block=True, interpret=True)
        got = fused_frontend(*planes, ct, mt, float(scale), decim, True)
        same = fused_frontend(*widened, ct, mt, float(scale), decim, True)
        tol = [(0, 3e-4), (3, 2e-5)]
    else:
        skip = kernel == "k7-skip"
        afc = kernel.endswith("afc")
        nb = 5 if skip else 20
        taps = design_lowpass(0.45 * 48000.0, 48000.0, 41)
        want = jdual(*jx, jnp.asarray(taps[None]), ntaps=41, nb=nb,
                     chunk=frontend_chunk(n), dev_over_fs=0.25,
                     want_afc=afc, skip_chanfilt=skip, interpret=True)
        tabs = [torch.from_numpy(t) for t in mixer_tables(n, 0.25)]
        got = fused_dualtone_frontend(*planes, taps, *tabs, nb, afc, skip)
        same = fused_dualtone_frontend(*widened, taps, *tabs, nb, afc, skip)
        tol = [(0, 1e-5)] + [(k, 1e-5 * max(float(np.abs(np.asarray(
            want[k])).max()), 1e-30)) for k in (3, 4, 5)]
    for k, atol in tol:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=atol)
        assert torch.equal(got[k], same[k])
    for k in (1, 2):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np32(got[k]), _np32(want[k]))
