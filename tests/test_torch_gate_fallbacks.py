"""The original's block gate and the jnp AFSK front end's carried state,
against the JAX package on the CPU: a block shorter than the kernels'
carried tail takes the jnp front end in both packages, state by state;
a mid-stream JAX state of the jnp AFSK front end continues in the port
and back. The signals, the recording of each block and what must be
equal (and why the chips are held by tolerance) are
tests/test_torch_gates.py's, whose parametrised test also holds the
channel gate (12 channels) and the jnp AFSK front end's sessions.
"""

import warnings

import numpy as np
import pytest

from sondetpu.runtime import pipeline as jpipe
from sondetpu_torch.runtime import pipeline as tpipe
from test_torch_gates import (CHIP_TOL, CPU, _config, _np32, _planes,
                              _run_both, _valid)
import torch_cpu_threads  # noqa: F401  (one torch thread per worker)


# --- the original's block gate (C.1) -----------------------------------------

def _state_np(state):
    """The carried leaves of a state (either package's) as float32 NumPy
    copies, taken at once (the JAX step donates its state)."""
    return {"chan_tail_i": _np32(state.chan_tail_i),
            "chan_tail_q": _np32(state.chan_tail_q),
            "fm_prev": _np32(state.fm_prev), "fir": _np32(state.fir.tail),
            "pos": _np32(state.timing.pos), "chipbuf": _np32(state.chipbuf),
            "buf_fill": np.array(np.asarray(state.buf_fill))}


def _record_states(pipe, states):
    step = pipe.step

    def wrapped(state, iq):
        state, out = step(state, iq)
        states.append(_state_np(state))
        return state, out

    pipe.step = wrapped


@pytest.mark.parametrize("sonde,n_blocks", [("rs41", 220), ("m10", 80)])
def test_block_gate_takes_the_jnp_front_end(sonde, n_blocks):
    """use_pallas=True with blocks of 240 samples, shorter than the
    kernels' HALO = 256 (the original's frontend_chunk is None): the jnp
    front end in both packages, until every channel has crossed a frame
    (1.1 s of rs41, 0.4 s of m10: all eight decode after 1.07 s and 0.35
    s). Block by block: the exact checks of the module docstring and the
    carried state, the raw input tails and buf_fill exactly, fm_prev and
    the audio tail within 1e-5 of their range, the timing phase within
    5e-3 samples and the chip ring within CHIP_TOL; then the same
    telemetry on every channel (each its truth)."""
    block = 240
    kw = _config(sonde=sonde, block_len=block)
    qi, qq = _planes(sonde, 8, n_blocks * block)
    jstates, tstates = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = jpipe.Pipeline(jpipe.PipelineConfig(**kw))
        tp = tpipe.Pipeline(tpipe.PipelineConfig(**kw), CPU)
    assert not (jp._pallas or jp._pallas_dualtone) and tp._route is None
    _record_states(jp, jstates)
    _record_states(tp, tstates)
    jrec, _, _, tsess = _run_both(kw, qi, qq, block, route=None,
                                  pipes=(jp, tp))
    assert len(jstates) == len(tstates) == n_blocks
    for js, ts in zip(jstates, tstates):
        for key in ("chan_tail_i", "chan_tail_q", "buf_fill"):
            np.testing.assert_array_equal(ts[key], js[key])
        for key in ("fm_prev", "fir"):
            np.testing.assert_allclose(ts[key], js[key], rtol=0, atol=1e-5
                                       * max(np.abs(js[key]).max(), 1.0))
        np.testing.assert_allclose(ts["pos"], js["pos"], atol=5e-3)
        np.testing.assert_allclose(ts["chipbuf"], js["chipbuf"],
                                   atol=CHIP_TOL)
    assert _valid(jrec) >= 8
    assert sorted(tsess.telemetry) == list(range(8))


# --- the jnp AFSK front end (A1) ---------------------------------------------

def test_plain_afsk_continues_a_jax_state():
    """imet4 on the jnp AFSK front end with 48040-sample blocks (its tones'
    joint period L = 240 does not divide them: the LO phase counter is not
    zero between blocks): JAX runs block 1, the port runs block 2 from
    JAX's state, JAX runs block 3 from the port's; each block's validity
    and valid frames equal a run that never left the JAX package."""
    block = 48040
    kw = _config(sonde="imet4", use_pallas=False, block_len=block)
    cfg = jpipe.PipelineConfig(**kw)
    qi, qq = _planes("imet4", 8, 3 * block, seed=3)
    jp, tp = jpipe.Pipeline(cfg), tpipe.Pipeline(tpipe.PipelineConfig(**kw),
                                                 CPU)
    blocks = [(qi[:, b * block:(b + 1) * block],
               qq[:, b * block:(b + 1) * block]) for b in range(3)]
    ref, outs = jp.init_state(), []
    for blk in blocks:
        ref, o = jp.step(ref, blk)
        outs.append(o)
    js, _ = jp.step(jp.init_state(), blocks[0])
    assert int(np.asarray(js.aux[4])[0]) == block % 240 != 0
    ts, to = tp.step(tpipe.state_from_numpy(js, CPU), blocks[1])
    assert int(ts.aux[4][0]) == 2 * block % 240
    back = tpipe.state_to_numpy(ts)
    js = jpipe.PipelineState(
        chan_tail_i=back.chan_tail_i, chan_tail_q=back.chan_tail_q,
        fm_prev=back.fm_prev, fir=jpipe.FIRState(tail=back.fir.tail),
        timing=jpipe.TimingState(pos=back.timing.pos,
                                 locked=back.timing.locked),
        chipbuf=back.chipbuf, buf_fill=back.buf_fill, aux=back.aux)
    _, jo = jp.step(js, blocks[2])
    for got, want in ((to, outs[1]), (jo, outs[2])):
        v = np.asarray(want.frame_valid)
        np.testing.assert_array_equal(np.asarray(got.frame_valid), v)
        np.testing.assert_array_equal(np.asarray(got.frames)[v],
                                      np.asarray(want.frames)[v])
    assert int(np.asarray(outs[2].frame_valid).sum()) >= 8
