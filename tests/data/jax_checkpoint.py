"""A session checkpoint that the JAX package wrote, for the port to load.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_checkpoint.py

writes ``tests/data/jax_rs41_bf16_afc.ckpt``: the JAX ``DecoderSession`` of
``RECIPE`` (rs41, 8 channels, one serial and carrier offset each, bf16 on
the plain-op path, AFC on) saved after ``blocks_saved`` one-second blocks,
when every channel has its full calibration; and
``tests/data/jax_rs41_bf16_afc.json``: the recipe and the JAX session's
telemetry after it continued through the remaining blocks. The signal
comes from :func:`planes`, which uses only the port's modulator (equal to
the JAX package's bit for bit, ``tests/test_torch_host.py``), so the tests
and ``chip_smoke.py`` regenerate it without jax.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "jax_rs41_bf16_afc.ckpt")
EXPECTED = os.path.join(HERE, "jax_rs41_bf16_afc.json")
RECIPE = {"sonde": "rs41", "channels": 8, "block_len": 48000,
          "compute_dtype": "bf16", "afc": True, "frames": 68,
          "first_frame": 100, "offset_hz": 350.0, "noise": 0.05, "seed": 5,
          "blocks_saved": 33, "blocks": 36}


def planes(recipe=RECIPE):
    """float32 (i, q) planes [channels, blocks * block_len]: channel ch
    carries serial S76543{ch:02d}'s frames, shifted by
    (ch - 3.5) * offset_hz, with complex noise of std ``noise``."""
    from sondetpu_torch.sondes.modulate import freq_shift
    from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth

    c, n = recipe["channels"], recipe["blocks"] * recipe["block_len"]
    rng = np.random.default_rng(recipe["seed"])
    out = np.zeros((2, c, n), np.float32)
    for ch in range(c):
        iq = RS41Modulator().modulate(
            [RS41Truth(serial=f"S76543{ch:02d}",
                       frame_no=recipe["first_frame"] + k, temp=-30.0 + ch)
             for k in range(recipe["frames"])], fs=48000.0)[:n]
        iq = freq_shift(iq, (ch - 3.5) * recipe["offset_hz"] / 48000.0)
        iq = iq + (recipe["noise"] * (rng.normal(size=iq.size)
                                      + 1j * rng.normal(size=iq.size)))
        out[0, ch, :iq.size] = iq.real
        out[1, ch, :iq.size] = iq.imag
    return out[0], out[1]


def telemetry_json(telemetry) -> dict:
    return {str(ch): json.dumps(t.to_dict(), sort_keys=True)
            for ch, t in sorted(telemetry.items())}


def main():
    from sondetpu.runtime import checkpoint
    from sondetpu.runtime.pipeline import PipelineConfig
    from sondetpu.runtime.session import DecoderSession

    r = RECIPE
    pi, pq = planes()
    cfg = PipelineConfig(sonde=r["sonde"], channels=r["channels"],
                         block_len=r["block_len"],
                         compute_dtype=r["compute_dtype"], afc=r["afc"])
    sess = DecoderSession(cfg)
    b = r["block_len"]
    for k in range(r["blocks"]):
        if k == r["blocks_saved"]:
            assert all(t.calibrated for t in sess.telemetry.values())
            assert len(sess.telemetry) == r["channels"]
            checkpoint.save_session(sess, CKPT)
        sess.process_block((pi[:, k * b:(k + 1) * b],
                            pq[:, k * b:(k + 1) * b]))
    with open(EXPECTED, "w") as f:
        json.dump({"recipe": r, "telemetry": telemetry_json(sess.telemetry),
                   "frames_seen": sess.frames_seen}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    print(CKPT, os.path.getsize(CKPT), "bytes", file=sys.stderr)


if __name__ == "__main__":
    main()
