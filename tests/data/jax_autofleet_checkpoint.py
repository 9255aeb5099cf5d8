"""An AutoFleet checkpoint that the JAX package wrote, for the port to load.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_autofleet_checkpoint.py

writes ``tests/data/jax_autofleet.ckpt``: the JAX ``AutoFleet`` of
``RECIPE`` (4 bins of 48 kHz, an rs41 carrier 1.5 kHz above bin 1 and an
m10 carrier in bin -1, AFC on) saved after ``blocks_saved`` one-second
blocks, when both carriers are tracked; and
``tests/data/jax_autofleet.json``: the recipe and the update stream of a
fresh JAX AutoFleet that loaded the checkpoint and ran the remaining
blocks. The signal comes from :func:`wideband`, which uses only the port's
modulators (equal to the JAX package's bit for bit,
``tests/test_torch_host.py``), so the tests regenerate it without jax.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "jax_autofleet.ckpt")
EXPECTED = os.path.join(HERE, "jax_autofleet.json")
RECIPE = {"n_bins": 4, "block_len": 48000, "rescan_blocks": 3,
          "probe_blocks": 2, "families": ["rs41", "m10"], "afc": True,
          "rs41_hz": 48000.0 + 1500.0, "m10_hz": -48000.0,
          "rs41_frames": 16, "m10_frames": 50, "noise": 0.02, "seed": 11,
          "blocks_saved": 5, "blocks": 8}


def autofleet_kwargs(recipe=RECIPE) -> dict:
    return {k: recipe[k] for k in ("n_bins", "block_len", "rescan_blocks",
                                   "probe_blocks", "families", "afc")}


def wideband(recipe=RECIPE) -> np.ndarray:
    """complex64 [blocks * n_bins * block_len]: the rs41 and m10 carriers
    at fs_wide, in complex noise of std ``noise`` per component."""
    from sondetpu_torch.sondes.m10 import M10Modulator, M10Truth
    from sondetpu_torch.sondes.modulate import freq_shift, gfsk_modulate
    from sondetpu_torch.sondes.rs41 import RS41Modulator, RS41Truth

    fs = recipe["n_bins"] * 48000.0
    n = recipe["blocks"] * recipe["n_bins"] * recipe["block_len"]
    rs41 = RS41Modulator()
    bits = rs41.frames_to_bits(np.stack(
        [rs41.build_frame(RS41Truth(frame_no=40 + i))
         for i in range(recipe["rs41_frames"])]))
    m10 = M10Modulator()
    chips = m10.frames_to_chips(np.stack(
        [m10.build_frame(M10Truth(frame_no=8 + i))
         for i in range(recipe["m10_frames"])]))
    sigs = (freq_shift(gfsk_modulate(bits, fs / 4800.0, 2400.0 / fs),
                       recipe["rs41_hz"] / fs),
            freq_shift(gfsk_modulate(chips, fs / 9600.0, 12000.0 / fs,
                                     bt=0.7), recipe["m10_hz"] / fs))
    rng = np.random.default_rng(recipe["seed"])
    wide = (recipe["noise"] * (rng.normal(size=n) + 1j * rng.normal(size=n))
            ).astype(np.complex64)
    for s in sigs:
        wide[:min(n, s.size)] += s[:n]
    return wide


def update_record(block: int, ch: int, sonde: str, telem) -> list:
    return [block, ch, sonde, json.dumps(telem.to_dict(), sort_keys=True)]


def main():
    from sondetpu.runtime import checkpoint
    from sondetpu.runtime.autofleet import AutoFleet

    r = RECIPE
    wide = wideband()
    w = r["n_bins"] * r["block_len"]
    auto = AutoFleet(**autofleet_kwargs())
    for b in range(r["blocks_saved"]):
        auto.process_wideband(wide[b * w:(b + 1) * w])
    assert sorted(t.sonde for t in auto.tracked) == ["m10", "rs41"]
    checkpoint.save_autofleet(auto, CKPT)

    updates = []
    cont = AutoFleet(**autofleet_kwargs(), on_update=lambda ch, s, t:
                     updates.append(update_record(b, ch, s, t)))
    checkpoint.load_autofleet(cont, CKPT)
    for b in range(r["blocks_saved"], r["blocks"]):
        cont.process_wideband(wide[b * w:(b + 1) * w])
    with open(EXPECTED, "w") as f:
        json.dump({"recipe": r, "updates": updates,
                   "tracked": [[t.sonde, t.pfb_bin, t.center_hz]
                               for t in cont.tracked]}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    print(CKPT, os.path.getsize(CKPT), "bytes", file=sys.stderr)


if __name__ == "__main__":
    main()
