"""``Pipeline.step(state, planes)`` of one family over every channel."""

from __future__ import annotations

import numpy as np


class PipelineSystem:
    def __init__(self, torch, config: dict, device, tuning=None):
        """``tuning``: the per-channel carrier offsets (Hz) handed to the
        pipeline as ``fine_offsets``, and whether its AFC loop runs
        (``afc``), where the traffic's carriers sit off the channel
        centres."""
        from sondetpu_torch.runtime.pipeline import Pipeline, PipelineConfig

        p = config["pipeline"]
        self.config = PipelineConfig(
            sonde=p["sonde"], channels=int(p["channels"]), fs=float(p["fs"]),
            block_len=int(p["block_len"]),
            sync_threshold=float(p.get("sync_threshold", 0.6)),
            ntaps=int(p.get("ntaps", 41)), use_pallas=bool(p["use_pallas"]),
            compute_dtype=p["compute_dtype"], input_dtype=p["input_dtype"],
            fine_offsets=(None if not tuning else
                          tuple(float(f) for f in tuning["fine_offsets"])),
            afc=bool(tuning and tuning.get("afc")))
        self.device = torch.device(device)
        self.pipe = Pipeline(self.config, self.device)
        self.state = self.pipe.init_state()

    def step(self, planes):
        self.state, out = self.pipe.step(self.state, planes)
        return out.packed, [out.frames]

    def host_decode(self, rows, frames):
        """The program's host decode (FEC, parse, merge) of one block's
        sampled rows: ``rows`` [(local rows, packed rows [R, row_bytes])],
        ``frames`` [full-frame tensor of the group]. Returns [(group,
        local row, telemetry dict)]."""
        return _decode(self.config, self.device, self.pipe, rows[0][0],
                       rows[0][1], frames[0], 0)


def _decode(config, device, pipe, local, packed, frames, group):
    import torch
    from dataclasses import replace

    from sondetpu_torch.runtime.pipeline import BlockOutput
    from sondetpu_torch.runtime.session import DecoderSession

    sess = DecoderSession(replace(config, channels=len(local)), device,
                          pipeline=pipe)
    idx = torch.from_numpy(np.asarray(local, np.int64)).to(frames.device)
    out = BlockOutput(frames=frames[idx], frame_valid=None, frame_score=None,
                      soft_rms=None, rs_clean=None,
                      packed=np.ascontiguousarray(packed).reshape(-1))
    updates, _, _, _ = sess._handle_output(out)
    return [(group, int(local[ch]), t.to_dict()) for ch, t in updates]


def build(torch, config, device, ring=None):
    return PipelineSystem(torch, config, device,
                          None if ring is None else ring.info.get("tuning"))
