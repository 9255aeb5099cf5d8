"""``FleetSession.step(wi, wq)``: the PFB and every family's group."""

from __future__ import annotations

from benchmark.systems.pipeline import _decode


class FleetSystem:
    def __init__(self, torch, config: dict, device):
        from sondetpu_torch.runtime.fleet import FleetChannel, FleetSession

        f = config["fleet"]
        fmap = f["family_by_bin_mod"]
        chans = [FleetChannel(pfb_bin=k, sonde=fmap[k % len(fmap)])
                 for k in range(int(f["n_bins"]))]
        self.device = torch.device(device)
        self.fleet = FleetSession(
            chans, n_bins=int(f["n_bins"]), device=self.device,
            fs_chan=float(f["fs_chan"]), block_len=int(f["block_len"]),
            sync_threshold=float(f["sync_threshold"]),
            use_pallas=f["use_pallas"], compute_dtype=f["compute_dtype"],
            pipelined=bool(f["pipelined"]))

    def step(self, planes):
        wi, wq = planes
        return self.fleet.step(wi, wq)

    def host_decode(self, rows, frames):
        out = []
        for g, ((local, packed), fr, (_, sess)) in enumerate(
                zip(rows, frames, self.fleet.groups.values())):
            out += _decode(sess.config, self.device, sess.pipeline, local,
                           packed, fr, g)
        return out


def build(torch, config, device, ring=None):
    return FleetSystem(torch, config, device)
