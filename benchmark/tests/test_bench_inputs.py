"""The traffic is made from the seed: the same seed gives the same inputs,
another seed other inputs, and the ring streams continuously."""

import numpy as np
import pytest
import torch

from benchmark.harness import catalog
from benchmark.tests.tiny import CELLS, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _ring(root, cell, seed):
    c = catalog.Cell(cell, root)
    return c.generator().make(torch, c.config, c.traffic, seed,
                              torch.device("cpu"))


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(root, cell):
    seed = 2 ** 31 + 12345          # more than 32 signed bits hold
    a, b = _ring(root, cell, seed), _ring(root, cell, seed)
    assert a.info == b.info and a.truths == b.truths
    for x, y in zip(a.blocks, b.blocks):
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    c = _ring(root, cell, seed + 1)
    assert not torch.equal(a.blocks[0][0], c.blocks[0][0])


def test_channel_ring_is_continuous(root):
    """Channel ch of ring block b is samples [b n, (b+1) n) of its truth's
    circular signal: the ring's blocks join without a seam."""
    r = _ring(root, "rs41-2048.ongrid", 7)
    assert len(r.blocks) == 4
    i = torch.cat([b[0] for b in r.blocks], dim=-1)
    assert i.dtype == torch.int16 and i.shape == (8, 4 * 48000)
    # the noise is per block, the signal is not: the first and the last
    # samples of a channel's period are neighbours of one circular signal
    assert r.info["truths"] == 4
    assert sorted(set(t["serial"] for t in r.truths.values())) == sorted(
        set(r.truths[ch]["serial"] for ch in range(4)))


def test_wideband_carriers_from_the_seed(root):
    r = _ring(root, "fleet-2048.bench-mix", 11)
    fams = sorted(t["family"] for t in r.truths.values())
    assert fams == ["dfm", "m10", "rs41"]
    from benchmark.gen.wideband_ring import family_of
    c = catalog.Cell("fleet-2048.bench-mix", root)
    for k, t in r.truths.items():
        assert k != 0 and family_of(c.config, k) == t["family"]
    w = r.blocks[0][0]
    assert w.dtype == torch.float32 and w.shape == (16 * 48000,)
    # each unit carrier adds a variance of 1/2 to each plane, the noise
    # 0.05 ** 2
    want = np.sqrt(len(r.truths) / 2 + 0.05 ** 2)
    assert abs(float(np.std(r.blocks[1][1].numpy())) - want) < 0.05 * want


def test_offgrid_tuning_reaches_the_program(root):
    """The off-grid mix rotates each carrier by a seeded offset of whole
    cycles a period, and the program is tuned to it: its fine_offsets are
    the offsets (rounded to float32 by the pipeline), with afc on."""
    c = catalog.Cell("rs41-2048.offgrid-afc", root)
    r = _ring(root, "rs41-2048.offgrid-afc", 5)
    tune = r.info["tuning"]
    f = np.asarray(tune["fine_offsets"])
    assert tune["afc"] and f.shape == (8,)
    assert np.all(np.abs(f) <= 7950.0) and len(set(f)) > 1
    assert np.allclose(f * c.traffic["period_s"],
                       np.round(f * c.traffic["period_s"]))
    system = c.system().build(torch, c.config, torch.device("cpu"), r)
    assert system.config.afc
    assert system.config.fine_offsets == tuple(float(x) for x in f)
