"""The reference against the port's CPU path, and the control.

On the CPU the port runs its kernels' plain twins, which the reference's
frozen stages copy: on an 8-channel RS41 stream and a 16-bin fleet every
compared number reads exactly 0. The control (the reference one
precision below the configuration's, in the program's place) must come
out not correct by the cell's limits."""

import pytest
import torch

from benchmark.control import control_side, program_side
from benchmark.harness import catalog
from benchmark.harness.main import verdict
from benchmark.tests.tiny import CELLS, tiny_root

BLOCKS = 8


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _setup(root, cell, seed):
    c = catalog.Cell(cell, root)
    dev = torch.device("cpu")
    ring = c.generator().make(torch, c.config, c.traffic, seed, dev)
    ref = c.reference().build(c.config, c.traffic, ring, seed, dev)
    return c, ring, ref, dev


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_port_on_the_cpu(root, cell):
    c, ring, ref, dev = _setup(root, cell, 21)
    nums = program_side(torch, c, ring, ref, BLOCKS, dev, 21)
    assert nums["slots_compared"] > 0 and nums["telemetry_units"] > 0
    for k in ("soft_rms_gap", "chip_gap", "valid_mismatch",
              "rs_flag_mismatch", "telemetry_mismatch"):
        assert nums[k] == 0, (k, nums)
    for k in ("weak_gap", "noise_soft_rms_gap"):
        assert nums.get(k, 0) == 0, (k, nums)
    assert ("noise_soft_rms_gap" in nums) == cell.startswith("fleet")
    assert verdict(nums, c.limits)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_in_lower_precision_is_caught(root, cell):
    c, ring, ref, dev = _setup(root, cell, 22)
    nums = control_side(torch, c, ring, ref, BLOCKS)
    nums.update(telemetry_mismatch=0, telemetry_units=1)
    ok, rows = verdict(nums, c.limits)
    assert not ok, rows


def test_a_fault_on_a_noise_bin_alone_is_caught(root):
    """The reference's own rows in the program's place read 0; the soft-chip
    RMS of one sampled bin that carries no sonde, doubled in every block,
    fails the fleet's check while every carrier's number stays 0."""
    import numpy as np

    c, ring, ref, dev = _setup(root, "fleet-2048.bench-mix", 23)
    out = ref.run(BLOCKS)
    rows = [[p.copy() for p, _ in blk] for blk in out]
    full = {k: [f for _, f in blk] for k, blk in enumerate(out)}
    clean = ref.run(BLOCKS, program=rows, full=full)
    assert verdict({**clean, "telemetry_mismatch": 0, "telemetry_units": 1},
                   c.limits)[0], clean
    j, g = next((j, g) for j, g in enumerate(ref.groups) if any(g.noise))
    r = list(g.noise).index(True)
    off = g.fam.k_slots * g.fam.wire_ncols + 2 * g.fam.k_slots
    for blk in rows:
        blk[j][r, off:off + 4].view(np.float32)[0] *= 2.0
    nums = ref.run(BLOCKS, program=rows, full=full)
    assert nums["soft_rms_gap"] == 0, nums
    assert nums["noise_soft_rms_gap"] > c.limits["noise_soft_rms_gap"]["limit"]
    nums.update(telemetry_mismatch=0, telemetry_units=1)
    assert not verdict(nums, c.limits)[0]


@pytest.mark.parametrize("fault", ["ddc_phase_reset", "tails_dropped"])
def test_a_planted_fault_after_block_0_is_caught(root, fault):
    """Faults in the state that the offgrid step carries between blocks,
    planted in the reference put in the program's place, come out not
    correct. (The AFC's faults are not among them: with the carriers'
    offsets given exactly, the loop barely moves the frequency, and the
    block DC removal absorbs what it moves.)"""
    c, ring, ref, dev = _setup(root, "rs41-2048.offgrid-afc", 24)
    nums = control_side(torch, c, ring, ref, BLOCKS, fault)
    assert nums["soft_rms_gap_first"] == 0, nums
    nums.update(telemetry_mismatch=0, telemetry_units=1)
    ok, rows = verdict(nums, c.limits)
    assert not ok, rows


def test_a_channelizer_fault_on_noise_bins_alone_is_caught(root):
    """Each sampled bin that carries no sonde handed its neighbour's PFB
    output, planted in the reference put in the program's place: the
    carriers read 0 and the noise rows fail the fleet's check."""
    c, ring, ref, dev = _setup(root, "fleet-2048.bench-mix", 25)
    nums = control_side(torch, c, ring, ref, BLOCKS, "noise_bins_moved")
    assert nums["soft_rms_gap"] == 0 and nums["chip_gap"] == 0, nums
    nums.update(telemetry_mismatch=0, telemetry_units=1)
    assert not verdict(nums, c.limits)[0], nums
