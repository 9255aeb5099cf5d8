"""Symbol timing, syncword correlation and line coding (counterpart:
``sondetpu/sync``, with the same exports)."""

from sondetpu_torch.sync.timing import (
    TimingState,
    timing_init,
    oerder_meyr_tau,
    symbol_sample,
    gardner_scan,
)
from sondetpu_torch.sync.coding import (
    manchester_decode,
    biphase_m_decode,
    nrzs_decode,
    bits_to_bytes,
    bytes_to_bits,
    descramble_xor,
)
from sondetpu_torch.sync.correlator import (
    correlate_syncword,
    find_frame_starts,
    gather_frames,
    syncword_to_chips,
)

__all__ = [
    "TimingState", "timing_init", "oerder_meyr_tau", "symbol_sample",
    "gardner_scan",
    "manchester_decode", "biphase_m_decode", "nrzs_decode",
    "bits_to_bytes", "bytes_to_bits", "descramble_xor",
    "correlate_syncword", "find_frame_starts", "gather_frames",
    "syncword_to_chips",
]
