"""The share of the traced window in which no operation ran on the card:
one less the union of the device operations' intervals (kernels, copies,
sets) over the window, in percent."""

from benchmark.harness.trace import busy_us


def read(record):
    window = record["end_us"] - record["start_us"]
    if window <= 0 or not record["device"]:
        return None
    return 100.0 * (1.0 - busy_us(record) / window)
