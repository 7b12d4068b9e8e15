"""idle_share (%, device): the share of the traced window in which no
operation ran on the card (profiler trace, the union of device intervals);
none without a device record."""


def read(record):
    t = record.trace
    if t is None or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
