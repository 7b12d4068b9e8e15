"""program_pad_share (%, batcher admission): the port's counters
`admit.positions` (bucket x prompts) and `admit.real_positions` under the
traced window's `batcher.admit` spans: the share of prefilled positions that
are padding (pad_share reckons the same from the client's prompt lengths)."""

from harness.program import counted


def read(record):
    total = counted(record, "admit.positions", "batcher.admit")
    real = counted(record, "admit.real_positions", "batcher.admit")
    return 100.0 * (total - real) / total if total else None
