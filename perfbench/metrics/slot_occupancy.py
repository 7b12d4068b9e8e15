"""slot_occupancy (%, batcher decode): slots holding a request, summed over
the decode steps of the traced window's chunks (the port's
`decode.slots_held`, from its host-side slot table), over steps x slots."""

from harness.program import counted


def read(record):
    held = counted(record, "decode.slots_held", "batcher.decode_chunk")
    steps = counted(record, "decode.steps", "batcher.decode_chunk")
    if held is None or not steps:
        return None
    return 100.0 * held / (steps * record.serving["slots"])
