"""host_syncs_per_step (syncs/step, batcher decode): the port's `host_syncs`
counter (blocking device-to-host reads and pageable host-to-device copies)
under its decode chunks in the traced window, over the steps they ran
(`decode.steps`)."""

from harness.program import counted


def read(record):
    syncs = counted(record, "host_syncs", "batcher.decode_chunk")
    steps = counted(record, "decode.steps", "batcher.decode_chunk")
    return syncs / steps if syncs is not None and steps else None
