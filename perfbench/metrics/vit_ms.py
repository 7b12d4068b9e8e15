"""vit_ms (ms, batcher admission): the traced window's total of the port's
`admit.vit` spans: the prologue (embedding, ViT, merge) of each unique
prompt of a wave with vision, synchronized at its end in the traced run."""

from harness.program import total_ms


def read(record):
    return total_ms(record, "admit.vit")
