"""Functional layers on torch tensors (counterpart of spacer_tpu/nn)."""
