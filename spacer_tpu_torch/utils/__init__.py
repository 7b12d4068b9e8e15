"""Host utilities copied from spacer_tpu/utils."""
