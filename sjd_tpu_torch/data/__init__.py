"""FlexAR token layout and vocabulary translation (sjd_tpu/data)."""
