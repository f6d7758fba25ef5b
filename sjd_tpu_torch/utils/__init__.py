"""Checkpoint reading and porting, the tokenizer wrapper, profiling and
logging helpers (sjd_tpu/utils)."""
