"""Train and eval steps (ctts_tpu/parallel/)."""
