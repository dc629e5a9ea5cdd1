"""Train and eval steps, and the (data, model) process grid
(ctts_tpu/parallel/)."""
