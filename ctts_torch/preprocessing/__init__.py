"""Corpus preparation and featurization (ctts_tpu/preprocessing)."""
