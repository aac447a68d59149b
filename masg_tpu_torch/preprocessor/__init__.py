"""Offline data preparation (port of masg_tpu/preprocessor)."""
