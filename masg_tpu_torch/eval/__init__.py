"""Objective evaluation of generated speakers (port of masg_tpu/eval)."""
