"""Mid-attribute speaker distributions (port of masg_tpu/distributions)."""
