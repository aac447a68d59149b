"""The model's useful flops in the window (each row at its own lengths) over
the window's wall time times the chip's peak, in %."""

from portbench.readers import mfu


def read(rec):
    return mfu(rec)
