"""K4 (`ops/fused_mrf.py`, `csrc/fused_mrf.cu`): the summed roofline bound of
its launches in the window over their summed device time, in %."""

from portbench.readers import roofline


def read(rec):
    return roofline(rec, "k4_launches", ("mrf_kernel",))
