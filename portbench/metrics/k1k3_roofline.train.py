"""K1-K3 (`ops/attention.py`, `csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`): the
summed roofline bound of their launches in the window over their summed
device time, in %."""

from portbench.readers import roofline


def read(rec):
    return roofline(rec, "k1k3_launches", ("flash_fwd", "flash_dq", "flash_dkv"))
