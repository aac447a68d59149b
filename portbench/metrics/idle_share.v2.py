"""The share of the traced window in which no kernel ran on the device, in %."""

from portbench.readers import idle_share


def read(rec):
    return idle_share(rec)
