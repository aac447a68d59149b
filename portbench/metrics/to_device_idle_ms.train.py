"""Device-idle time inside the program's `data.to_device` spans (the batch's
host-to-device copies), over the traced window, in ms."""

from portbench.program_spans import idle_in_span_ms


def read(rec):
    return idle_in_span_ms(rec, "data.to_device")
