"""Device-idle time inside the program's `train.backward` spans (autograd and
the gradient fill), over the traced window, in ms."""

from portbench.program_spans import idle_in_span_ms


def read(rec):
    return idle_in_span_ms(rec, "train.backward")
