"""Device-idle time inside the program's `vocoder.to_int16` spans (the host's
int16 conversion and trim of each fetched padded wav), over the traced
window, in ms."""

from portbench.program_spans import idle_in_span_ms


def read(rec):
    return idle_in_span_ms(rec, "vocoder.to_int16")
