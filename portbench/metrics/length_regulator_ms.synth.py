"""The window's total stream time of the program's `fs2.length_regulator`
spans (the expansion of phones to the mel capacity), in ms."""

from portbench.program_spans import stream_ms


def read(rec):
    return stream_ms(rec, "fs2.length_regulator")
