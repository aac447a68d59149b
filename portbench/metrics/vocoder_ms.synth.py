"""The window's total host time in the program's `vocoder` calls (spans closed by
a device synchronize), in ms."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "vocoder")
