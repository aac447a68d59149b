"""The window's total stream time of the program's `fs2.decoder` spans (the
decoder, `mel_linear` and the PostNet at the mel capacity), in ms."""

from portbench.program_spans import stream_ms


def read(rec):
    return stream_ms(rec, "fs2.decoder")
