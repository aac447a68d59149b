"""The window's total stream time of the program's
`vocoder_train.disc_update` spans (the discriminators on the audio and the
detached generator output, their backward and their AdamW update), in ms."""

from portbench.program_spans import stream_ms


def read(rec):
    return stream_ms(rec, "vocoder_train.disc_update")
