"""The window's total stream time of the program's
`vocoder_train.gen_update` spans (the updated discriminators, the losses
with the generator output's mel, the backward into the generator and its
AdamW update), in ms."""

from portbench.program_spans import stream_ms


def read(rec):
    return stream_ms(rec, "vocoder_train.gen_update")
