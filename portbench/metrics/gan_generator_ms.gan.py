"""The window's total stream time of the program's `vocoder_train.generator`
spans (the generator's input mel and its forward, in the GAN step), in ms."""

from portbench.program_spans import stream_ms


def read(rec):
    return stream_ms(rec, "vocoder_train.generator")
