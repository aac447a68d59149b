"""Device-idle time inside the program's `data.to_device` spans (the GAN
step's batch copied to the card by `train.vocoder.batch_to_device`), over
the traced window, in ms."""

from portbench.program_spans import idle_in_span_ms


def read(rec):
    return idle_in_span_ms(rec, "data.to_device")
