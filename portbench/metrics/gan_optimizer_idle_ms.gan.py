"""Device-idle time inside the program's `vocoder_train.optimizer` spans
(the two AdamW updates of each GAN step), over the traced window, in ms."""

from portbench.program_spans import idle_in_span_ms


def read(rec):
    return idle_in_span_ms(rec, "vocoder_train.optimizer")
