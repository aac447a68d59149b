"""The share of the samples the vocoder made that lie past each row's length
(the program's counters `vocoder.samples` and `vocoder.useful_samples`), in %."""

from portbench.program_spans import vocoder_pad_share


def read(rec):
    return vocoder_pad_share(rec)
