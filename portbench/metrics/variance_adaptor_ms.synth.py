"""The window's total stream time of the program's `fs2.variance_adaptor`
spans (predictors and embeddings) less that of their `fs2.length_regulator`
children, in ms."""

from portbench.program_spans import stream_ms


def read(rec):
    return stream_ms(rec, "fs2.variance_adaptor", less_child="fs2.length_regulator")
