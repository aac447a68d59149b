"""The GAN step's useful flops in the window (`work_gan.py`: every conv of
the generator and the discriminators, their backward as the step runs it,
and the mels) over the window's wall time times the chip's peak, in %."""

from portbench.readers import mfu


def read(rec):
    return mfu(rec)
