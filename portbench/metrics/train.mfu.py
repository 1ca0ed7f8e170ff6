"""The whole model step's share of the configuration's peak: operations a
frame (the reference's, counted by ``FlopCounterMode``) x frames of the
window / the window / the peak of the run's cards, %."""

from portbench.readers import mfu


def read(run):
    return mfu(run, "train")
