"""Frames of the training steps completed in the window (every step's
global batch), over the window (from the first step's upload to the
synchronize after the last), frames/s."""


def read(run):
    return run.frames / run.window_s if run.kind == "train" else None
