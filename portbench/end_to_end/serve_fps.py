"""Frames whose uint8 prediction and metrics reached the host in the window,
over the window (from the first upload's enqueue to the last read-back's
arrival), frames/s."""


def read(run):
    return run.frames / run.window_s if run.kind == "serve" else None
