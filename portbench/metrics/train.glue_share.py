"""Glue (``ops/*``, plain torch in ``models/``, cuDNN): the share of the
profiled sub-window's device-busy time in kernels outside the program's
``ircolor::`` namespace, %."""

from portbench.readers import glue_share


def read(run):
    return glue_share(run, "train")
