"""Device: 1 - the union of device-busy intervals / the profiled
sub-window, %."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run, "serve")
