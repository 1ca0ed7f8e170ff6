"""The 95th percentile over every batch of the window of the time from the
enqueue of its upload to its prediction and metrics on the host, ms."""

import statistics


def read(run):
    if run.kind != "serve" or len(run.latencies) < 20:
        return None
    return 1e3 * statistics.quantiles(run.latencies, n=20, method="inclusive")[18]
