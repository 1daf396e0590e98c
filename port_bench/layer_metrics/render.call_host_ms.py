"""Median host time inside `GraphedRenderer.__call__` (staging the request
and launching the replay), by the benchmark's clock, in ms."""
import statistics


def read(run):
    if run.kind != "serve" or run.trace is None or not run.call_host_s:
        return None
    return 1e3 * statistics.median(run.call_host_s)
