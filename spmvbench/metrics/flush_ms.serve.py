"""Median host milliseconds of a flush: the benchmark's span from the
flushing ``submit`` through the synchronize after it."""
import statistics


def read(view):
    t = view.host.get("flush")
    return statistics.median(t) * 1e3 if t else None
