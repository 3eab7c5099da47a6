"""Card milliseconds a flush in the port's ``guard.probe`` spans: the
guard's finiteness probe of the panel's product, up to (not including)
its read back, timed by CUDA events on the card's stream.  Read only from
a window with a device trace."""


def read(view):
    t = view.spans.get("guard.probe")
    n = view.counts.get("flushes", 0)
    return sum(t) / n * 1e3 if t and n and view.ops else None
