"""Card milliseconds a flush in the port's ``service.stack`` spans: the
panel's ``torch.stack`` of the flush's vectors, timed by CUDA events on
the card's stream.  Read only from a window with a device trace."""


def read(view):
    t = view.spans.get("service.stack")
    n = view.counts.get("flushes", 0)
    return sum(t) / n * 1e3 if t and n and view.ops else None
