"""Card milliseconds a flush in the port's ``service.unstack`` spans: the
answers, the panel's columns in one row-major copy
(``Y[:, :b].t().contiguous()``), timed by CUDA events on the card's
stream.  Read only from a window with a device trace."""


def read(view):
    t = view.spans.get("service.unstack")
    n = view.counts.get("flushes", 0)
    return sum(t) / n * 1e3 if t and n and view.ops else None
