"""Card milliseconds a flush in the port's ``hybrid.block`` spans: each
hybrid block's product on the panel (the blocks' SpMM kernels and what
their wrappers launch beside them), timed by CUDA events on the card's
stream; the reassembly falls outside.  Read only from a window with a
device trace."""


def read(view):
    t = view.spans.get("hybrid.block")
    n = view.counts.get("flushes", 0)
    return sum(t) / n * 1e3 if t and n and view.ops else None
