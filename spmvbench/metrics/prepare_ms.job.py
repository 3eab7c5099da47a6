"""Milliseconds a job in the port's ``bind.prepare`` spans:
``kernels.ops.prepare`` in ``bind`` (ELL extents on the card, ended by the
read back of whether they pay; host clock).  Read only from a window with
a device trace."""


def read(view):
    t = view.spans.get("bind.prepare")
    jobs = view.counts.get("units", 0)
    return sum(t) / jobs * 1e3 if t and jobs and view.ops else None
