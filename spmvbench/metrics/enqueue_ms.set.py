"""Mean host milliseconds of the port's ``matrix.spmv`` spans: one
product's launch path (``PlannedMatrix.spmv`` up to the last launch
enqueued; the card's work is not waited for).  Read only from a window
with a device trace: on the host a product runs inside its launch."""


def read(view):
    t = view.spans.get("matrix.spmv")
    return sum(t) / len(t) * 1e3 if t and view.ops else None
