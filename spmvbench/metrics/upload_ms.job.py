"""Milliseconds a job in the port's ``bind.upload`` spans: the bound
container's copy from the host to the card (host clock: the copy from
pageable memory returns once the host's side is staged).  Read only from
a window with a device trace: a run on the host uploads nothing."""


def read(view):
    t = view.spans.get("bind.upload")
    jobs = view.counts.get("units", 0)
    return sum(t) / jobs * 1e3 if t and jobs and view.ops else None
