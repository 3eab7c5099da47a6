"""Milliseconds a job in the port's ``transform.copy_out`` spans: the
source CRS's one copy from the card to the host before the host recipe
reads it (host clock: the copy to pageable memory returns when it is
done).  Read only from a window with a device trace: a run on the host
copies nothing."""


def read(view):
    t = view.spans.get("transform.copy_out")
    jobs = view.counts.get("units", 0)
    return sum(t) / jobs * 1e3 if t and jobs and view.ops else None
