"""Host milliseconds a job inside the port's own ``transform`` spans
(``core/transform.py``'s host recipes), which the program records when its
telemetry is on (the traced run only)."""


def read(view):
    t = view.spans.get("transform")
    jobs = view.counts.get("units", 0)
    return sum(t) / jobs * 1e3 if t and jobs else None
