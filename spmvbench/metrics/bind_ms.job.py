"""Mean host milliseconds of ``ExecutionPlan.bind`` a job (the run-time
transform, the upload and ``prepare``), from the benchmark's span through
a synchronize."""


def read(view):
    t = view.host.get("bind")
    return sum(t) / len(t) * 1e3 if t else None
