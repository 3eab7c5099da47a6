"""Mean host milliseconds of ``Planner.plan`` a job: the benchmark's span
around the call (a fresh CRS to a plan: ``MatrixStats``, the cost model,
the plan lint), taken after a synchronize."""


def read(view):
    t = view.host.get("plan")
    return sum(t) / len(t) * 1e3 if t else None
