"""Kernel launches in the traced window over the iterations it ran (the
products and the method's vector work), a count that repeats exactly."""


def read(view):
    it = view.counts.get("iterations", 0)
    k = len(view.kernels())
    return k / it if it and k else None
