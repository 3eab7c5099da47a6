"""The share of the traced window, in percent, in which no operation ran
on the card (kernels, copies, sets), from the profiler's trace."""


def read(view):
    return view.idle_pct()
