"""idle_pct.train, idle_pct.eval: the share of the traced window that the
union of the device's intervals (kernels, copies, sets) leaves uncovered,
in percent."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = tr.busy_s()
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / tr.window_s)
