"""Share of the traced stretch of the window in which no kernel ran on the
device (torch.profiler's device records), in %."""


def read(window):
    tr = window.trace
    if tr is None or not tr.records:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
