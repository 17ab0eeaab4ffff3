"""device_idle_pct (%): the share of the traced window in which no kernel,
copy or set ran on the card: the window's wall less the union of the
profiler's device intervals, over the wall."""


def read(run):
    tr = run.trace
    if tr is None or tr.n_events == 0 or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
