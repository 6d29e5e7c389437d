"""device_idle (%, layer: device): the share of the traced window in which
no operation ran on the card (1 - busy_s / window_s).  Moves iters_per_s."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
