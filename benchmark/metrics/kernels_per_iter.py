"""kernels_per_iter (count, layer: model and update): kernel launches on the
device in the traced calls (copies and fills apart), over their
iterations.  Moves iters_per_s."""


def read(run):
    tr = run.trace
    if tr is None or not tr.iters or not tr.kernels:
        return None
    return tr.kernels / tr.iters
