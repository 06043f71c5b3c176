"""Device: the share of the traced stretch in which no kernel, copy or
fill ran on the card (``torch.profiler``), in percent."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
