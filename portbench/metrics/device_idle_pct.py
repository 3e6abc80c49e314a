"""Device layer: the share of the traced window in which nothing ran on
the card, 1 - (union of device busy intervals) / (the window's time), from
the profiler's trace."""


def read(obs):
    tr = obs.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
