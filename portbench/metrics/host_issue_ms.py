"""Public API layer: host time from entering the entry to its return,
before the synchronise; the mean over every call of the window (the
harness's own span, so the sum over the window spans seconds)."""


def read(obs):
    w = obs.window
    return 1e3 * sum(w.issue_s) / w.calls
