"""Device layer: ``torch.cuda.max_memory_allocated()`` over the window, its
peak reset as the window opened, in MiB."""


def read(obs):
    return obs.peak_bytes / 2 ** 20 if obs.peak_bytes else None
