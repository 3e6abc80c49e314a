"""Wrappers layer: the port's kernel launches a call, from the wrappers'
own ``.launches`` counters read before and after the window."""


def read(obs):
    return obs.window.launches / obs.window.calls
