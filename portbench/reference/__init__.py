"""Plain references, one module a configuration, found by the
``reference`` key of its file.  They import torch alone: nothing of the
port, of JAX or of the JAX package, and they take nothing the port made.

Each module gives ``judge(cfg, traffic, inputs, outputs)``, the numbers
that decide ``correct`` for one input set and the outputs of a call on it,
and ``control(cfg, traffic, inputs)``, the outputs of the reference put in
the program's place one precision below the configuration's (TF32 for its
IEEE float32), which ``judge`` has to refuse.
"""
