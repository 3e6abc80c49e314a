"""Per-layer metric readers, one module a metric of ``BENCHMARK.json``'s
``per_layer``, found by the metric's name.  Each gives ``read(obs)`` of a
:class:`portbench.harness.Observation`: the value, or None where it finds
nothing to read (then the metric is left out of the run's line).  A share
of a roofline or of a peak is never returned as 0.
"""
