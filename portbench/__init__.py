"""portbench: the benchmark of xitorch_tpu_torch, the PyTorch/CUDA port.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; ``README.md``
beside this file says how cells, traffic mixes, metrics and kernel counts
are added as files.
"""
