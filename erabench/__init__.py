"""erabench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once::

    python erabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``erabench/README.md``.  Nothing here imports JAX or the JAX package.
"""
