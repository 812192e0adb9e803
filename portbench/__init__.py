"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the root ``BENCHMARK.json``; see
``portbench/README.md``.
"""
