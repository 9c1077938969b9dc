"""Benchmark of the PyTorch and CUDA port (``repro_torch``) on one NVIDIA H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``.  Everything that belongs to one
configuration, traffic mix or metric lives in a file of its own, found by
name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``.
"""
