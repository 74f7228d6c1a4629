"""The benchmark of ``istnet_tpu_torch`` on NVIDIA cards: one run of one
cell a process (``benchmark/run.py``), driven by ``BENCHMARK.json``."""
