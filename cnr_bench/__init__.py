"""The benchmark of the Check-N-Run port (``src/repro_torch``) on NVIDIA
H100 cards: one cell a run, driven by ``BENCHMARK.json`` (``run.py``)."""
