"""The benchmark of ``psvi_torch`` on one card (``BENCHMARK.json``)."""
