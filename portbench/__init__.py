"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of EdgeBERT.

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once on one card and prints one JSON
line.  Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (its ``kind`` names
``gen/<kind>.py``), ``families/<family>.py`` with ``reference/`` and
``metrics/<metric>.py`` (or, where that is absent, the file named without
the metric's last dotted suffix).  ``parked/<cell>.json`` holds the
``BENCHMARK.json`` entries of a cell that is built and tested but not yet
measured (the reason is in the file).
"""
