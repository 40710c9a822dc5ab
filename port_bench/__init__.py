"""The benchmark of add_gym_torch, the PyTorch and CUDA port: training on
the card, cell by cell, as ``BENCHMARK.json`` at the repository's root
names the cells.

    python -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is a file of its own that the harness finds
by name: ``configs/<config>.json`` (the configuration as it is run),
``traffic/<traffic>.json`` (the shapes of the training job and what the
check follows), ``limits/<workload>.json`` (each compared number's limit)
and ``metrics/<metric>.py`` (one reader per metric).  ``reference/`` is
the plain PyTorch reference that decides ``correct``; ``ceiling.py`` the
frozen yardstick of peaks and operation counts.
"""
