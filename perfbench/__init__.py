"""The port's benchmark: ``python3 perfbench/run.py --workload <cell> ...``
(see run.py). Everything a cell is sits in data files found by name."""
