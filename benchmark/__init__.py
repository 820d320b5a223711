"""The port's benchmark: one cell, one run, by ``python3 benchmark/run.py``."""
