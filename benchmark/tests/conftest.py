"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the checkout's root. Tests marked ``cuda`` need a CUDA card and skip
without one (decided inside each test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)  # several workers share the machine's cores
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips where there is none")
