"""Caps torch's intra-op threads in a pytest-xdist worker.

Every ``tests/test_torch_*.py`` imports this module. Under xdist the
workers share the machine's cores, and torch's default of one thread a
core in each worker oversubscribes them. So in a worker
(``PYTEST_XDIST_WORKER`` set) torch takes its share of the cores,
``cpu_count // PYTEST_XDIST_WORKER_COUNT`` and at least 1; in a plain
pytest process torch's default stays.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    _workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
