"""One share of the CPU's cores for each pytest-xdist worker: torch's
threads of several workers on the same cores spin against each other, and
a serving window of a second then reaches a few requests, not hundreds."""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
