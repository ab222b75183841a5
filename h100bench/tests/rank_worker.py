"""One rank of a cell on several processes, on the CPU at the cell's small
size (``small.py``), as ``ranks.launch`` starts it:

    python h100bench/tests/rank_worker.py <cell> <seed> <trace> [<fault>]

``trace``: 0 or 1, as ``run.py``'s ``--trace``; ``fault``: a name of
``control.PROGRAM_FAULTS``. Rank 0 prints the run's ``correct``, compared
numbers and metrics as one JSON line."""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from h100bench import control, ranks, run  # noqa: E402
from h100bench.tests import small  # noqa: E402


def main() -> int:
    cell, seed, trace, *fault = sys.argv[1:]
    torch.set_num_threads(1)
    out = run.execute(small.args(cell, seed=int(seed), seconds=0.5, trace=int(trace)),
                      device=torch.device("cpu"),
                      faults=[control.PROGRAM_FAULTS[f] for f in fault],
                      overrides=small.overrides(cell))
    if ranks.rank() == 0:
        print(json.dumps({"correct": out["correct"], "checks": out["checks"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
