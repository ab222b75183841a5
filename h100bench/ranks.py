"""Cells on several cards: one process a card, started by ``torchrun``.

``launch`` runs a script as the ranks of one run through
``torch.distributed.run --standalone`` (its rendezvous on a free local
port; each rank in a session of its own, whose whole process group
torchrun kills when the run ends or fails, so nothing a rank forks
outlives it). The launcher's start time goes to every rank
(``H100BENCH_T0``), so that ``setup_s`` counts from the command's start.
Every rank writes to files; once all have ended, the launcher prints the
other ranks' last lines of standard error, then rank 0's standard error
and output, so that rank 0's last lines are the run's (torchrun's own
console output would interleave the ranks').

``Group`` is a rank's place in the run: it joins the port's process group
as ``cli train --multihost`` does (``parallel.mesh.initialize_multihost``)
and opens a gloo group beside it for what the harness itself exchanges
between ranks, host tensors only, so that nothing of the harness runs on
the cards' NCCL streams.

This module imports nothing but the standard library until a ``Group`` is
made.
"""

from __future__ import annotations

import os
import resource
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

ENV_T0 = "H100BENCH_T0"  # the launcher's time.perf_counter() at its start


def is_rank() -> bool:
    """Whether this process is a rank that ``launch`` started."""
    return ENV_T0 in os.environ


def rank() -> int:
    return int(os.environ.get("RANK", "0")) if is_rank() else 0


def launch(argv: list, ranks: int, t0: float, timeout: float, stdout=None, stderr=None) -> int:
    """Run the script ``argv`` (its path, then its arguments) as ``ranks``
    ranks on this machine; returns the exit code, 0 only where every rank
    ended with 0 within ``timeout`` seconds. Once they have ended, the last
    lines of the other ranks' standard error go to ``stderr``, then rank
    0's whole, so that its last lines are the run's; rank 0's standard
    output goes to ``stdout`` (both: this process's by default)."""
    out = sys.stdout if stdout is None else stdout
    err = sys.stderr if stderr is None else stderr
    env = dict(os.environ, **{ENV_T0: repr(t0)})
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // ranks)))
    with tempfile.TemporaryDirectory(prefix="h100bench-ranks-") as logs:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks), "--log-dir", logs, "--redirects", "3", *argv]
        proc = subprocess.Popen(cmd, env=env, stdin=subprocess.DEVNULL, stdout=err, stderr=err)
        # a SIGTERM to the launcher reaches the ranks through torchrun
        prev = signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
        try:
            code = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            print(f"h100bench: the ranks did not end within {timeout:.0f} s", file=err)
            code = 1
        finally:
            if proc.poll() is None:
                proc.terminate()  # torchrun ends every rank's process group
                try:
                    proc.wait(60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            signal.signal(signal.SIGTERM, prev)
        dirs = {int(p.parent.name): p.parent for p in Path(logs).rglob("stderr.log")}
        for r in sorted(dirs, key=lambda r: (r == 0, r)):
            text = (dirs[r] / "stderr.log").read_text(errors="replace")
            if r:
                text = "\n".join(text.splitlines()[-40:]) + "\n"
            print(f"--- rank {r}, {'standard error' if r == 0 else 'its last lines'}:", file=err)
            err.write(text)
        err.flush()
        if 0 in dirs and code == 0:
            out.write((dirs[0] / "stdout.log").read_text(errors="replace"))
            out.flush()
    return code


def host_peak_gib() -> float:
    """This process's peak resident host memory."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


class Group:
    """This rank in the port's process group, with a gloo group beside it
    for the harness's exchanges; ``device``: this rank's device."""

    def __init__(self, device):
        import torch.distributed as dist
        from srgan_tpu_torch.parallel.mesh import initialize_multihost

        self.device = initialize_multihost(device)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.side = dist.new_group(backend="gloo")

    def gather(self, t):
        """Every rank's host tensor ``t`` (one shape on every rank), in
        rank order."""
        import torch
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous(), group=self.side)
        return parts

    def close(self) -> None:
        """Wait for every rank, then leave the process group."""
        import torch.distributed as dist

        dist.barrier(group=self.side)
        dist.destroy_process_group()
