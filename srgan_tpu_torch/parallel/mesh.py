"""Process groups for data-parallel training, the counterpart of
``srgan_tpu/parallel/mesh.py`` over ``torch.distributed``.

The reference runs DDP over NCCL, one process per GPU
(``src/train.py:29-31,45,47,301-302``). JAX lays one program over a mesh
of every process's devices; here each process drives one device, holds its
own rows of the global batch, and the ranks meet in explicit collectives:

  - ``initialize_multihost`` joins the group from the variables ``torchrun``
    sets (NCCL on the card, gloo on the CPU);
  - ``sum_over_ranks`` sums a small fp64 vector over the ranks in rank
    order (the loss kernels' totals, ``ops/cuda/recon_loss_kernel.py``);
  - ``average_grads`` / ``average_`` average gradients and loss scalars, so
    that every decision a step feeds (the pool's sort and gate) reads the
    same numbers on every rank;
  - ``any_process_flag`` turns a rank's SIGTERM into a collective stop;
  - ``reduce_metrics`` averages an epoch record across ranks.

Every function is the identity on one process (no group), as JAX's are at
``process_count() == 1``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# what torchrun exports to each process; initialize_multihost reads them
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def initialize_multihost(device=None) -> torch.device:
    """Join the process group: ``init_process_group(init_method="env://")``
    with NCCL for a CUDA device and gloo for the CPU (the reference's
    MASTER_ADDR/PORT rendezvous, ``src/train.py:29-31``). Returns this
    rank's device: ``cuda:LOCAL_RANK`` unless ``device`` says ``cpu``.
    Raises, naming the variables, when ``torchrun``'s are missing."""
    missing = [v for v in ENV_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(
            "--multihost needs the process-group variables that torchrun "
            f"sets ({', '.join(ENV_VARS)}); missing: {', '.join(missing)}"
        )
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dev


def default_group():
    """The world group when this process has joined one, else None."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def world_size(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def process_shard_info(group=None) -> tuple:
    """(num_shards, shard_index) for sharded data loading, the
    ``DistributedSampler(num_replicas, rank)`` pair (``src/train.py:90-93``)."""
    group = group or default_group()
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _collective_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sum_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, the same bits on every rank
    and in every run: an all_gather, then a sum in rank order (a reducing
    collective may add in any order). ``x`` itself without a group; a copy
    of it at world size 1."""
    if group is None:
        return x
    parts = all_gather_cat(x[None], group)
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (of one shape on every rank) joined along dim 0 in
    rank order; ``x`` itself without a group."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def average_(x: torch.Tensor, group=None) -> torch.Tensor:
    """Average ``x`` across the group's ranks in place (identical on every
    rank afterwards); the identity without a group."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        x.div_(dist.get_world_size(group))
    return x


def average_grads(grads: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """DDP's gradient average: one all-reduce over the flattened gradients,
    divided by the world size. The gradients as given without a group."""
    grads = list(grads)
    if group is None:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    average_(flat, group)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


@torch.no_grad()
def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, so every
    rank starts from the same weights (JAX assembles a replicated array from
    each host's same-seed copy; ``mesh.py:46-60``)."""
    if group is not None:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=dist.get_global_rank(group, 0), group=group)
    return module


def put_global(batch: np.ndarray, device) -> torch.Tensor:
    """This rank's rows of the global batch onto its device: each process
    holds its own rows, so the global batch is the ranks' rows in rank
    order (``DistributedSampler``'s per-rank batches, ``src/train.py:90-95``)."""
    return torch.as_tensor(np.asarray(batch)).to(device)


def host_local_rows(arr) -> np.ndarray:
    """This rank's rows: the rows it holds, since nothing here is sharded
    across processes within one tensor."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def barrier(group=None) -> None:
    if group is not None:
        dist.barrier(group=group)


def any_process_flag(flag: bool, group=None) -> bool:
    """Cross-rank OR of a per-rank boolean (the identity without a group).
    Every rank must call it at the same point and gets the same answer: a
    rank leaving a loop of collective steps alone would deadlock the
    others."""
    if group is None:
        return bool(flag)
    v = torch.tensor([1.0 if flag else 0.0], device=_collective_device(group))
    dist.all_reduce(v, op=dist.ReduceOp.MAX, group=group)
    return bool(v.item() > 0.0)


_NO_REDUCE_KEYS = ("epoch",)  # identical across ranks by construction


def _reducible(key: str, value) -> bool:
    """True for the numeric scalars that cross-rank aggregation averages:
    floats and int counters alike, excluding bools and the epoch counter."""
    if key in _NO_REDUCE_KEYS or isinstance(value, bool):
        return False
    return isinstance(value, (int, float, np.floating, np.integer))


def combine_host_metrics(per_host: list) -> dict:
    """Merge per-rank metric dicts: finite numeric scalars are averaged
    across ranks; everything else (the epoch counter, pool snapshots,
    strings) comes from ``per_host[0]``. Int-typed values whose mean is
    integral stay ints (ranks run equal batch counts by construction)."""
    base = per_host[0]
    out = dict(base)
    for k, v in base.items():
        if not _reducible(k, v):
            continue
        vals = [float(h[k]) for h in per_host if k in h]
        mean = float(np.mean([x for x in vals if np.isfinite(x)] or [v]))
        if isinstance(v, (int, np.integer)) and mean.is_integer():
            mean = int(mean)
        out[k] = mean
    return out


def reduce_metrics(metrics: dict, group=None) -> dict:
    """Cross-rank mean of the scalar metrics in an epoch record
    (``TrainConfig.reduce_metrics``): one global curve for a multi-process
    run. The identity without a group. The scalars cross as float32, as in
    JAX (``process_allgather`` of a float32 vector), and each rank then
    merges every rank's values with :func:`combine_host_metrics`."""
    group = group or default_group()
    if group is None:
        return dict(metrics)
    keys = sorted(k for k, v in metrics.items() if _reducible(k, v))
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float32,
                       device=_collective_device(group))
    parts = [torch.empty_like(vec) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, vec, group=group)
    per_host = [
        {
            **metrics,
            **{
                k: (int(row[i]) if isinstance(metrics[k], (int, np.integer))
                    else float(row[i]))
                for i, k in enumerate(keys)
            },
        }
        for row in (p.cpu().numpy() for p in parts)
    ]
    return combine_host_metrics(per_host)
