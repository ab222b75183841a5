"""Snapshots of the full training state and the two-phase fine-tune resume,
the counterpart of ``srgan_tpu/training/checkpoint.py`` with ``torch.save``
in place of Orbax.

The payload is JAX's: for each generator its ``params``, its optimizer
state (``opt_state``: Adam's ``mu``, ``nu`` and ``count`` in place of
optax's state) and, when trained, ``ema_params``; the pool's bookkeeping
(``pool_meta``, ``GeneratorPool.snapshot()``), the ``epoch`` and, in the
GAN phase, the ``discriminator``'s ``params`` and ``opt_state``. Tensors are
keyed by the model's ``state_dict`` names and saved on the host, each list
(``params``, ``mu``, ...) as views of one host buffer a dtype.

A restore crosses phases and pool sizes as JAX's does: a pixel-phase
snapshot restores into a GAN trainer (its fresh discriminator kept), a
GAN-phase one into a pixel trainer (the saved discriminator read and
dropped); a pool that grew warm-starts its extra members as copies of the
restored leader (params and EMA shadows, their own fresh Adam state), and
a pool that shrank keeps the first members of the loss-sorted snapshot.

On disk, as in JAX: each snapshot is a directory ``{prefix}_ckpt@{epoch}``
(``…@{epoch}.{k}`` when that epoch was snapshotted before), written under a
temporary name and committed by ``os.replace``; older snapshots are deleted
only after a newer one commits, so at every instant one complete snapshot
exists. A ``{prefix}_model.json`` sidecar records the architecture: for
an SRResNet byte-equal to JAX's for the same ``ModelConfig``, for another
architecture every field, ``generator`` among them.

Periodic saves (``block=False``) copy every tensor to the host before
``save_checkpoint`` returns (the train step updates the parameters in
place), then write on a background thread; ``wait_for_checkpoints`` settles
them and re-raises a writer's error. Not ported: restoring JAX's Orbax
snapshots.
"""

from __future__ import annotations

import concurrent.futures as futures
import dataclasses
import json
import math
import os
import shutil
from typing import List, Optional

import torch

from srgan_tpu_torch.config import ModelConfig, TrainConfig, shared_fields
from srgan_tpu_torch.training.pool import GeneratorPool
from srgan_tpu_torch.training.train_state import TrainState

FINETUNE_PREFIX = "Post-Training"  # ``src/train.py:58``
PAYLOAD_FILE = "state.pt"
# A snapshot is written under ``{final name}{TMP_SUFFIX}`` and renamed to
# its final name when complete.
TMP_SUFFIX = ".tmp-write"

# The background writer of periodic snapshots and its one in-flight save.
_writer: Optional[futures.ThreadPoolExecutor] = None
_in_flight: Optional[futures.Future] = None


def wait_for_checkpoints() -> None:
    """Block until the in-flight async snapshot is on disk; re-raise the
    writer's error if it failed."""
    global _in_flight
    pending, _in_flight = _in_flight, None
    if pending is not None:
        pending.result()


def _ckpt_base(results_dir: str, prefix: str) -> str:
    return os.path.abspath(os.path.join(results_dir, f"{prefix}_ckpt"))


def _committed_ckpt_dirs(results_dir: str, prefix: str) -> list:
    """Committed snapshot dirs for ``prefix``, oldest → newest (by epoch,
    then slot). Temporary dirs of writes in progress, or of writes a crash
    cut short, are not snapshots."""
    base = f"{prefix}_ckpt"
    out = []
    if not os.path.isdir(results_dir):
        return out
    for name in os.listdir(results_dir):
        if not name.startswith(base + "@") or TMP_SUFFIX in name:
            continue
        epoch_s, _, k_s = name[len(base) + 1:].partition(".")
        try:
            key = (int(epoch_s), int(k_s or 0))
        except ValueError:
            continue
        out.append((key, os.path.join(results_dir, name)))
    return [os.path.abspath(p) for _, p in sorted(out)]


def latest_ckpt_dir(results_dir: str, prefix: str) -> Optional[str]:
    """Newest committed snapshot dir for ``prefix`` (None if none)."""
    dirs = _committed_ckpt_dirs(results_dir, prefix)
    return dirs[-1] if dirs else None


def _next_ckpt_dir(results_dir: str, prefix: str, epoch: int) -> str:
    """A fresh versioned dir name for this snapshot: one past the HIGHEST
    slot ever used for this epoch, never the first free hole (GC frees low
    slots while a higher one can still hold an older snapshot, and a
    refilled hole would sort below it). Temporary dirs count as used."""
    base = _ckpt_base(results_dir, prefix)
    name0 = os.path.basename(base) + f"@{epoch}"
    try:
        names = os.listdir(os.path.dirname(base))
    except FileNotFoundError:
        names = []
    ks = []
    for name in names:
        if not name.startswith(name0):
            continue
        rest = name[len(name0):]  # "" | ".k" | either with TMP_SUFFIX
        if rest == "" or rest.startswith(TMP_SUFFIX):
            ks.append(0)
        elif rest.startswith("."):
            k_s = rest[1:].split(".", 1)[0]
            if k_s.isdigit():
                ks.append(int(k_s))
    k = max(ks) + 1 if ks else 0
    return f"{base}@{epoch}" + (f".{k}" if k else "")


def _gc_old_ckpts(results_dir: str, prefix: str, keep: str) -> None:
    """Delete committed snapshots other than ``keep``."""
    keep = os.path.abspath(keep)
    for path in _committed_ckpt_dirs(results_dir, prefix):
        if path != keep:
            shutil.rmtree(path, ignore_errors=True)


def _host(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of ``tensors`` (copies even of CPU tensors: the step
    updates the originals in place), one transfer a dtype: the tensors are
    flattened into one buffer on their device, which crosses at once, and
    each copy is a view of it. One synchronous transfer a tensor would cost
    a round trip each (SwinIR-M: 496 a list)."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx]).cpu()
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def _named(state: TrainState, tensors) -> dict:
    names = [n for n, _ in state.model.named_parameters()]
    return dict(zip(names, _host(list(tensors))))


def _state_entry(state: TrainState) -> dict:
    return {
        "params": _named(state, state.params),
        "opt_state": {
            "mu": _named(state, state.mu),
            "nu": _named(state, state.nu),
            "count": state.count,
        },
    }


def _generator_entry(state: TrainState) -> dict:
    entry = _state_entry(state)
    if state.ema_params:
        entry["ema_params"] = _named(state, state.ema_params)
    return entry


def _write(path: str, payload: dict, gc_prefix: Optional[tuple]) -> None:
    """Write the payload under a temporary name, commit it by renaming, then
    (``gc_prefix`` = (results_dir, prefix)) delete the older snapshots."""
    tmp = path + TMP_SUFFIX
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, PAYLOAD_FILE))
    os.replace(tmp, path)
    if gc_prefix is not None:
        _gc_old_ckpts(*gc_prefix, keep=path)


def save_checkpoint(
    results_dir: str,
    prefix: str,
    *,
    pool: GeneratorPool,
    epoch: int,
    d_state: Optional[TrainState] = None,
    model_config: Optional[ModelConfig] = None,
    block: bool = True,
) -> str:
    """Write a complete training snapshot (every generator, the
    discriminator where given, the pool's bookkeeping, the epoch) and, given
    ``model_config``, the architecture sidecar. Returns the snapshot's final
    path."""
    global _writer, _in_flight
    # settle the in-flight save first: its commit must be visible to the
    # slot probe, and two writers must never race
    wait_for_checkpoints()
    path = _next_ckpt_dir(results_dir, prefix, epoch)
    prev = latest_ckpt_dir(results_dir, prefix)
    os.makedirs(results_dir, exist_ok=True)
    if model_config is not None:
        with open(os.path.join(results_dir, f"{prefix}_model.json"), "w") as f:
            json.dump(_sidecar(model_config), f, indent=2)
    payload = {
        "generators": [_generator_entry(m.state) for m in pool.members],
        "pool_meta": pool.snapshot(),
        "epoch": epoch,
    }
    if d_state is not None:
        payload["discriminator"] = _state_entry(d_state)
    if block:
        _write(path, payload, (results_dir, prefix))
    else:
        # The tensors are on the host already. The newest committed
        # snapshot (``prev``) stays until this one commits in its turn at
        # the next save; every older one goes now.
        if prev is not None:
            _gc_old_ckpts(results_dir, prefix, keep=prev)
        if _writer is None:
            _writer = futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint"
            )
        _in_flight = _writer.submit(_write, path, payload, None)
    return path


def _load(path: str, device) -> dict:
    return torch.load(os.path.join(path, PAYLOAD_FILE),
                      map_location=device, weights_only=True)


@torch.no_grad()
def _copy_into(state: TrainState, tensors: List[torch.Tensor], saved: dict,
               what: str) -> None:
    """Copy a saved ``{name: tensor}`` into the state's own tensors, in
    place: ``TrainState.params`` are the model's parameters, so swapping
    the tensors would leave Adam updating the old ones."""
    names = [n for n, _ in state.model.named_parameters()]
    if set(saved) != set(names):
        raise ValueError(
            f"checkpoint {what} do not match the model: missing "
            f"{sorted(set(names) - set(saved))}, unexpected "
            f"{sorted(set(saved) - set(names))}"
        )
    for n, t in zip(names, tensors):
        t.copy_(saved[n])


def _restore_state(st: TrainState, entry: dict) -> None:
    """Params and Adam state of a saved entry into ``st``, in place."""
    _copy_into(st, st.params, entry["params"], "params")
    _copy_into(st, st.mu, entry["opt_state"]["mu"], "Adam mu")
    _copy_into(st, st.nu, entry["opt_state"]["nu"], "Adam nu")
    st.count = int(entry["opt_state"]["count"])


def restore_checkpoint(results_dir: str, prefix: str, *, pool: GeneratorPool,
                       d_state: Optional[TrainState] = None):
    """Restore the newest committed snapshot in place into ``pool``'s
    states (and ``d_state``'s), loading it straight onto their device.
    Returns (pool, d_state, epoch).

    A snapshot with or without EMA shadows restores into a run with or
    without them: an EMA run resuming a pre-EMA snapshot warm-starts the
    shadows from the restored params; a run without EMA drops saved ones.
    The same holds for the discriminator across the two phases, and for
    pool sizes (see the module's docstring). The pool's counters and, in
    auto-gate mode, a calibrated gate threshold are restored too."""
    path = latest_ckpt_dir(results_dir, prefix)
    if path is None:
        raise FileNotFoundError(
            f"no committed checkpoint for prefix '{prefix}' in "
            f"{results_dir} (looked for {prefix}_ckpt@epoch dirs)"
        )
    restored = _load(path, pool.leader.state.params[0].device)
    n_disk = len(restored["generators"])
    ema_warm_started = False
    for m, g in zip(pool.members, restored["generators"]):
        st = m.state
        _restore_state(st, g)
        if st.ema_params:
            if "ema_params" in g:
                _copy_into(st, st.ema_params, g["ema_params"], "EMA shadows")
            else:
                # the same rule as a fresh TrainState: shadow = params
                _copy_into(st, st.ema_params, g["params"], "params")
                ema_warm_started = True
    if ema_warm_started:
        print(
            f"checkpoint '{prefix}' has no EMA shadows; warm-starting them "
            "from the restored params"
        )
    for m, meta in zip(pool.members, restored["pool_meta"]):
        m.running_loss = float(meta["running_loss"])
        m.pre_loss = float(meta["pre_loss"])
        m.gan_updates = int(meta["gan_updates"])
        m.pixel_updates = int(meta["pixel_updates"])
    gate = restored["pool_meta"][0].get("gan_threshold")
    # auto-gate mode only (an explicit starting_gan_loss always wins); NaN =
    # the saved run had not calibrated yet
    if (gate is not None and pool.cfg.starting_gan_loss is None
            and math.isfinite(float(gate))):
        pool.gan_threshold = float(gate)
    if len(pool.members) > n_disk:
        # the pool grew across phases: copies of the restored leader, each
        # member keeping its own fresh Adam state
        lead = pool.members[0].state
        with torch.no_grad():
            for m in pool.members[n_disk:]:
                torch._foreach_copy_(m.state.params, lead.params)
                if m.state.ema_params:
                    torch._foreach_copy_(m.state.ema_params,
                                         lead.ema_params or lead.params)
        print(
            f"checkpoint '{prefix}' has {n_disk} generator(s); pool wants "
            f"{len(pool.members)} — extra members warm-started from the "
            "restored leader"
        )
    elif len(pool.members) < n_disk:
        print(
            f"checkpoint '{prefix}' has {n_disk} generators; pool wants "
            f"{len(pool.members)} — keeping the best (first) "
            f"{len(pool.members)} of the loss-sorted snapshot"
        )
    if d_state is not None and "discriminator" in restored:
        _restore_state(d_state, restored["discriminator"])
    return pool, d_state, int(restored["epoch"])


def _sidecar(cfg: ModelConfig) -> dict:
    """The sidecar's fields: an SRResNet's are JAX's (``shared_fields``, so
    the file is byte-equal to the JAX package's), another architecture's
    are all of them, ``generator`` among them."""
    return shared_fields(cfg) if cfg.generator == "srresnet" else dataclasses.asdict(cfg)


def load_model_config(results_dir: str, prefix: str) -> Optional[ModelConfig]:
    """Read the architecture sidecar written by :func:`save_checkpoint`."""
    path = os.path.join(results_dir, f"{prefix}_model.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    # tolerate sidecars of other versions: drop keys ModelConfig lacks
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    data = {k: tuple(v) if isinstance(v, list) else v for k, v in data.items()
            if k in fields}
    return ModelConfig(**data)


def restore_generator_params(results_dir: str, prefix: str, index: int = 0,
                             *, ema: bool = False) -> dict:
    """One generator's params as a ``state_dict`` on the CPU, no optimizer
    state or Trainer needed; ``ema=True`` reads the EMA shadow."""
    return restore_all_generator_params(results_dir, prefix, ema=ema)[index]


def restore_all_generator_params(results_dir: str, prefix: str, *,
                                 ema: bool = False) -> list:
    """Every pool member's params (leader first), each a ``state_dict`` on
    the CPU. ``ema=True`` reads the EMA shadows and raises ``KeyError`` when
    the snapshot has none."""
    path = latest_ckpt_dir(results_dir, prefix)
    if path is None:
        raise FileNotFoundError(
            f"no committed checkpoint for prefix '{prefix}' in {results_dir}"
        )
    restored = _load(path, "cpu")
    key = "ema_params" if ema else "params"
    if ema and "ema_params" not in restored["generators"][0]:
        raise KeyError(
            f"checkpoint '{prefix}' in {results_dir} has no EMA shadows "
            "(run was trained without --ema-decay); drop --ema or retrain"
        )
    return [g[key] for g in restored["generators"]]


def finetune_entry(cfg: TrainConfig) -> TrainConfig:
    """The two-phase resume transform: LRs ÷ finetune_lr_divisor, prefix →
    "Post-Training" (``src/train.py:51-59``)."""
    return dataclasses.replace(
        cfg,
        lr_generator=cfg.lr_generator / cfg.finetune_lr_divisor,
        lr_discriminator=cfg.lr_discriminator / cfg.finetune_lr_divisor,
        run_prefix=FINETUNE_PREFIX,
    )
