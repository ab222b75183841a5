"""Super-resolution inference, the counterpart of
``srgan_tpu/eval/inference.py``: the ``Upscaler`` (direct, uint8, tiled,
pool ensemble, x8 TTA, EMA weights, reference ``.pth``), ``upscale`` and
the folder server ``upscale_directory``.

Usage:
    up = Upscaler.from_checkpoint("results", "Training")   # on the card
    sr = up.upscale(image)                   # HWC float/uint8 numpy → HWC float
    up.upscale_file("in.jpg", "out.png")     # file → file

Every entry point runs on the card unless given ``device="cpu"``, and
turns TF32 off and deterministic algorithms on (``utils.platform``): a
serving process builds no ``Trainer``, and an fp32 model must run its convs
in full fp32, as the JAX package does. ``devices=[...]`` (``--dp``) serves
data-parallel, one replica a device, the counterpart of JAX's ``mesh=``.
``upscale_directory`` decodes and encodes with the native C++ codec where
it builds (``srgan_tpu_torch.native``), else with PIL.
"""

from __future__ import annotations

import copy
import os
import sys
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from srgan_tpu_torch.config import ModelConfig
from srgan_tpu_torch.models.enhancer import enhance
from srgan_tpu_torch.models.srresnet import SRResNet, init_generator
from srgan_tpu_torch.training.steps import (
    infer_step,
    infer_step_ensemble,
    infer_step_ensemble_u8,
    infer_step_tta,
    infer_step_tta_u8,
    infer_step_u8,
)
from srgan_tpu_torch.utils.image_io import load_image, save_image
from srgan_tpu_torch.utils.platform import (
    disable_tf32,
    make_deterministic,
    resolve_device,
)
from srgan_tpu_torch.utils.profiling import span, to_host


def to_float01(image: np.ndarray) -> np.ndarray:
    """Input-range normalization for inference entry points.

    uint8 input is ALWAYS /255 — branching on dtype, not values: a dark
    uint8 frame (every pixel ≤ 1) must not be taken for float [0, 1] data.
    Float inputs keep a value-range heuristic (max > 1.5 → 0-255-range
    floats from callers that converted without scaling)."""
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    arr = arr.astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    return arr


def _serving_device(device) -> torch.device:
    """The serving entry points' device (``None`` → the card), with TF32
    off and deterministic algorithms on."""
    dev = resolve_device(device)
    disable_tf32()
    make_deterministic()
    return dev


class Upscaler:
    """Holds a generator, or a pool of them, on a device and runs SR
    inference eagerly under ``torch.no_grad``."""

    def __init__(
        self,
        model_or_models: Union[nn.Module, Sequence[nn.Module]],
        *,
        enhance_output: bool = False,
        ensemble: bool = False,
        tta: bool = False,
        device=None,
        devices: Optional[Sequence] = None,
    ):
        """``model_or_models``: one ``SRResNet``, or with ``ensemble=True``
        the pool's members (same architecture), whose member-MEAN SR every
        forward returns (``infer_step_ensemble``). The reference serves only
        member 0 (``src/evaluation.py:22-31``); the ensemble puts the rest to
        work at inference.

        ``tta=True``: x8 dihedral self-ensemble (``infer_step_tta``),
        composable with ``ensemble`` (8N forwards).

        ``devices``: data-parallel serving (``--dp``, JAX's ``mesh=``): one
        replica of the weights on each device, and every batch padded to a
        multiple of the device count with copies of its first image, split
        in order, run on each device, and joined back in order on the first
        (padding dropped). ``device`` is then ignored; without ``devices``,
        one device."""
        if devices is not None:
            if not devices:
                raise ValueError("devices= needs at least one device")
            device = devices[0]
        self.device = _serving_device(device)
        members = (list(model_or_models)
                   if isinstance(model_or_models, (list, tuple))
                   else [model_or_models])
        if len(members) > 1 and not ensemble:
            raise ValueError(
                f"{len(members)} generators given without ensemble=True"
            )
        self.members = [m.to(self.device).eval() for m in members]
        self.model = self.members[0]
        self.enhance_output = enhance_output
        self.ensemble = ensemble
        self.tta = tta
        self.devices = [self.device] + [
            _serving_device(d) for d in (devices or [])[1:]]
        # member lists, one a device; the first is self.members
        self.replicas = [self.members] + [
            [copy.deepcopy(m).to(d).eval() for m in self.members]
            for d in self.devices[1:]]
        # calls of upscale / upscale_u8: the request id of their spans
        self.requests = 0

    @classmethod
    def random_init(cls, cfg: Optional[ModelConfig] = None, seed: int = 0, **kw):
        return cls(init_generator(cfg or ModelConfig(), seed), **kw)

    @classmethod
    def from_checkpoint(
        cls,
        results_dir: str,
        prefix: str = "Training",
        model_cfg: Optional[ModelConfig] = None,
        ensemble: bool = False,
        ema: bool = False,
        **kw,
    ):
        """Load the lead generator from a snapshot written by the port's
        ``training/checkpoint.py`` (the analogue of eval's
        ``Training_generator_model_0.pth`` load, ``src/evaluation.py:22-31``).
        The architecture is read from the ``{prefix}_model.json`` sidecar
        unless given. JAX's Orbax snapshots are not read (ROADMAP.md, queue
        1, item 3).

        ``ensemble=True`` loads EVERY pool member and serves the member-mean
        SR (a one-member snapshot serves the plain forward). ``ema=True``
        serves the EMA shadows saved by ``--ema-decay`` runs."""
        from srgan_tpu_torch.training import checkpoint as ckpt

        model_cfg = model_cfg or ckpt.load_model_config(results_dir, prefix)
        if model_cfg is None:
            raise FileNotFoundError(
                f"no {prefix}_model.json sidecar in {results_dir}; pass "
                "model_cfg explicitly for checkpoints from other sources"
            )
        if ensemble:
            states = ckpt.restore_all_generator_params(results_dir, prefix, ema=ema)
        else:
            states = [ckpt.restore_generator_params(results_dir, prefix, ema=ema)]
        models = []
        for sd in states:
            model = SRResNet.from_config(model_cfg)
            model.load_state_dict(sd)
            models.append(model)
        if len(models) == 1:
            return cls(models[0], **kw)
        return cls(models, ensemble=True, **kw)

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kw):
        """Load a reference PyTorch ``.pth`` generator (BatchNorm folded, DDP
        prefix stripped; ``utils.torch_port``)."""
        from srgan_tpu_torch.utils.torch_port import load_torch_checkpoint

        cfg, sd = load_torch_checkpoint(path)
        model = SRResNet.from_config(cfg)
        model.load_state_dict(sd)
        return cls(model, **kw)

    def _batch(self, image: np.ndarray):
        """HWC or NHWC image → (NHWC float32 tensor on the device in [0, 1],
        whether it was one image). uint8 crosses to the device as uint8 and
        is divided there: the same float32 division as :func:`to_float01`,
        a quarter of the bytes."""
        arr = np.asarray(image)
        if arr.dtype == np.uint8:
            x = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
            x = x.float() / 255.0
        else:
            x = torch.from_numpy(to_float01(arr)).to(self.device)
        return (x[None] if arr.ndim == 3 else x), arr.ndim == 3

    def _local(self, members, x: torch.Tensor, u8: bool) -> torch.Tensor:
        """One device's SR of ``x`` with its ``members``, in the upscaler's
        mode: float32 unclamped without enhance, or uint8 with it."""
        model = members if self.ensemble else members[0]
        if self.tta:
            if u8:
                return infer_step_tta_u8(model, x, enhance_out=self.enhance_output,
                                         ensemble=self.ensemble)
            return infer_step_tta(model, x, ensemble=self.ensemble)
        if self.ensemble:
            return (infer_step_ensemble_u8(members, x, self.enhance_output) if u8
                    else infer_step_ensemble(members, x))
        return infer_step_u8(model, x, self.enhance_output) if u8 else infer_step(model, x)

    def _run(self, x: torch.Tensor, u8: bool) -> torch.Tensor:
        if len(self.devices) == 1:
            return self._local(self.members, x, u8)
        n, k = x.shape[0], len(self.devices)
        pad = (-n) % k
        if pad:  # an equal share for every device
            x = torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
        # each device's share is queued before any result is fetched, so the
        # devices run side by side
        outs = [self._local(members, part.to(d, non_blocking=True), u8)
                for members, part, d in zip(self.replicas, x.chunk(k), self.devices)]
        return torch.cat([o.to(self.device) for o in outs])[:n]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC float batch on the device → SR float32, unclamped, in the
        upscaler's mode (plain, ensemble and/or TTA); no enhance."""
        return self._run(x, u8=False)

    @torch.no_grad()
    def upscale(self, image: np.ndarray) -> np.ndarray:
        """HWC (or NHWC) image in [0, 1] (uint8 accepted) → upscaled HWC
        float32 in [0, 1]."""
        self.requests += 1
        with span("serve.request", request=self.requests):
            with span("serve.upload"):
                x, single = self._batch(image)
            with span("serve.forward"):
                sr = self.forward(x)
                if self.enhance_output:
                    sr = enhance(sr)
                sr = sr.clamp(0.0, 1.0)
            with span("serve.fetch"):
                out = to_host(sr, "Upscaler.upscale", pinned=True).numpy()
        return out[0] if single else out

    def upscale_u8(self, image: np.ndarray) -> np.ndarray:
        """Like :meth:`upscale` but returns uint8, quantised on the device
        (``steps.infer_step_u8``): a quarter of the bytes to fetch, and
        bit-identical to ``array_to_image(self.upscale(x))``'s pixels."""
        self.requests += 1
        with span("serve.request", request=self.requests):
            with span("serve.upload"):
                x, single = self._batch(image)
            with span("serve.forward"):
                out = self._run(x, u8=True)
            with span("serve.fetch"):
                out = to_host(out, "Upscaler.upscale_u8", pinned=True).numpy()
        return out[0] if single else out

    def upscale_file(self, in_path: str, out_path: str) -> None:
        save_image(self.upscale(load_image(in_path)), out_path)

    def upscale_tiled(
        self,
        image: np.ndarray,
        *,
        tile: int = 256,
        overlap: int = 16,
        batch_size: int = 16,
        fetch_u8: bool = False,
    ) -> np.ndarray:
        """Arbitrary-size SR with bounded device memory: JAX's tiling and
        feather blend, in numpy on the host.

        The LR image is covered by fixed ``tile`` windows spaced ``tile -
        overlap`` apart; every tile batch has one shape, so the forward sees
        one input shape whatever the image size. The SR tiles are blended:
        the outer ``overlap // 2`` pixels of an artificial tile edge get
        zero weight, a half-cosine ramp covers the rest of the overlap, and
        the sum is normalised by the total weight (floored at 1e-8). At a
        true image border the tile sees the padding the direct path would.
        Exact against the direct path for ``norm="none"`` models once
        ``overlap >= 2 * receptive_field``; GroupNorm's whole-extent
        statistics make it an approximation otherwise.

        Memory on the device is bounded by ``batch_size`` tiles. A short
        last chunk is padded to the full batch with copies of its first
        tile. ``fetch_u8=True`` quantises each SR tile on the device and
        fetches uint8 (dequantised for the blend; ±1 LSB after
        re-quantisation where tiling is not exact).
        """
        arr = to_float01(image)
        if arr.ndim != 3:
            raise ValueError("upscale_tiled expects a single HWC image")
        if overlap >= tile:
            raise ValueError("overlap must be smaller than tile")
        h, w, c = arr.shape
        s = self.model.upscale_factor

        # Reflect-pad up to at least one tile so tiny images still work.
        # numpy's reflect mode caps each pad at (dim - 1); images much
        # smaller than the tile pad iteratively (mirror-tiling the content).
        ph, pw = max(tile - h, 0), max(tile - w, 0)
        while ph or pw:
            dh = min(ph, arr.shape[0] - 1)
            dw = min(pw, arr.shape[1] - 1)
            if dh == 0 and dw == 0:  # degenerate 1-pixel extent: replicate
                arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)), mode="edge")
                break
            arr = np.pad(arr, ((0, dh), (0, dw), (0, 0)), mode="reflect")
            ph -= dh
            pw -= dw
        hp, wp, _ = arr.shape

        stride = tile - overlap
        ys = list(range(0, max(hp - tile, 0) + 1, stride))
        xs = list(range(0, max(wp - tile, 0) + 1, stride))
        if ys[-1] + tile < hp:
            ys.append(hp - tile)
        if xs[-1] + tile < wp:
            xs.append(wp - tile)

        # Per-edge window profiles: an artificial tile edge (interior cut)
        # gives its `trim` margin zero weight, then a half-cosine ramp over
        # the rest of the overlap; a true image border keeps weight 1.
        trim = (overlap // 2) * s
        m = overlap * s - trim
        taper = np.ones(trim + m, np.float32)
        if m:
            ramp = 0.5 - 0.5 * np.cos(np.pi * (np.arange(m) + 0.5) / m)
            taper = np.concatenate([np.zeros(trim, np.float32), ramp])

        def profile(artificial_lo: bool, artificial_hi: bool) -> np.ndarray:
            p = np.ones(tile * s, np.float32)
            if trim + m:
                if artificial_lo:
                    p[: trim + m] = np.minimum(p[: trim + m], taper)
                if artificial_hi:
                    p[-(trim + m) :] = np.minimum(
                        p[-(trim + m) :], taper[::-1]
                    )
            return p

        acc = np.zeros((hp * s, wp * s, c), np.float32)
        wgt = np.zeros((hp * s, wp * s, 1), np.float32)
        coords = [(y, x) for y in ys for x in xs]
        for i in range(0, len(coords), batch_size):
            chunk = coords[i : i + batch_size]
            batch = np.stack(
                [arr[y : y + tile, x : x + tile] for y, x in chunk]
            )
            if len(chunk) < batch_size:
                # one batch shape for every chunk: pad with copies of tile 0
                batch = np.concatenate(
                    [batch, np.repeat(batch[:1],
                                      batch_size - len(chunk), axis=0)]
                )
            if fetch_u8:
                sr = self.upscale_u8(batch).astype(np.float32) / 255.0
            else:
                sr = self.upscale(batch)
            for (y, x), out in zip(chunk, sr):
                win = np.outer(
                    profile(y > 0, y + tile < hp),
                    profile(x > 0, x + tile < wp),
                )[..., None]
                ys_, xs_ = y * s, x * s
                acc[ys_ : ys_ + tile * s, xs_ : xs_ + tile * s] += out * win
                wgt[ys_ : ys_ + tile * s, xs_ : xs_ + tile * s] += win
        out = acc / np.maximum(wgt, 1e-8)
        return np.clip(out[: h * s, : w * s], 0.0, 1.0)


def upscale(image: np.ndarray, upscaler: Optional[Upscaler] = None) -> np.ndarray:
    """Convenience wrapper: SR one image with a (randomly initialised,
    unless provided) flagship generator on the card."""
    upscaler = upscaler or Upscaler.random_init()
    return upscaler.upscale(image)


def upscale_directory(
    input_dir: str,
    output_dir: str,
    *,
    results_dir: str = "results",
    prefix: str = "Training",
    enhance_output: bool = False,
    batch_size: int = 8,
    upscaler: Optional[Upscaler] = None,
    ensemble: bool = False,
    tta: bool = False,
    ema: bool = False,
    min_bucket_for_direct: int = 4,
    tile: int = 256,
    tile_batch: int = 4,
    tile_overlap: int = 16,
    device=None,
    devices: Optional[Sequence] = None,
) -> int:
    """Batch-serving path: super-resolve every image in a folder
    (``devices``: data-parallel serving, as in :class:`Upscaler`).

    O(batch) host memory: a header-only pass buckets file names by image
    size. Buckets of at least ``min_bucket_for_direct`` files take the
    direct batched path, each batch padded to ``batch_size`` with copies of
    its first image (one input shape a bucket); smaller buckets (ad-hoc
    photos of distinct sizes) go through :meth:`Upscaler.upscale_tiled`,
    one tile shape for every size. Decode of batch k+1 (one worker
    thread), SR of batch k (this thread, uint8 off the device) and encode of
    batch k−1 (another worker, at most 2 batches queued) overlap. The codec
    is the native C++ one (``srgan_tpu_torch.native``: a batch decoded and
    encoded on its threads, the GIL released) where it builds, else PIL; a
    file the native decoder or encoder rejects is retried with PIL, and only
    a file both fail on is skipped, with a warning for an encode and for a
    decoded size that disagrees with the header. Returns the number of
    images written and prints a bucket summary and a timing line, which
    names the codec that served, to stderr.
    """
    import collections
    from concurrent import futures

    from PIL import Image as PILImage

    from srgan_tpu_torch import native
    from srgan_tpu_torch.data.dataset import list_image_files, load_image_rgb

    _serving_device(device if upscaler is None else upscaler.device)
    if upscaler is None:
        from srgan_tpu_torch.training.checkpoint import latest_ckpt_dir

        upscaler = (
            Upscaler.from_checkpoint(
                results_dir, prefix, enhance_output=enhance_output,
                ensemble=ensemble, tta=tta, ema=ema, device=device,
                devices=devices,
            )
            if latest_ckpt_dir(results_dir, prefix) is not None
            else Upscaler.random_init(enhance_output=enhance_output,
                                      device=device, devices=devices)
        )
    os.makedirs(output_dir, exist_ok=True)
    t_start = time.perf_counter()
    seconds = {"decode": 0.0, "sr": 0.0, "encode": 0.0}

    # Header-only size pass: no pixel decode, O(1) memory per file.
    buckets = collections.defaultdict(list)
    for fname in list_image_files(input_dir):
        try:
            with PILImage.open(os.path.join(input_dir, fname)) as im:
                buckets[(im.height, im.width)].append(fname)
        except Exception:
            continue  # unreadable — skip (training-loader parity)

    use_native = native.available()
    native_enc = use_native and native.encoder_available()
    codec = "native" if native_enc else (
        "PIL" + ("" if native.build_error() is None
                 else f" (native codec unavailable: {native.build_error()})"))

    def decode(h, w, chunk):
        t0 = time.perf_counter()
        imgs, names, retry = [], [], chunk
        if use_native:
            paths = [os.path.join(input_dir, f) for f in chunk]
            batch, ok = native.load_batch_u8(paths, h, w)
            imgs = [batch[j] for j in np.flatnonzero(ok)]
            names = [f for f, o in zip(chunk, ok) if o]
            # what the native decoder rejects (a CMYK JPEG, an exotic PNG)
            # but PIL reads is still served
            retry = [f for f, o in zip(chunk, ok) if not o]
        for f in retry:
            img = load_image_rgb(os.path.join(input_dir, f))
            if img is None:
                continue
            if img.shape[:2] == (h, w):
                imgs.append(img)
                names.append(f)
            else:
                # the header said (h, w) but the decode disagrees (e.g. an
                # EXIF-rotated JPEG): it cannot join this batch — skip
                # visibly
                print(
                    f"warning: {f}: decoded shape {img.shape[:2]} != "
                    f"header {(h, w)}; skipped",
                    file=sys.stderr,
                )
        seconds["decode"] += time.perf_counter() - t0
        return (np.stack(imgs) if imgs else
                np.zeros((0, h, w, 3), np.uint8)), names

    def write_batch(sr_u8, out_paths):
        t0 = time.perf_counter()
        n_ok = 0
        fails = range(len(out_paths))
        if native_enc:
            ok = native.save_batch_u8(out_paths, sr_u8)
            n_ok += int(ok.sum())
            fails = np.flatnonzero(~ok)
        for j in fails:  # an extension the codec lacks, or no codec: PIL
            # one unwritable file (bad extension, disk error) must not
            # abort the remaining batches
            try:
                PILImage.fromarray(sr_u8[j]).save(out_paths[j])
                n_ok += 1
            except Exception as e:
                print(f"warning: failed to encode {out_paths[j]}: {e}; skipped",
                      file=sys.stderr)
        seconds["encode"] += time.perf_counter() - t0
        return n_ok

    with futures.ThreadPoolExecutor(max_workers=1) as decoder, \
            futures.ThreadPoolExecutor(max_workers=1) as writer:
        writes = []
        written = 0

        def submit_write(sr_u8, out_paths):
            # keep the write pipeline 2-deep: each queued future pins its
            # whole uint8 batch
            nonlocal written
            while len(writes) >= 2:
                written += writes.pop(0).result()
            writes.append(writer.submit(write_batch, sr_u8, out_paths))

        direct = {
            hw: fnames
            for hw, fnames in buckets.items()
            if len(fnames) >= min_bucket_for_direct
        }
        odd = [
            (hw, f)
            for hw, fnames in buckets.items()
            if len(fnames) < min_bucket_for_direct
            for f in fnames
        ]

        for (h, w), fnames in direct.items():
            chunks = [
                fnames[i : i + batch_size]
                for i in range(0, len(fnames), batch_size)
            ]
            fut = decoder.submit(decode, h, w, chunks[0])
            for ci in range(len(chunks)):
                batch, names = fut.result()
                if ci + 1 < len(chunks):  # overlap decode with device SR
                    fut = decoder.submit(decode, h, w, chunks[ci + 1])
                if not len(batch):
                    continue
                n_real = len(batch)
                if n_real < batch_size:
                    batch = np.concatenate(
                        [batch,
                         np.repeat(batch[:1], batch_size - n_real, axis=0)]
                    )
                t0 = time.perf_counter()
                sr_u8 = upscaler.upscale_u8(batch)[:n_real]
                seconds["sr"] += time.perf_counter() - t0
                out_paths = [os.path.join(output_dir, f) for f in names]
                submit_write(sr_u8, out_paths)

        # Odd sizes: one tile shape serves them all.
        for (h, w), fname in odd:
            batch, names = decode(h, w, [fname])
            if not len(batch):
                continue
            t0 = time.perf_counter()
            sr = upscaler.upscale_tiled(
                batch[0], tile=tile, batch_size=tile_batch,
                overlap=min(tile_overlap, tile // 2),
                fetch_u8=True,
            )
            # host re-quantisation, infer_step_u8's formula (the identity
            # on the fetched tile values k/255)
            sr_u8 = np.floor(np.clip(sr, 0.0, 1.0) * 255.0 + 0.5).astype(
                np.uint8
            )[None]
            seconds["sr"] += time.perf_counter() - t0
            submit_write(sr_u8, [os.path.join(output_dir, names[0])])

        written += sum(w.result() for w in writes)
    if odd or len(direct) > 1:
        print(
            f"upscale_directory: {len(direct)} direct size bucket(s), "
            f"{len(odd)} odd-size file(s) via the shared tile executable "
            f"(≤ {len(direct) + 1} SR compiles total)",
            file=sys.stderr,
        )
    wall = time.perf_counter() - t_start
    print(
        f"upscale_directory: {written} image(s) in {wall:.3f} s "
        f"({written / wall:.2f} img/s); decode {seconds['decode']:.3f} s, "
        f"SR {seconds['sr']:.3f} s, encode {seconds['encode']:.3f} s "
        f"(decode and encode on their own threads); codec {codec}",
        file=sys.stderr,
    )
    return written
