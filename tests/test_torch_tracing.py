"""The port's spans and host-sync counts (``srgan_tpu_torch/utils/profiling.py``)
on the CPU at tiny sizes: nothing is recorded, and no clock or
``record_function`` is touched, with no profiler on; under ``trace`` the
training loop, the pool's two executors and the ``Upscaler`` record the span trees their call sites promise, on the clock
of the profiler's events; and the benchmark's six span readers
(``h100bench/metrics/``) split device idle between spans as they say."""

from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from srgan_tpu_torch.config import (
    Config,
    DataConfig,
    DiscriminatorConfig,
    ModelConfig,
    PoolConfig,
    TrainConfig,
)
from srgan_tpu_torch.data.dataset import ArrayDataset
from srgan_tpu_torch.eval.inference import Upscaler
from srgan_tpu_torch.training.loop import Trainer
from srgan_tpu_torch.utils import profiling

torch.set_num_threads(1)

BATCH = 2
STEPS = 3  # 10 clips, split 0.7 → 7 rows, 3 batches of 2


def _data(n_train=10, n_val=4, hw=(32, 64), seed=0):
    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (n_train + n_val, *hw, 3), dtype=np.uint8)
    return ArrayDataset(clips[:n_train]), ArrayDataset(clips[n_train:])


def _config(results, epochs=1, n=1, gan=False, **pool) -> Config:
    return Config(
        model=ModelConfig(num_features=8, num_residuals=1, upscale_factor=4),
        discriminator=DiscriminatorConfig(num_filters=8, num_stages=2),
        data=DataConfig(hr_size=(32, 64), upscale_factor=4, batch_size=BATCH,
                        noise_std_max=0.0, num_workers=1),
        pool=PoolConfig(num_generators=n, **pool),
        train=TrainConfig(num_epochs=epochs, score_max_batches=2, progress="off",
                          use_gan=gan, results_dir=str(results), validate_every=0),
    )


def _train(cfg: Config) -> Trainer:
    trainer = Trainer(cfg, device="cpu")
    trainer.train(*_data())
    return trainer


def _traced(tmp_path, fn):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        out = fn()
    return out, prof, profiling.spans()


def _check_tree(recs):
    """Every parent is recorded and holds its child in time."""
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.end_ns is not None and r.start_ns <= r.end_ns, r
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (p, r)
    return by_id


def _names(recs, name):
    return [r for r in recs if r.name == name]


def _parent_name(r, by_id):
    return by_id[r.parent].name if r.parent is not None else None


# --------------------------------------------------------------- off path


def test_no_profiler_records_nothing(tmp_path):
    profiling.clear_spans()
    _train(_config(tmp_path))
    up = Upscaler.random_init(ModelConfig(num_features=8, num_residuals=1), device="cpu")
    up.upscale_u8(np.zeros((8, 8, 3), np.uint8))
    assert profiling.spans() == []
    assert up.requests == 1


def test_no_profiler_reads_no_clock_and_opens_no_record_function(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("touched with no profiler on")

    monkeypatch.setattr(profiling, "record_function", boom)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(time_ns=boom))
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    out = Trainer(_config(tmp_path, gan=True, n=3), device="cpu").train(*_data())
    assert out["epoch"] == 1
    up = Upscaler.random_init(ModelConfig(num_features=8, num_residuals=1), device="cpu")
    assert up.upscale_u8(np.zeros((8, 8, 3), np.uint8)).shape == (32, 32, 3)


def test_off_span_is_one_shared_null_context():
    assert profiling.span("x", a=1) is profiling.tags(a=1) is profiling.span("y")
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(profiling.to_host(x, "test"), x)


@pytest.mark.parametrize("pinned", [False, True])
def test_to_host_is_one_sync_span(tmp_path, pinned):
    """A read, page-locked or not (a CPU tensor is read by ``.cpu()``
    either way), is one ``sync`` span named by its site."""
    x = torch.arange(6.0).reshape(2, 3)
    out, _, recs = _traced(tmp_path, lambda: profiling.to_host(x, "test", pinned=pinned))
    assert torch.equal(out, x)
    assert [(r.name, r.attrs) for r in recs] == [("sync", {"site": "test"})]


def test_host_read_spans_only_its_wait(tmp_path):
    """A read queued early opens no span; waiting for it is one ``sync``
    span named by its site, and it reads the tensor as it was queued."""
    x = torch.arange(6.0).reshape(2, 3)

    def read():
        r = profiling.HostRead(x, "test")
        assert profiling.spans() == []
        return r.result()

    out, _, recs = _traced(tmp_path, read)
    assert torch.equal(out, x)
    assert [(r.name, r.attrs) for r in recs] == [("sync", {"site": "test"})]


# ------------------------------------------------------------- span trees


def test_training_span_tree(tmp_path):
    cfg = _config(tmp_path / "res", epochs=2)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, checkpoint_every=1))
    _, _, recs = _traced(tmp_path, lambda: _train(cfg))
    by_id = _check_tree(recs)
    epochs = _names(recs, "loop.epoch")
    assert [r.attrs["epoch"] for r in epochs] == [0, 1]
    for ep in epochs:
        kids = [r.name for r in recs if r.parent == ep.id]
        assert kids == ["loop.train_epoch", "loop.end_epoch", "loop.snapshot",
                        "loop.score", "loop.record"], kids
    # the final snapshot and the settle in ``finally``, outside any epoch
    assert [r.parent for r in _names(recs, "loop.snapshot")][-2:] == [None, None]
    for name in ("data.batch", "loop.drain"):
        assert {_parent_name(r, by_id) for r in _names(recs, name)} == {"loop.train_epoch"}
    members = _names(recs, "step.member")
    assert len(members) == 2 * STEPS
    assert {(r.attrs["member"], r.attrs["gan"]) for r in members} == {(0, False)}
    # each step's spans share (epoch, step): its batch, its update, its
    # drain; each epoch's last data.batch is the next() that ends it
    for kind, extra in (("data.batch", 1), ("step.member", 0), ("loop.drain", 0)):
        keys = [(r.attrs["epoch"], r.attrs["step"]) for r in _names(recs, kind)]
        assert keys == [(e, s) for e in (0, 1) for s in range(STEPS + extra)], kind
    # one sync a batch in the loop, inside the drain of that batch
    loop_syncs = [r for r in _names(recs, "sync") if _parent_name(r, by_id) == "loop.drain"]
    assert len(loop_syncs) == 2 * STEPS
    for s in loop_syncs:
        assert s.attrs["step"] == by_id[s.parent].attrs["step"]
        assert s.attrs["site"] == "train_epoch.drain"
    scores = [r for r in _names(recs, "sync") if _parent_name(r, by_id) == "loop.score"]
    assert len(scores) == 2 * 2 and {s.attrs["epoch"] for s in scores} == {0, 1}


@pytest.mark.parametrize("exec_", ["scan", "vmap"])
def test_pool_span_trees(tmp_path, exec_):
    cfg = _config(tmp_path / "res", n=3, gan=True, member_exec=exec_, p_gan_above=0.6)
    _, _, recs = _traced(tmp_path, lambda: _train(cfg))
    by_id = _check_tree(recs)
    steps = _names(recs, "step.d")
    assert len(steps) == STEPS
    if exec_ == "vmap":
        assert len(_names(recs, "step.pool")) == STEPS and not _names(recs, "step.member")
    else:
        members = _names(recs, "step.member")
        assert [r.attrs["member"] for r in members] == [0, 1, 2] * STEPS
        assert all(isinstance(r.attrs["gan"], bool) for r in members)
        assert not _names(recs, "step.pool")
    for r in recs:
        if r.name.startswith("step."):
            assert r.attrs["epoch"] == 0 and 0 <= r.attrs["step"] < STEPS
            assert _parent_name(r, by_id) == "loop.train_epoch"
    assert len([r for r in _names(recs, "sync")
                if _parent_name(r, by_id) == "loop.drain"]) == STEPS


@pytest.mark.parametrize("call", ["upscale_u8", "upscale"])
def test_serving_span_tree(tmp_path, call):
    up = Upscaler.random_init(ModelConfig(num_features=8, num_residuals=1), device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (8, 12, 3), dtype=np.uint8)
    plain = getattr(up, call)(img)
    first = up.requests
    outs, _, recs = _traced(tmp_path, lambda: [getattr(up, call)(img) for _ in range(3)])
    for out in outs:
        np.testing.assert_array_equal(out, plain)
    _check_tree(recs)
    reqs = _names(recs, "serve.request")
    assert [r.attrs["request"] for r in reqs] == [first + 1, first + 2, first + 3]
    for req in reqs:
        kids = [r for r in recs if r.parent == req.id]
        assert [r.name for r in kids] == ["serve.upload", "serve.forward", "serve.fetch"]
        sync = [r for r in recs if r.parent == kids[-1].id]
        assert [r.name for r in sync] == ["sync"]
        assert sync[0].attrs == {"request": req.attrs["request"], "site": f"Upscaler.{call}"}
        assert all(r.attrs["request"] == req.attrs["request"] for r in kids)


# ------------------------------------------------------------------ clock


def test_spans_on_the_profilers_clock(tmp_path):
    x = torch.randn(64, 64)

    def work():
        for i in range(20):
            with profiling.span("clock", i=i):
                torch.mm(x, x)

    _, prof, recs = _traced(tmp_path, work)
    events = list(prof.profiler.kineto_results.events())
    mine = sorted((e for e in events if e.name() == "srgan.clock"), key=lambda e: e.start_ns())
    mms = sorted((e for e in events if e.name() == "aten::mm"), key=lambda e: e.start_ns())
    assert len(mine) == len(mms) == len(recs) == 20
    for rec, ev, mm in zip(recs, mine, mms):
        assert rec.start_ns <= mm.start_ns() and mm.start_ns() + mm.duration_ns() <= rec.end_ns
        assert rec.start_ns <= ev.start_ns()
        assert rec.start_ns <= ev.start_ns() + ev.duration_ns() <= rec.end_ns


def test_trace_json_carries_attrs(tmp_path):
    def work():
        with profiling.span("outer", epoch=2):
            with profiling.tags(step=5):
                with profiling.span("inner", member=1):
                    torch.ones(4).sum()

    _traced(tmp_path, work)
    doc = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    args = {e["name"]: e.get("args", {}) for e in doc["traceEvents"]
            if e.get("name", "").startswith(profiling.PREFIX)}
    assert args["srgan.outer"]["epoch"] == 2
    assert {k: args["srgan.inner"][k] for k in ("epoch", "step", "member")} == {
        "epoch": 2, "step": 5, "member": 1}


def test_throughput_counts_drained_batches(tmp_path, monkeypatch):
    """The progress line's rate counts the batches whose losses were read."""
    from srgan_tpu_torch.utils import logging as tlog

    seen = []
    monkeypatch.setattr(tlog.ProgressLine, "update",
                        lambda self, epoch, batch, losses, ips: seen.append(batch))
    trainer = Trainer(_config(tmp_path), device="cpu")
    from srgan_tpu_torch.data.pipeline import TrainPipeline

    counts = []
    add = trainer.throughput.add
    monkeypatch.setattr(trainer.throughput, "add",
                        lambda n: (add(n), counts.append(trainer.throughput.images)))
    pipe = TrainPipeline(trainer.cfg.data, _data()[0], use_split=True, device="cpu")
    out = trainer.train_epoch(pipe, 0)
    assert seen == [1, 2, 3] and counts == [BATCH, 2 * BATCH, 3 * BATCH]
    assert out["n_batches"] == STEPS and out["images_per_sec"] > 0


# ---------------------------------------------------------------- readers


def _rec(i, parent, name, a, b, **attrs):
    r = profiling.Span(i, parent, name, attrs)
    r.start_ns, r.end_ns = int(a * 1e9), int(b * 1e9)
    return r


def _reader(name):
    from h100bench import run

    return run.reader(name)


TRAIN_SPANS = [
    _rec(1, None, "loop.train_epoch", 0.0, 10.0),
    _rec(2, 1, "data.batch", 1.0, 2.0),
    _rec(3, 1, "step.member", 2.0, 4.0),
    _rec(4, 1, "loop.drain", 4.0, 6.0),
    _rec(5, 4, "sync", 4.5, 5.0),
    _rec(6, None, "loop.score", 10.0, 11.0),
    _rec(7, 6, "sync", 10.5, 10.6),
    _rec(8, None, "loop.snapshot", 11.0, 11.5),
]
# device busy on [0, 1.5], [3, 4.2], [8, 9], [10.8, 12]: idle (1.5, 3) across
# data.batch and step.member, (4.2, 8) across the drain, its sync and the
# epoch's own span, (9, 10.8) partly in the epoch, the score and its sync
TRAIN_EVENTS = [("k", 0.0, 1.5), ("k", 3.0, 4.2), ("k", 8.0, 9.0), ("k", 10.8, 12.0)]
SERVE_SPANS = [
    _rec(1, None, "serve.request", 0.0, 4.0, request=1),
    _rec(2, 1, "serve.upload", 0.0, 1.0, request=1),
    _rec(3, 1, "serve.forward", 1.0, 2.0, request=1),
    _rec(4, 1, "serve.fetch", 2.5, 4.0, request=1),
    _rec(5, 4, "sync", 2.6, 3.9, request=1, site="Upscaler.upscale_u8"),
    _rec(6, None, "serve.request", 5.0, 6.0, request=2),
    _rec(7, 6, "serve.upload", 5.0, 5.5, request=2),
]
# busy [0.5, 1.8], [3.0, 3.2], [5.2, 6.5]: idle (1.8, 3.0) in the forward,
# the request (2.0-2.5), the fetch and its sync; (3.2, 5.2) in the sync, the
# fetch, no span (4-5) and the second upload
SERVE_EVENTS = [("k", 0.5, 1.8), ("k", 3.0, 3.2), ("k", 5.2, 6.5)]


def _run(kind, events, **kw):
    base = dict(kind=kind, window_s=20.0, events=events)
    base.update(dict(steps=2) if kind == "train" else dict(requests=2))
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture
def fed(monkeypatch):
    def feed(recs):
        monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    return feed


def test_idle_split_at_span_boundaries():
    from h100bench import spans

    idle = spans.idle_by_span(TRAIN_EVENTS, TRAIN_SPANS)
    want = {2: 0.5, 3: 1.0, 4: 0.3 + 1.0, 5: 0.5, 1: 2.0 + 1.0, 6: 0.5 + 0.2, 7: 0.1}
    assert idle.keys() == want.keys()
    for k, v in want.items():
        assert idle[k] == pytest.approx(v), k
    # idle outside every span: (4, 5) in the serving trace
    idle = spans.idle_by_span(SERVE_EVENTS, SERVE_SPANS)
    assert idle[None] == pytest.approx(1.0)
    assert sum(idle.values()) == pytest.approx(1.2 + 2.0)


def test_training_readers(fed):
    fed(TRAIN_SPANS)
    run = _run("train", TRAIN_EVENTS)
    # data.batch 0.5 + step.member 1.0 + drain 1.3 + its sync 0.5, over 2 steps;
    # the epoch's own 3.0 s and the score's are left out
    assert _reader("step.idle_ms")(run) == pytest.approx(1e3 * 3.3 / 2)
    assert _reader("step.host_syncs")(run) == pytest.approx(0.5)
    assert _reader("loop.score_share")(run) == pytest.approx(100 * 1.0 / 20)
    assert _reader("loop.snapshot_share")(run) == pytest.approx(100 * 0.5 / 20)
    # no device events: the device readers are silent, the host ones are not
    assert _reader("step.idle_ms")(_run("train", [])) is None
    assert _reader("step.host_syncs")(_run("train", [])) == pytest.approx(0.5)


def test_serving_readers(fed):
    fed(SERVE_SPANS)
    run = _run("serve", SERVE_EVENTS)
    # forward 0.2, fetch 0.1 + 0.1, sync 0.4 + 0.7, the second request's
    # upload 0.2 (it opened with its request); the request's own 0.5 and
    # the 1.0 s outside every span are left out
    assert _reader("serve.idle_ms")(run) == pytest.approx(1e3 * 1.7 / 2)
    assert _reader("serve.upload_ms")(run) == pytest.approx(1e3 * 1.5 / 2)


SPAN_READERS = ["loop.score_share", "loop.snapshot_share", "step.idle_ms",
                "step.host_syncs", "serve.idle_ms", "serve.upload_ms"]


@pytest.mark.parametrize("name", SPAN_READERS)
def test_readers_silent_on_the_other_kind_and_without_spans(fed, name):
    serving = name.startswith("serve.")
    fed(TRAIN_SPANS + SERVE_SPANS)
    other = _run("train" if serving else "serve", TRAIN_EVENTS)
    assert _reader(name)(other) is None
    fed([])
    own = _run("serve" if serving else "train", TRAIN_EVENTS)
    assert _reader(name)(own) is None
