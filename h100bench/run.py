"""The benchmark of ``srgan_tpu_torch`` on NVIDIA H100 cards.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (``h100bench/configs/<name>.json``)
and a traffic mix (``h100bench/traffic/<name>.json``); the mix's ``kind``
picks the code that runs it (``h100bench/kinds/<kind>.py``), the cell's limits are
``h100bench/limits/<cell>.json``, and each per-layer metric is read by
``h100bench/metrics/<metric>.py``. With ``--trace 0`` the last line of
standard output holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profiler trace of the window. The numbers
that decide ``correct`` are printed, each beside its limit, as the last
lines of standard error and under ``checks`` at the end of the result.

A cell on several cards runs one process a card (``ranks.py``): the
command starts them, rank 0 prints the result, and every rank is checked.

Exits non-zero without a result where no CUDA card is visible (or fewer
than the cell asks for), where the process (any rank) holds JAX or the
JAX package once the window has closed, and where a rank fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if "H100BENCH_T0" in os.environ:  # a rank (ranks.py): from its launcher's start
    T_START = float(os.environ["H100BENCH_T0"])
HERE = ROOT / "h100bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "srgan_tpu")
LAUNCH_TIMEOUT_S = 1180.0  # a checkout's first run builds and compiles


def _cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_cell(name: str) -> types.SimpleNamespace:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return types.SimpleNamespace(bench=bench, cell=cell, config=config, traffic=traffic,
                                 limits=limits, e2e=e2e, per_layer=per_layer)


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Tracer:
    """torch.profiler over the window, and the harness's host regions."""

    def __init__(self):
        import torch

        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])

    def start(self):
        self.prof.start()

    def stop(self):
        self.prof.stop()

    def events(self):
        """(device ops, host regions), each (name, start s, end s), on the
        profiler's clock."""
        from torch.autograd import DeviceType

        dev, regions = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            t0, t1 = e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9
            if name.startswith("h100bench."):
                if e.device_type() == DeviceType.CPU:
                    regions.append((name[len("h100bench."):], t0, t1))
            elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
                dev.append((name, t0, t1))
        return dev, regions


def region(tracer):
    """A host region the trace names, where tracing is on."""
    if tracer is None:
        return lambda name: contextlib.nullcontext()
    import torch

    return lambda name: torch.profiler.record_function(f"h100bench.{name}")


def traced(run: dict, tracer: Tracer) -> tuple:
    """Fill the run's device view from the trace; returns (device fields,
    breakdown)."""
    from h100bench import groups

    dev, regions = tracer.events()
    win = [r for r in regions if r[0] == "window"]
    t0, t1 = (win[0][1], win[0][2]) if win else (min(e[1] for e in dev), max(e[2] for e in dev))
    dev = [e for e in dev if e[2] > t0 and e[1] < t1]
    busy = groups.busy_seconds(dev, t0, t1)
    run.update(events=dev, busy_s=busy, traced_s=t1 - t0)
    top = sorted(groups.seconds_by_name(dev).items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(groups.idle_gaps(dev, t0, t1), key=lambda g: g[0] - g[1])[:10]
    host = [r for r in regions if r[0] != "window"]
    breakdown = {
        "device_ops": [[f"{groups.group_of(n)}: {n[:120]}", s] for n, s in top],
        "idle_gaps": [[groups.label_at(host, a, run["idle_label"]), b - a] for a, b in gaps],
    }
    return {"busy_s": busy, "window_s": t1 - t0}, breakdown


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args, device=None, faults=(), overrides=None) -> dict:
    """One run of a cell; returns the result line's object (and, for the
    caller, the compared numbers). ``device``: the card unless given (the
    CPU tests pass the CPU, which skips the look for a card);
    ``faults``: hooks that break the program under test; ``overrides``:
    changes to the configuration and traffic (the CPU tests' small sizes)."""
    spec = load_cell(args.workload)
    for key, val in (overrides or {}).items():
        _merge(getattr(spec, key), val)
    import torch

    chips = spec.cell["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"h100bench: the cell needs {chips} CUDA card(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"torch.cuda.device_count() is {torch.cuda.device_count()}", file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda")
    group = None
    if chips > 1:
        from h100bench.ranks import Group

        group = Group(device)
        device = group.device
    tracer_box = []

    def new_tracer():
        if not args.trace:
            return None
        tracer_box.append(Tracer())
        return tracer_box[-1]

    def region_cm(name):
        return region(tracer_box[-1] if tracer_box else None)(name)

    ctx = types.SimpleNamespace(config=spec.config, traffic=spec.traffic, seed=args.seed,
                                seconds=args.seconds, device=device, faults=list(faults),
                                new_tracer=new_tracer, region=region_cm, group=group)
    kind = importlib.import_module(f"h100bench.kinds.{spec.traffic['kind']}")
    res = kind.run(ctx)
    from h100bench import compare

    correct, checks = compare.judge(res["checks"], spec.limits)
    correct = correct and res["failed"] == 0
    run = res["run"]
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    if device.type == "cuda":
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": chips, "memory_peak_bytes": int(res["peak_bytes"])}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if args.trace:
        fields, breakdown = traced(run, res["tracer"])
        if group is not None:  # busy and window: the mean over the ranks
            each = group.gather(torch.tensor([fields["busy_s"], fields["window_s"]],
                                             dtype=torch.float64))
            fields = dict(zip(("busy_s", "window_s"),
                              (float(v) for v in torch.stack(each).mean(0))))
        dev_info.update(fields)
        metrics = {}
        for m in spec.per_layer:
            val = reader(m["name"])(types.SimpleNamespace(**run))
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        out.update(metrics=metrics, device=dev_info, breakdown=breakdown)
    else:
        vals = {**res["e2e"], "setup_s": res["t_window"] - T_START}
        out.update(metrics={m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                            for m in spec.e2e},
                   device=dev_info)
    out["checks"] = checks
    if group is not None:
        group.close()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    from h100bench import ranks

    chips = load_cell(args.workload).cell["chips"]
    if chips > 1 and not ranks.is_rank():
        return ranks.launch([str(Path(__file__).resolve()), *argv], chips, T_START,
                            LAUNCH_TIMEOUT_S)
    _cache_env()
    out = execute(args)
    found = forbidden_modules()
    if found:
        print(f"h100bench: the process holds {', '.join(found)} after the window",
              file=sys.stderr)
        return 3
    if ranks.rank() != 0:
        return 0
    from h100bench import compare

    if ranks.is_rank():
        compare.NOTES.append(f"host memory: rank 0's peak {ranks.host_peak_gib():.2f} GiB")
    for note in compare.NOTES:
        print(f"note {note}", file=sys.stderr)
    for name, (val, lim) in out["checks"].items():
        print(f"check {name}: {val!r} (limit {lim!r})", file=sys.stderr)
    print(f"check correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
