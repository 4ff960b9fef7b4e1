"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared, with its limit. See README.md.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "d3d_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's, optax's or
    the JAX package's (compared whole: ``d3d_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the output check's own runs (perfbench/tests), never the driver's
    p.add_argument("--control", default=None,
                   choices=("tf32", "half_batch", "no_exchange"),
                   help="the reference in the program's place: in TF32, or "
                   "(training) with a fault planted")
    p.add_argument("--fault", default=None,
                   help="plant a fault in the timed path (tests: 'jax' "
                   "plants a JAX module in the last rank's sys.modules)")
    p.add_argument("--check-seeds", type=int, default=None,
                   help="(training) the output check alone, no window, on "
                   "this many seeds from --seed in one process a rank (ranks "
                   "share cards over gloo where there are fewer): the "
                   "limits' readings")
    # one rank of a run on several cards, started by the run's launcher
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--overrides", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def load_cell(name, root=ROOT, overrides=None):
    """The cell ``name`` of ``BENCHMARK.json``: its entry, configuration
    (the file the configs list names), traffic mix
    (``perfbench/traffic/<traffic>.json``), family module and metrics."""
    import importlib

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    entry = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = json.loads((root / confs[entry["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    for key, val in (overrides or {}).items():
        (conf if key in conf else traffic)[key] = val
    reported = [m for m in bench["end_to_end"]
                if name in m.get("workloads", [name])]
    names = {m["name"] for m in reported}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in names
                                  else [])]
    return dict(name=name, entry=entry, conf=conf, traffic=traffic,
                family=importlib.import_module(
                    f"perfbench.families.{conf['family']}"),
                driver=importlib.import_module(
                    f"perfbench.core.{traffic['kind']}"),
                end_to_end=reported, per_layer=per_layer)


def read_metric(name, ctx):
    """The per-layer metric ``name`` from its reader,
    ``perfbench/metrics/<name>.py`` (``read(ctx)``: a number, or None
    where it finds nothing to read)."""
    import importlib.util

    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def log(msg):
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def run_cell(args, dev, cell, t_epoch):
    """Drive the cell and assemble the result line (a dict), or None on a
    rank other than 0."""
    import torch

    from perfbench.core import peaks

    if args.rank is None:
        log(f"imports: {time.perf_counter() - T_PROCESS:.1f} s")
    extra = dict(check_seeds=args.check_seeds) if args.check_seeds else {}
    res = cell["driver"].run(
        cell, args.seed, args.seconds, bool(args.trace), dev, log,
        control=args.control, fault=args.fault, rank=args.rank,
        store=args.store, **extra)
    if res is None:
        return None
    out, compared = res
    out.setdefault("setup_s", out["window_epoch"] - t_epoch)
    chips = cell["entry"]["chips"]
    device = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                  kind=(torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
                  count=chips, memory_peak_bytes=int(out["memory_peak_bytes"]))
    result = dict(correct=all(v <= lim for v, lim in compared.values())
                  and out.get("correct", True),
                  attempted=out["attempted"], failed=out["failed"])
    metrics = {}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        ctx = dict(out, cell=cell, peaks=peaks, chips=chips, device=dev)
        for m in cell["per_layer"]:
            val = read_metric(m["name"], ctx)
            if val is not None:
                metrics[m["name"]] = dict(value=val, unit=m["unit"])
        result["breakdown"] = out["breakdown"]
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = dict(value=out[m["name"]], unit=m["unit"])
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = {k: dict(value=v, limit=lim)
                        for k, (v, lim) in compared.items()}
    return result


def main(argv=None, device=None, overrides=None):
    """Run one cell; ``device`` (tests only) skips the look for cards.
    Returns the exit code."""
    t_epoch = time.time() - (time.perf_counter() - T_PROCESS)
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    device = device or args.device
    if args.overrides:
        overrides = json.loads(Path(args.overrides).read_text())
    cell = load_cell(args.workload, overrides=overrides)
    import torch

    if device is None:
        # the output check's own readings may run on fewer cards: the
        # control in one process, --check-seeds with ranks sharing cards
        chips = (1 if args.control or args.check_seeds
                 else cell["entry"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"needs {chips} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        from perfbench.core import peaks

        if args.rank is None:
            log(f"card: {peaks.card()}")
        device = torch.device("cuda",
                              (args.rank or 0) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    device = torch.device(device)
    cell["argv"], cell["overrides"] = _child_argv(args, device), overrides
    chips = cell["entry"]["chips"]
    if args.fault == "jax" and args.rank == (chips - 1 if chips > 1 else None):
        import types

        sys.modules["jax"] = types.ModuleType("jax")
    result = run_cell(args, device, cell, t_epoch)
    # every process checks its own modules once its window has closed: a
    # rank that finds one exits 3, and its launcher then prints no result
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}"
            + ("" if args.rank is None else f" (rank {args.rank})"))
        return 3
    if result is None:
        return 0
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


def _child_argv(args, device):
    """The arguments a rank of this run is started with (its launcher adds
    ``--rank``, ``--store`` and ``--overrides``)."""
    argv = ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace)]
    if args.fault:
        argv += ["--fault", args.fault]
    if args.check_seeds:
        argv += ["--check-seeds", str(args.check_seeds)]
    if device.type != "cuda":
        argv += ["--device", device.type]
    return argv


if __name__ == "__main__":
    sys.exit(main())
