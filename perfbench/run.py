"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration file,
its traffic file (``traffic/<traffic>.json``, whose ``driver`` names a
module of ``traffic/``), its limits (``limits/<workload>.json``) and each
per-layer metric's reader (``metrics/<metric>.py``) by the names there.
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones.  Every number the correctness check
compared is printed beside its limit, last on standard error and last in
the result line.  The result line is the last line of standard output.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


class NoChip(SystemExit):
    pass


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> SimpleNamespace:
    """The workload's entry, configuration, traffic, limits and the
    metrics that apply to it."""
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])

    def applies(m, reported):
        if "workloads" in m:
            return workload in m["workloads"]
        return reported is None or m["moves"] in reported

    e2e = [m for m in bench["end_to_end"] if applies(m, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m, names)]
    return SimpleNamespace(
        workload=w, cfg=read_json(ROOT / c["file"]),
        traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(HERE / "limits" / f"{workload}.json"),
        e2e=e2e, per_layer=layer)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def device_or_exit(chips: int):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoChip(f"this cell needs {chips} CUDA device(s); "
                     f"{n} available")
    return torch.device("cuda:0")


def judge(checks: dict, limits: dict) -> bool:
    """Each number the cell's limits name at or under its limit; one the
    run did not give fails."""
    return all(k in checks and checks[k] == checks[k]
               and checks[k] <= v for k, v in limits.items())


def execute(c, args, device, t0: float) -> dict:
    """Drive the cell once; the driver's outcome plus per-layer metrics
    and the verdict."""
    from perfbench import trace as trace_mod
    classes = trace_mod.kernel_classes()
    model = load_module(HERE / "reference" / f"{c.cfg['reference']}.py",
                        f"perfbench.reference.{c.cfg['reference']}")
    ctx = SimpleNamespace(
        cfg=c.cfg, traffic=c.traffic, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=device, t0=t0, model=model,
        profiler=trace_mod.Profiler,
        summarize=lambda prof, w: prof.summary(w, classes))
    driver = load_module(HERE / "traffic" / f"{c.traffic['driver']}.py",
                         f"perfbench.traffic.{c.traffic['driver']}")
    out = driver.run(ctx)
    out["peak_flops"] = peak_flops(device)
    out["correct"] = judge(out["checks"], c.limits)
    return out


def peak_flops(device):
    import torch
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device)
    return read_json(HERE / "peaks.json").get(kind, {}).get(
        "bf16_flops_per_s")


def result_line(c, args, out, device) -> dict:
    import torch
    metrics = {}
    if args.trace:
        for m in c.per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"perfbench.metrics.{m['name']}")
            v = reader.read(out)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in c.e2e:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(c.workload["chips"]),
           "memory_peak_bytes": int(out["peak_bytes"])}
    line = {"correct": bool(out["correct"]),
            "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": dev}
    t = out.get("trace")
    if args.trace and t is not None:
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["checks"] = {k: {"value": out["checks"].get(k), "limit": v}
                      for k, v in c.limits.items()}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    set_cache_dirs()
    c = cell(read_json(ROOT / "BENCHMARK.json"), args.workload)
    try:
        device = device_or_exit(int(c.workload["chips"]))
    except NoChip as e:
        print(str(e), file=sys.stderr)
        return 2
    out = execute(c, args, device, T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = result_line(c, args, out, device)
    for k, v in out["readings"].items():
        if isinstance(v, (int, float)) or (
                isinstance(v, list) and len(v) <= 16
                and all(isinstance(x, (int, float)) for x in v)):
            print(f"reading {k}: {v!r}", file=sys.stderr)
    for k, v in out["checks"].items():
        if k not in c.limits:
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
