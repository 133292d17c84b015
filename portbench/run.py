"""The benchmark of `yolov3_tpu_torch` on NVIDIA GPUs.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell (an entry of `workloads` in
`BENCHMARK.json`) names a configuration (`portbench/configs/<name>.json`)
and a traffic mix (`portbench/traffic/<name>.json`), whose `loop` names
the general generator that drives it (`portbench/loops/<loop>.py`);
`portbench/workloads/<cell>.json` holds the limits its comparison with
the plain reference is held to. Each per-layer metric is read by
`portbench/metrics/<metric>.py` (`read(run) -> number or None`). So a
new configuration, mix, cell or metric is new files and new entries in
`BENCHMARK.json`, and no file here changes.

One run: set-up (weights and inputs from the seed, the program built and
warmed up on every shape the cell uses), the window of `--seconds`, with
`--trace 1` a profiled slice after it, then the comparison with the
reference. The last line of standard output is the result's JSON; the
numbers compared, each beside its limit, are the last lines of standard
error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(1, ROOT)
# packages whose presence in the process means the JAX package ran
FORBIDDEN = ("jax", "jaxlib", "flax", "yolov3_tpu")


class Refused(Exception):
    """The run cannot measure: no result line, a non-zero exit."""


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entries: its workload, configuration, traffic, limits and
    metrics, all found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[cell["config"]]

    def applies(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reports = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in reports]
    return {"cell": cell, "config": load_json(ROOT, conf["file"]),
            "traffic": load_json(HERE, "traffic", cell["traffic"] + ".json"),
            **load_json(HERE, "workloads", workload + ".json"),
            "end_to_end": e2e, "per_layer": layer}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def read_metric(name: str, run) -> float | None:
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def measure(spec: dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = T_START, **loop_kw
            ) -> dict:
    """One run of the cell `spec` (`cell_spec`) on `device`: the result's
    JSON object, its last key `checks`. `loop_kw` reach the loop (the
    harness's own tests plant faults through them)."""
    import torch
    loop = importlib.import_module("loops." + spec["traffic"]["loop"])
    run = loop.run(dict(spec, seed=seed, seconds=seconds, trace=trace,
                        device=device, t_start=t_start), **loop_kw)
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            v = read_metric(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.end_to_end[m["name"]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    on_card = torch.device(device).type == "cuda"
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu",
                   "count": int(spec["cell"]["chips"]),
                   "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device_info}
    if trace and run.trace is not None and run.trace_window is not None:
        window = run.trace_window
        device_info["busy_s"] = run.trace.busy_s(window)
        device_info["window_s"] = window[1] - window[0]
        out["breakdown"] = {"device_ops": run.trace.top_ops(window),
                            "idle_gaps": run.trace.idle_gaps(window)}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in run.checks}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = cell_spec(load_json(ROOT, "BENCHMARK.json"), args.workload)
    # every build and kernel cache at a fixed path inside the checkout (the
    # program's own CUDA libraries build into build/yolov3_tpu_torch)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    import torch
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA device(s); "
                      f"{torch.cuda.device_count()} available")
    out = measure(spec, args.seed, args.seconds, bool(args.trace))
    gc.collect()
    # last, once every metric has been read: nothing the run loaded, the
    # readers included, may belong to the JAX package
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of the JAX package are loaded: {found}")
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Refused as exc:
        print(f"refused: {exc}", file=sys.stderr)
        sys.exit(2)
