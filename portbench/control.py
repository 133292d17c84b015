"""Readings that set a cell's limits, on the chip at the cell's own size:
the program's numbers on many seeds, and the control's, in one process.

    python3 portbench/control.py --workload CELL --seeds 1,2,3 \\
        --seconds S [--program 1] [--control 1]

The control is the step below the configuration's precision: for int8
serving the reference itself at 4 bits in the program's place, compared
with the 8-bit reference; for bf16 serving the program's own int8 path
(`make_quantized_serving_fn`); for bf16 training the program's own int8
training (`ModelConfig.int8_train`, quantization-aware). Prints one JSON
line per run: the cell, the seed, which side, every number compared.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from run import ROOT, cell_spec, load_json


def int4_control(spec: dict, seed: int, device: str) -> dict:
    """The 4-bit reference in the program's place, against the 8-bit one,
    on every pool image: its candidates, and its own greedy NMS as the
    keep mask."""
    from loops import serve_closed as S
    from loops.common import model_dict
    config, traffic = spec["config"], spec["traffic"]
    icfg = config["inference"]
    model = model_dict(config)
    pool = S.make_pool(model, traffic["pool"], seed, device)
    _, shift = S.shifted_weights(model, seed, device, traffic["score_share"],
                                 icfg, pool[:traffic["probe_images"]]
                                 .to(device))
    ref = S.reference_pool(config, traffic, seed, device, pool, shift, 8)
    ctl = S.reference_pool(config, traffic, seed, device, pool, shift, 4)
    outs = S.candidate_outputs(ctl, icfg)
    return S.compare(outs, ref, 1, traffic["pool"], icfg,
                     spec["score_margin"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--fault", default="",
                   help="'half': the training step on half of each batch")
    args = p.parse_args(argv)
    import importlib
    spec = cell_spec(load_json(ROOT, "BENCHMARK.json"), args.workload)
    loop = importlib.import_module("loops." + spec["traffic"]["loop"])
    # every number, whatever the cell's limits hold
    spec["limits"] = {k: float("inf") for k in spec["limits"]}
    for seed in (int(s) for s in args.seeds.split(",")):
        sides = (["program"] if args.program else []) + (
            ["control"] if args.control else []) + (
            [args.fault] if args.fault else [])
        for side in sides:
            t = time.perf_counter()
            ctx = dict(spec, seed=seed, seconds=args.seconds, trace=False,
                       device="cuda", t_start=t)
            if side == "control" and spec["config"]["precision"] == "int8":
                numbers = int4_control(spec, seed, "cuda")
                extra = {}
            else:
                kw = {}
                if side == "half":
                    kw = {"fault": loop.half_batch}
                elif side == "control":
                    kw = ({"int8_train": True}
                          if spec["traffic"]["loop"] == "train_feed"
                          else {"precision": "int8"})
                run = loop.run(ctx, **kw)
                numbers = run.info["numbers"]
                extra = {k: run.info[k] for k in ("losses", "ref_losses",
                                                  "grad_at", "change_at",
                                                  "candidates_per_image",
                                                  "shift")
                         if k in run.info}
                extra["end_to_end"] = run.end_to_end
                del run
            gc.collect()
            torch.cuda.empty_cache()
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "side": side, "numbers": numbers,
                              "seconds": time.perf_counter() - t, **extra}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
