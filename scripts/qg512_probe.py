#!/usr/bin/env python3
"""The 512 px quality gate (`python -m yolov3_tpu_torch.quality_gate_512`)
with a probe on every train step, on the card. The gate's own `main` runs
as it is; each step also records the largest |wh logit| and |objectness
logit| of the step's feature maps, the largest |gradient|, the smallest
BatchNorm running variance and the parameters whose gradient is not
finite.

    python3 scripts/qg512_probe.py [--steps 8000] [--every 50] \
        [--plain_region 1] [--log FILE] [gate arguments]

`--plain_region 1` trains the space-to-depth region's blocks in the
plain arithmetic (the conv with its bias, `F.leaky_relu`, the Flax-form
BatchNorm) instead of `_s2d_conv_block`'s (`ConvBlock.affine_bn`). Every
step is one JSON line in `--log`; every `--every`-th is printed, and at
the end a summary line. Other arguments (`--out`, `--device`) go to the
gate; the exit code is the gate's.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--every", type=int, default=50)
    p.add_argument("--plain_region", type=int, default=0)
    p.add_argument("--log", default="chiprun_out/qg512_probe.jsonl")
    args, gate_args = p.parse_known_args(argv)

    import torch

    from yolov3_tpu_torch import quality_gate_512 as gate
    from yolov3_tpu_torch.models.yolo import BatchNorm, ConvBlock
    from yolov3_tpu_torch.parallel import train_step as T

    make_state, make_step = T.create_train_state, T.make_train_step
    fms, rows = [], []

    def create_train_state(cfg, *a, **kw):
        state = make_state(cfg, *a, **kw)
        if args.plain_region:
            for m in state.model.modules():
                if isinstance(m, ConvBlock):
                    m.affine_bn = False
        state.model.register_forward_hook(
            lambda m, inputs, out: fms.__setitem__(slice(None), out))
        return state

    def make_train_step(cfg, *a, **kw):
        step = make_step(cfg, *a, **kw)
        per_anchor = 5 + cfg.number_classes

        def probed(state, batch, lr):
            state, metrics = step(state, batch, lr)
            model = state.model
            names, grads = zip(*[(n, q.grad) for n, q in
                                 model.named_parameters()
                                 if q.grad is not None])
            maps = [f.detach().float().reshape(
                *f.shape[:3], cfg.number_anchors, per_anchor) for f in fms]
            var = torch.cat([m.running_var.reshape(-1)
                             for m in model.modules()
                             if isinstance(m, BatchNorm)])
            g = torch.stack(torch._foreach_norm(grads, float("inf")))
            head = torch.stack([
                metrics["loss"].float(),
                torch.stack([f[..., 2:4].abs().max() for f in maps]).max(),
                torch.stack([f[..., 4].abs().max() for f in maps]).max(),
                var.min()]).float()
            values = torch.cat([head, g.float()]).tolist()
            loss, wh, obj, var_min = values[:4]
            g = values[4:]
            bad = [n for n, v in zip(names, g) if not v == v or v == float(
                "inf")]
            row = {"step": len(rows), "lr": lr, "loss": loss,
                   "wh_logit": wh, "obj_logit": obj,
                   "grad": max(v for v in g if v == v), "min_running_var":
                   var_min, "nonfinite_grads": bad[:3]}
            rows.append(row)
            log.write(json.dumps(row) + "\n")
            if row["step"] % args.every == 0 or bad:
                print("probe " + json.dumps(row), flush=True)
            return state, metrics
        return probed

    T.create_train_state, T.make_train_step = create_train_state, \
        make_train_step
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    with open(args.log, "w") as log:
        try:
            rc = gate.main(["--steps", str(args.steps)] + gate_args)
        finally:
            T.create_train_state, T.make_train_step = make_state, make_step
    first_80 = next((r["step"] for r in rows if r["wh_logit"] > 80), None)
    worst = max(rows[len(rows) // 2:], key=lambda r: r["loss"],
                default=None)
    print("probe summary " + json.dumps({
        "plain_region": bool(args.plain_region), "steps": len(rows),
        "first_step_wh_logit_over_80": first_80,
        "at": {s: rows[s] for s in (100, 250, 500, 1000, 2500, 5000)
               if s < len(rows)},
        "worst_loss_in_second_half": worst}), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
