#!/usr/bin/env python
"""The 512 px quality gate's training, in the JAX package and in the port
side by side on the CPU, from one init: where do the two trajectories
part?

Both run the gate's own setting (scripts/quality_gate_512.py:72-122):
the 8 planted 512 px images of RandomState(42), z-scored by each
package's own `zscore_normalize` with its own label grids; the
full-depth `ModelConfig(img_size=(512, 512, 3), number_classes=1,
anchors=((96, 96), (48, 48)))` in `--dtype`; `TrainConfig(batch_size=8)`
and the gate's lr schedule. Both start from JAX's init
(`create_train_state(..., PRNGKey(0))`), carried into the port by
`params_from_jax`.

Free-running, each package takes `--steps` steps on its own state; every
step appends one JSON line to `--log` (so a cut run keeps its lines):
per package the loss and its four parts, per scale (strides 32, 16, 8)
the largest |objectness logit| and the largest wh logit of the cells
without an object, of that step's train-mode forward, and the smallest
BatchNorm running variance after it.

Teacher-forced, at each step of `--force_at` of JAX's trajectory, the
port takes one step from JAX's state there (parameters, batch statistics
and Adam moments, the moments through `adam_state_from_jax`), and one
line `{"forced": step, ...}` gives, per leaf, the distance of the port's
gradient from JAX's as a share of the leaf's largest |g| (the measure of
tests/test_torch_train_step.py::test_gradients_match_jax, bound 2e-3),
JAX's own spread under the same measure (the larger of its step with
the batch's order reversed and with the images moved by one ulp: the
same math in other summation orders and roundings), and the distance of
the port's updated parameters from JAX's as a share of the leaf's
largest JAX update. JAX's state at those steps is saved to
`--state_dir` (one .npz each) when one is given.

The JAX step is `make_train_step`'s one-device arithmetic (psum and
pmean over one replica are the values themselves), written out here so
that it also returns the feature maps and the gradients.

    JAX_PLATFORMS=cpu python scripts/g1_trajectory.py [--steps 500] \
        [--dtype bfloat16] [--force_at 0,100,200,300,400] \
        [--log g1_out/trajectory_bf16.jsonl] [--state_dir DIR]
    python scripts/g1_trajectory.py --report LOG [LOG ...]

`--jax_from STATE.npz` (a state this script saved) runs JAX alone from
that step to `--steps`, one line a step, and stops at the first
non-finite loss: how far the reference's own arithmetic on this CPU
takes the recipe.

`--forced_from STATE.npz` runs the teacher-forced comparison alone, from
that saved state.

`--sensitivity_from STATE.npz` asks how well-conditioned the step is
there: the port's train-mode forward against JAX's block by block (each
block's largest distance over its largest |activation|), and JAX's own
gradients when the images move by a relative eps of random sign (1e-6,
1e-5, 1e-4): the feature maps' shift and each leaf's gradient shift, in
the teacher-forced measure.

`--report` summarises logs instead of running: per teacher-forced step,
the leaves beyond the 2e-3 bound, the leaves whose JAX spread is beyond
it, and the quantiles of each leaf's distance over its spread; per run,
the first step where the two losses part by more than `PART_LOSS`
(relative) and the largest objectness logits by more than `PART_LOGIT`
(relative), and both packages' statistics every 50 steps.

CPU cost at 8 cores: a bf16 step of both packages takes ~20 s, an f32
one ~25 s, and the JAX compile ~1-2 min.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZE, BOX = 512, 96
ANCHORS = ((96, 96), (48, 48))
GRAD_BOUND = 2e-3
# the trajectories "part" where the losses differ by more than this share,
# or the largest |objectness logit| of a scale by more than this share
PART_LOSS, PART_LOGIT = 1e-3, 0.1


def planted(n):
    """The gate's images and boxes (scripts/quality_gate_512.py:72-84)."""
    import numpy as np
    rng = np.random.RandomState(42)
    images, gts = [], []
    for _ in range(n):
        img = (rng.rand(SIZE, SIZE, 3) * 40).astype(np.float32)
        x = rng.randint(0, SIZE - BOX)
        y = rng.randint(0, SIZE - BOX)
        img[y:y + BOX, x:x + BOX] += 180 + rng.rand() * 40
        images.append(np.clip(img, 0, 255).astype(np.uint8))
        gts.append(np.array([[x, y, BOX, BOX, 0]], np.int32))
    return images, gts


def make_batch(images, gts, zscore, encode):
    import numpy as np
    labels = [encode(g.astype(np.float32), (SIZE, SIZE, 3), ANCHORS, 1)
              for g in gts]
    return [np.stack([zscore(im.astype(np.float32)) for im in images])] + [
        np.stack([lab[i] for lab in labels]) for i in range(3)]


def fm_stats(fms, labels, n_anchors):
    """Per scale: largest |objectness logit|, largest wh logit where the
    label grid has no object."""
    import numpy as np
    obj, wh = [], []
    for fm, lab in zip(fms, labels):
        fm = np.asarray(fm, np.float32)
        fm = fm.reshape(*fm.shape[:3], n_anchors, -1)
        empty = np.asarray(lab)[..., 4] == 0
        obj.append(float(np.abs(fm[..., 4]).max()))
        wh.append(float(fm[..., 2:4][empty].max()))
    return obj, wh


def flat(tree, prefix):
    import jax
    import numpy as np
    return {"/".join([prefix] + [p.key for p in path]): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def port_flat(model, grads=False):
    """The port's parameters (or their gradients) and BatchNorm statistics
    keyed by Flax path, kernels HWIO."""
    from yolov3_tpu_torch.utils.checkpoint import flax_path
    out = {}
    items = (((n, p.grad) for n, p in model.named_parameters()) if grads
             else model.state_dict().items())
    for name, t in items:
        v = t.detach().float().numpy()
        out[flax_path(name)] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
    return out


def distances(got, want, scale_of):
    import numpy as np
    return {k: float(np.abs(got[k] - w).max() / max(
        float(np.abs(scale_of[k]).max()), 1e-30)) for k, w in want.items()}


def report(paths):
    """Print the summary of each log (see `--report`)."""
    import numpy as np
    for path in paths:
        rows = [json.loads(line) for line in open(path)]
        steps = [r for r in rows if "step" in r]
        print(f"== {path}: {len(steps)} steps, {rows[0].get('run', '')}")
        for r in rows:
            if "sensitivity_from" in r:
                worst = sorted(r["forward_blocks"].items(),
                               key=lambda kv: -kv[1])[:3]
                print(json.dumps({
                    "sensitivity_from": r["sensitivity_from"],
                    "forward_max": r["forward_max"], "forward_worst": worst,
                    "jax_shift": {eps: {k: v for k, v in d.items()
                                        if k != "grad"}
                                  for eps, d in r["jax_shift"].items()}}))
        if steps and "port" not in steps[0]:  # a --jax_from run
            over = next((r["step"] for r in steps
                         if r["jax"]["wh_logit_abs"] > 88.7), None)
            print(json.dumps({
                "first_step_wh_logit_over_88.7": over,
                "stopped": [r for r in rows if "stopped" in r]}))
            for r in steps[::25] + steps[-1:]:
                print(json.dumps({"step": r["step"], "loss": r["jax"]["loss"],
                                  "obj_logit": r["jax"]["obj_logit"],
                                  "wh_logit_abs": r["jax"]["wh_logit_abs"]}))
            continue
        for r in rows:
            if "forced" not in r:
                continue
            g, sp = r["grad"], r["spread"]
            over = [k for k in g if g[k] > GRAD_BOUND]
            ratio = sorted(((g[k] / max(sp[k], 1e-12), k) for k in over),
                           reverse=True)
            q = (np.percentile([x[0] for x in ratio], [50, 90, 99, 100])
                 if ratio else [])
            print(json.dumps({
                "forced": r["forced"], "leaves": len(g),
                "over_bound": len(over),
                "spread_over_bound": sum(v > GRAD_BOUND for v in sp.values()),
                "grad_max": r["grad_max"], "spread_max": r["spread_max"],
                "ratio_q50_q90_q99_max": [round(float(v), 3) for v in q],
                "largest_ratios": [[round(v, 2), k] for v, k in ratio[:3]]}))
        if not steps:
            continue
        part_loss = next((r["step"] for r in steps if abs(
            r["port"]["loss"] - r["jax"]["loss"]) > PART_LOSS * abs(
                r["jax"]["loss"])), None)
        part_logit = next((r["step"] for r in steps if max(
            abs(a - b) / max(abs(b), 1e-6) for a, b in zip(
                r["port"]["obj_logit"], r["jax"]["obj_logit"]))
            > PART_LOGIT), None)
        print(json.dumps({"part_loss_step": part_loss,
                          "part_obj_logit_step": part_logit}))
        for r in steps[::50] + steps[-1:]:
            print(json.dumps({"step": r["step"], **{
                pkg: {"loss": round(r[pkg]["loss"], 3),
                      "obj_logit": [round(v, 2) for v in r[pkg]["obj_logit"]],
                      "wh_logit_empty": [round(v, 2) for v in
                                         r[pkg]["wh_logit_empty"]],
                      "min_running_var": round(r[pkg]["min_running_var"], 5)}
                for pkg in ("jax", "port")}}))


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["--report"]:
        report(argv[1:])
        return 0
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--force_at", default="0,100,200,300,400")
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=300)
    p.add_argument("--decay_start", type=int, default=2500)
    p.add_argument("--decay_end", type=int, default=6000)
    p.add_argument("--log", default=None)
    p.add_argument("--state_dir", default="")
    p.add_argument("--jax_from", default="")
    p.add_argument("--forced_from", default="")
    p.add_argument("--sensitivity_from", default="")
    args = p.parse_args(argv)
    force_at = {int(s) for s in args.force_at.split(",") if s}
    log_path = args.log or os.path.join(
        "g1_out", f"trajectory_{args.dtype}.jsonl")

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from yolov3_tpu.config import ModelConfig as JConfig
    from yolov3_tpu.config import TrainConfig as JTrainConfig
    from yolov3_tpu.data.encoder import encode_boxes as j_encode
    from yolov3_tpu.data.imaging import zscore_normalize as j_zscore
    from yolov3_tpu.models.yolo import YoloV3 as JYoloV3
    from yolov3_tpu.ops.loss import compute_loss as j_compute_loss
    from yolov3_tpu.parallel.train_step import (
        create_train_state as j_create_train_state, make_optimizer)
    from yolov3_tpu_torch.config import ModelConfig, TrainConfig
    from yolov3_tpu_torch.data.encoder import encode_boxes
    from yolov3_tpu_torch.data.imaging import zscore_normalize
    from yolov3_tpu_torch.models.yolo import BatchNorm
    from yolov3_tpu_torch.parallel import train_step as T
    from yolov3_tpu_torch.quality_gate_512 import lr_schedule
    from yolov3_tpu_torch.utils.checkpoint import (adam_state_from_jax,
                                                   set_adam_state)

    n = args.images
    kw = dict(img_size=(SIZE, SIZE, 3), number_classes=1, anchors=ANCHORS,
              compute_dtype=args.dtype)
    jcfg, cfg = JConfig(**kw), ModelConfig(**kw)
    jtcfg, tcfg = JTrainConfig(batch_size=n), TrainConfig(batch_size=n)
    lr_at = lr_schedule(args.lr, args.warmup, args.decay_start,
                        args.decay_end)
    images, gts = planted(n)
    jbatch = [jnp.asarray(a, jnp.float32)
              for a in make_batch(images, gts, j_zscore, j_encode)]
    # JAX's own spread: the batch reversed (another order of the batch
    # sums), and the images moved by one ulp (another rounding of every
    # activation, as another conv summation order gives)
    signs = np.random.RandomState(0).choice([-1.0, 1.0], jbatch[0].shape)
    jspreads = {"reversed": [a[::-1] for a in jbatch],
                "ulp": [jbatch[0] * jnp.asarray(1.0 + signs * 2.0 ** -23,
                                                jnp.float32)] + jbatch[1:]}
    pbatch = [torch.from_numpy(np.asarray(a, np.float32))
              for a in make_batch(images, gts, zscore_normalize,
                                  encode_boxes)]
    labels_np = [np.asarray(a) for a in jbatch[1:]]

    jmodel = JYoloV3(jcfg)
    jstate = j_create_train_state(jmodel, jtcfg, jax.random.PRNGKey(0),
                                  (1, SIZE, SIZE, 3))
    optimizer = make_optimizer(jtcfg)

    def loss_fn(params, stats, images, labels):
        fms, mutated = jmodel.apply({"params": params, "batch_stats": stats},
                                    images, train=True,
                                    mutable=["batch_stats"])
        yl = j_compute_loss(fms, labels, jcfg.anchors, jcfg.number_classes,
                            jcfg.strides)
        return yl.total / float(n), (yl, mutated["batch_stats"], fms)

    @jax.jit
    def jstep(params, stats, opt_state, batch, lr):
        (loss, (yl, new_stats, fms)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, stats, batch[0], tuple(batch[1:]))
        updates, new_opt = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(
            params, jax.tree_util.tree_map(lambda u: -lr * u, updates))
        metrics = {"loss": loss, "loss_xy": yl.xy, "loss_wh": yl.wh,
                   "loss_obj": yl.objectness, "loss_class": yl.class_}
        return new_params, new_stats, new_opt, metrics, fms, grads

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    params, stats, opt_state = (jstate.params, jstate.batch_stats,
                                jstate.opt_state)
    if args.jax_from:
        return jax_alone(args, log_path, jstep, load_state(args.jax_from),
                         jbatch, labels_np, lr_at, cfg.number_anchors)
    if args.sensitivity_from:
        return sensitivity(args, log_path, jmodel, jcfg, jbatch, cfg,
                           tcfg, T)
    if args.forced_from:
        p0, s0, opt0 = load_state(args.forced_from)
        i = int(opt0.count)
        out = jstep(p0, s0, opt0, jbatch, jnp.float32(lr_at(i)))
        row = teacher_forced(i, lr_at(i), p0, s0, opt0, out[0], out[5],
                             jstep, jspreads, cfg, tcfg, pbatch, host, "",
                             adam_state_from_jax, set_adam_state, T)
        os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                    exist_ok=True)
        with open(log_path, "a") as log:
            log.write(json.dumps(dict(row, forced_from=args.forced_from))
                      + "\n")
        return 0
    init_params, init_stats = host(params), host(stats)
    pstate = T.create_train_state(cfg, tcfg, device="cpu",
                                  params=init_params, batch_stats=init_stats)
    pstep = T.make_train_step(cfg, tcfg, n)
    captured = []
    pstate.model.register_forward_hook(
        lambda m, i, out: captured.__setitem__(slice(None), out))

    def port_row(model, metrics):
        obj, wh = fm_stats([f.detach().float().numpy() for f in captured],
                           labels_np, cfg.number_anchors)
        var = min(float(m.running_var.min()) for m in model.modules()
                  if isinstance(m, BatchNorm))
        return dict({k: float(v) for k, v in metrics.items()
                     if k != "loss_sum"}, obj_logit=obj, wh_logit_empty=wh,
                    min_running_var=var)

    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    if args.state_dir:
        os.makedirs(args.state_dir, exist_ok=True)
    log = open(log_path, "a")

    def emit(row):
        log.write(json.dumps(row) + "\n")
        log.flush()

    emit({"run": {"dtype": args.dtype, "steps": args.steps,
                  "force_at": sorted(force_at), "images": n,
                  "threads": torch.get_num_threads()}})
    t_start = time.perf_counter()
    for i in range(args.steps):
        lr = lr_at(i)
        t0 = time.perf_counter()
        out = jstep(params, stats, opt_state, jbatch, jnp.float32(lr))
        new_params, new_stats, new_opt, jm, jfms, jgrads = out
        jm = {k: float(v) for k, v in jm.items()}
        obj, wh = fm_stats(jfms, labels_np, cfg.number_anchors)
        jvar = min(float(v.min()) for k, v in flat(new_stats, "s").items()
                   if k.endswith("/var"))
        t_jax = time.perf_counter() - t0

        if i in force_at:
            emit(teacher_forced(
                i, lr, params, stats, opt_state, new_params, jgrads,
                jstep, jspreads, cfg, tcfg, pbatch, host, args.state_dir,
                adam_state_from_jax, set_adam_state, T))

        t0 = time.perf_counter()
        pstate, pm = pstep(pstate, pbatch, lr)
        prow = port_row(pstate.model, pm)
        t_port = time.perf_counter() - t0
        emit({"step": i, "lr": lr,
              "jax": dict(jm, obj_logit=obj, wh_logit_empty=wh,
                          min_running_var=jvar),
              "port": prow, "s": [round(t_jax, 2), round(t_port, 2)]})
        params, stats, opt_state = new_params, new_stats, new_opt
        if not (np.isfinite(jm["loss"]) and np.isfinite(prow["loss"])):
            emit({"stopped": i, "reason": "non-finite loss"})
            break
    emit({"done": True, "s": round(time.perf_counter() - t_start, 1)})
    log.close()
    return 0


def load_state(path):
    """(params, batch_stats, ScaleByAdamState) from a saved .npz."""
    import jax.numpy as jnp
    import numpy as np
    import optax
    trees = {"params": {}, "batch_stats": {}, "mu": {}, "nu": {}}
    with np.load(path) as z:
        count = int(z["count"])
        for key in z.files:
            if key == "count":
                continue
            top, *parts = key.split("/")
            node = trees[top]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
    return (trees["params"], trees["batch_stats"], optax.ScaleByAdamState(
        count=jnp.asarray(count, jnp.int32), mu=trees["mu"],
        nu=trees["nu"]))


def jax_alone(args, log_path, jstep, state, jbatch, labels_np, lr_at,
              n_anchors):
    """JAX's steps from a saved state, one JSON line each, to a
    non-finite loss or `args.steps`."""
    import jax.numpy as jnp
    import numpy as np
    params, stats, opt_state = state
    start = int(opt_state.count)
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    with open(log_path, "a") as log:
        log.write(json.dumps({"run": {"dtype": args.dtype, "jax_from":
                                      args.jax_from, "start": start,
                                      "steps": args.steps}}) + "\n")
        for i in range(start, args.steps):
            t0 = time.perf_counter()
            params, stats, opt_state, jm, jfms, _ = jstep(
                params, stats, opt_state, jbatch, jnp.float32(lr_at(i)))
            jm = {k: float(v) for k, v in jm.items()}
            obj, wh = fm_stats(jfms, labels_np, n_anchors)
            wh_all = max(float(np.abs(np.asarray(f, np.float32).reshape(
                *f.shape[:3], n_anchors, -1)[..., 2:4]).max()) for f in jfms)
            log.write(json.dumps({"step": i, "lr": lr_at(i), "jax": dict(
                jm, obj_logit=obj, wh_logit_empty=wh, wh_logit_abs=wh_all),
                "s": round(time.perf_counter() - t0, 2)}) + "\n")
            log.flush()
            if not np.isfinite(jm["loss"]):
                log.write(json.dumps({"stopped": i, "reason":
                                      "non-finite loss"}) + "\n")
                break
    return 0


def sensitivity(args, log_path, jmodel, jcfg, jbatch, cfg, tcfg, T):
    """See `--sensitivity_from`; one JSON line."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from yolov3_tpu.ops.loss import compute_loss as j_compute_loss
    from yolov3_tpu_torch.utils.checkpoint import flax_module_path
    params, stats, _ = load_state(args.sensitivity_from)
    n = jbatch[0].shape[0]
    forward = jax.jit(lambda x: jmodel.apply(
        {"params": params, "batch_stats": stats}, x, train=True,
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=True)[1]["intermediates"])
    jblocks = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if k == "__call__":
                out = v[0]
                jblocks[prefix] = np.asarray(
                    out[-1] if isinstance(out, (tuple, list)) else out)
            elif isinstance(v, dict):
                walk(v, f"{prefix}/{k}" if prefix else k)
    walk(jax.device_get(forward(jbatch[0])), "")
    state = T.create_train_state(cfg, tcfg, device="cpu", params=params,
                                 batch_stats=stats)
    outs = {}
    for name, m in state.model.named_modules():
        if name.split(".")[-1] in ("conv", "bn") or not name:
            continue
        try:
            path = flax_module_path(name)
        except (KeyError, StopIteration):
            continue
        m.register_forward_hook(lambda mod, i, o, path=path: outs.__setitem__(
            path, o[-1] if isinstance(o, (tuple, list)) else o))
    with torch.no_grad():
        state.model(torch.from_numpy(np.asarray(jbatch[0], np.float32)))
    blocks = {k: float(np.abs(v.float().numpy() - jblocks[k]).max()
                       / np.abs(jblocks[k]).max())
              for k, v in outs.items() if k in jblocks
              and tuple(v.shape) == jblocks[k].shape}

    def loss_fn(p, x):
        fms, _ = jmodel.apply({"params": p, "batch_stats": stats}, x,
                              train=True, mutable=["batch_stats"])
        return j_compute_loss(fms, tuple(jbatch[1:]), jcfg.anchors,
                              jcfg.number_classes, jcfg.strides
                              ).total / float(n), fms
    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, fms0), g0 = grad(params, jbatch[0])
    g0 = flat(jax.device_get(g0), "params")
    signs = np.random.RandomState(1).choice([-1.0, 1.0], jbatch[0].shape)
    shifts = {}
    for eps in (1e-6, 1e-5, 1e-4):
        x = jbatch[0] * jnp.asarray(1.0 + eps * signs, jnp.float32)
        (_, fms1), g1 = grad(params, x)
        g1 = flat(jax.device_get(g1), "params")
        d = distances(g1, g0, g0)
        shifts[str(eps)] = {
            "feature_map_shift": max(
                float(np.abs(np.asarray(a) - np.asarray(b)).max()
                      / np.abs(np.asarray(b)).max())
                for a, b in zip(fms1, fms0)),
            "leaves_over_bound": sum(v > GRAD_BOUND for v in d.values()),
            "grad_shift_max": max(d.values()), "grad": d}
    with open(log_path, "a") as log:
        log.write(json.dumps({"sensitivity_from": args.sensitivity_from,
                              "forward_blocks": blocks,
                              "forward_max": max(blocks.values()),
                              "jax_shift": shifts}) + "\n")
    return 0


def teacher_forced(i, lr, params, stats, opt_state, new_params, jgrads,
                   jstep, jspreads, cfg, tcfg, pbatch, host, state_dir,
                   adam_state_from_jax, set_adam_state, T):
    """One port step from JAX's state before step i, against JAX's step;
    JAX's own spread is its step on each batch of `jspreads` ({name: the
    same batch in another order, or perturbed by an ulp}), the largest
    per leaf."""
    import jax.numpy as jnp
    import numpy as np
    p0, s0 = host(params), host(stats)
    mu, nu, count = host(opt_state.mu), host(opt_state.nu), int(
        opt_state.count)
    if state_dir:
        np.savez(os.path.join(state_dir, f"jax_state_{i:05d}.npz"),
                 count=count, **flat(p0, "params"),
                 **flat(s0, "batch_stats"), **flat(mu, "mu"),
                 **flat(nu, "nu"))
    want_g = flat(host(jgrads), "params")
    spreads = {name: distances(flat(host(jstep(
        params, stats, opt_state, b, jnp.float32(lr))[5]), "params"),
        want_g, want_g) for name, b in jspreads.items()}
    state = T.create_train_state(cfg, tcfg, device="cpu", params=p0,
                                 batch_stats=s0)
    set_adam_state(state.optimizer, state.model,
                   adam_state_from_jax(mu, nu, count, cfg))
    state.step = count
    state, _ = T.make_train_step(cfg, tcfg, len(pbatch[0]))(state, pbatch,
                                                            lr)
    got_g = port_flat(state.model, grads=True)
    grad = distances(got_g, want_g, want_g)
    spread = {k: max(d[k] for d in spreads.values()) for k in grad}
    want_p = flat(host(new_params), "params")
    old_p = flat(p0, "params")
    got_p = {k: v for k, v in port_flat(state.model).items()
             if k.startswith("params/")}
    moved = {k: want_p[k] - old_p[k] for k in want_p}
    param = distances(got_p, want_p, moved)
    over = sorted((k for k in grad if grad[k] > GRAD_BOUND),
                  key=lambda k: -grad[k])
    over_spread = [k for k in over if grad[k] > spread[k]]
    worst = sorted(grad, key=lambda k: -grad[k])[:8]
    return {"forced": i, "lr": lr, "bound": GRAD_BOUND,
            "grad_max": max(grad.values()),
            "grad_worst": {k: [grad[k], spread[k]] for k in worst},
            "n_leaves": len(grad), "n_over_bound": len(over),
            "n_over_bound_and_spread": len(over_spread),
            "over_bound_and_spread": {k: [grad[k], spread[k]]
                                      for k in over_spread[:20]},
            "spread_max": max(spread.values()),
            "param_max": max(param.values()),
            "param_worst": {k: param[k] for k in sorted(
                param, key=lambda k: -param[k])[:5]},
            "grad": grad, "spread": spread, "spreads": spreads}


if __name__ == "__main__":
    raise SystemExit(main())
