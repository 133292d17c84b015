"""The rank functions of tests/test_torch_parallel.py. They run in fresh
processes started by `yolov3_tpu_torch.parallel.distributed.spawn`, so
this module imports torch and the port only (no JAX: a spawned rank
imports the module its function lives in)."""

import numpy as np
import torch

from yolov3_tpu_torch.config import ModelConfig, TrainConfig
from yolov3_tpu_torch.parallel import distributed as D
from yolov3_tpu_torch.parallel import train_step as T
from yolov3_tpu_torch.utils import checkpoint as ckpt


def flat_grads(model):
    """Parameter gradients keyed by Flax path, kernels HWIO."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.detach().numpy()
        out[ckpt.flax_path(name)] = (g.transpose(2, 3, 1, 0) if g.ndim == 4
                                     else g)
    return out


def flat_state(model):
    """Parameters and BatchNorm statistics keyed by Flax path."""
    params, stats = ckpt.params_to_jax(model.state_dict())
    out = {}
    ckpt._flatten(params, "params", out)
    ckpt._flatten(stats, "batch_stats", out)
    return out


def moments(optimizer, model):
    """{Flax path: (exp_avg, exp_avg_sq)} of the Adam state this rank
    holds (a ZeRO-1 rank: its share)."""
    opt = getattr(optimizer, "optim", optimizer)
    out = {}
    for name, p in model.named_parameters():
        if p in opt.state:
            st = opt.state[p]
            out[ckpt.flax_path(name)] = (st["exp_avg"].numpy().copy(),
                                         st["exp_avg_sq"].numpy().copy())
    return out


def dp_cases(rank, world, small, init, batch, lr, steps, out_dir):
    """On each rank, from one init and this rank's half of `batch`: one
    data-parallel step (its metrics, the summed gradients, the state
    after it) and the eval step's metrics; then `steps` steps with the
    replicated Adam and with ZeRO-1, each rank's share of the moments,
    and the ZeRO-1 run's consolidated checkpoint (rank 0 writes it to
    `out_dir`)."""
    torch.set_num_threads(1)
    cfg = ModelConfig(**small)
    global_batch = batch[0].shape[0]
    local = D.shard_batch([torch.from_numpy(a) for a in batch], rank, world)

    def fresh(tcfg):
        return T.create_train_state(cfg, tcfg, device="cpu", params=init[0],
                                    batch_stats=init[1])

    tcfg = TrainConfig()
    state = fresh(tcfg)
    evaluate = T.make_eval_step(cfg, tcfg, global_batch)
    eval_metrics = {k: float(v) for k, v in evaluate(state, local).items()}
    state, metrics = T.make_train_step(cfg, tcfg, global_batch)(state, local,
                                                               lr)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "eval": eval_metrics, "grads": flat_grads(state.model),
           "state": flat_state(state.model)}
    for zero in (False, True):
        tcfg = TrainConfig(shard_optimizer=zero)
        state = fresh(tcfg)
        step = T.make_train_step(cfg, tcfg, global_batch)
        for _ in range(steps):
            state, _ = step(state, local, lr)
        tag = "zero" if zero else "replicated"
        out[tag] = flat_state(state.model)
        out[tag + "_moments"] = moments(state.optimizer, state.model)
        if zero:
            out["optimizer_type"] = type(state.optimizer).__name__
            ckpt.save_checkpoint(out_dir, state, write=rank == 0)
            torch.distributed.barrier()
            # every rank resumes from the consolidated file
            again = ckpt.restore_checkpoint(out_dir, fresh(tcfg))
            out["resumed_moments"] = moments(again.optimizer, again.model)
    return out
