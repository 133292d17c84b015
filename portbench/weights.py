"""Seeded weights, made on the device in a few large draws, and their
Flax-shaped trees (the layout the program's loaders take).

Two distributions:
- `serve`: kernels N(0, 1/fan_in), conv biases, BatchNorm offsets and
  means N(0, 0.1^2), BatchNorm scales U(0.8, 1.2), variances U(0.5, 1.5)
  (a served model whose statistics are not the identity);
- `train`: the initialisation a training run starts from, kernels
  lecun-normal (truncated at 2 sigma, std sqrt(1/fan_in) / 0.87962566),
  biases and offsets 0, scales 1, means 0, variances 1.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from reference.model import conv_specs

F32 = torch.float32
TRUNC_STD = 0.87962566103423978


def _split(flat: torch.Tensor, sizes):
    out, at = [], 0
    for n in sizes:
        out.append(flat[at:at + n])
        at += n
    return out


def make_weights(model: dict, seed: int, kind: str, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{block path: {kernel OIHW, bias[, scale, offset, mean, var]}} in
    float32 on `device`, from `seed`."""
    specs = conv_specs(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    ksizes = [co * ci * k * k for _, ci, co, k, _ in specs]
    flat = torch.randn(sum(ksizes), generator=gen, device=device)
    if kind == "train":
        for _ in range(100):
            out = flat.abs() > 2.0
            n = int(out.sum())
            if n == 0:
                break
            flat[out] = torch.randn(n, generator=gen, device=device)
    cos = [co for _, _, co, _, _ in specs]
    total = sum(cos)
    if kind == "serve":
        normals = torch.randn(3 * total, generator=gen, device=device) * 0.1
        uni = torch.rand(2 * total, generator=gen, device=device)
    weights = {}
    vec_at = 0
    for (name, ci, co, k, _), kflat in zip(specs, _split(flat, ksizes)):
        fan_in = ci * k * k
        std = (fan_in ** -0.5) / (TRUNC_STD if kind == "train" else 1.0)
        p = {"kernel": (kflat * std).reshape(co, ci, k, k)}
        sl = slice(vec_at, vec_at + co)
        vec_at += co
        if kind == "serve":
            p["bias"] = normals[sl]
            if not name.startswith("DetectionHead"):
                p["offset"] = normals[total:][sl]
                p["mean"] = normals[2 * total:][sl]
                p["scale"] = 0.8 + 0.4 * uni[sl]
                p["var"] = 0.5 + uni[total:][sl]
        else:
            p["bias"] = torch.zeros(co, device=device)
            if not name.startswith("DetectionHead"):
                p["offset"] = torch.zeros(co, device=device)
                p["mean"] = torch.zeros(co, device=device)
                p["scale"] = torch.ones(co, device=device)
                p["var"] = torch.ones(co, device=device)
        weights[name] = {key: v.contiguous() for key, v in p.items()}
    return weights


def flax_trees(weights: Dict[str, Dict[str, torch.Tensor]]
               ) -> Tuple[dict, dict]:
    """(params, batch_stats) nested dicts of float32 numpy arrays, kernels
    HWIO, under the Flax module names (`Conv_0`, `BatchNorm_0`)."""
    params: dict = {}
    stats: dict = {}

    def node(tree, path):
        for part in path.split("/"):
            tree = tree.setdefault(part, {})
        return tree

    def host(t):
        return np.ascontiguousarray(t.detach().to("cpu", F32).numpy())

    for name, p in weights.items():
        conv = node(params, name + "/Conv_0")
        conv["kernel"] = host(p["kernel"].permute(2, 3, 1, 0))
        conv["bias"] = host(p["bias"])
        if "scale" in p:
            bn = node(params, name + "/BatchNorm_0")
            bn["scale"], bn["bias"] = host(p["scale"]), host(p["offset"])
            st = node(stats, name + "/BatchNorm_0")
            st["mean"], st["var"] = host(p["mean"]), host(p["var"])
    return params, stats
