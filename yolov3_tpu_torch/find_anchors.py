"""Anchor-selection tool: k-means over ground-truth box sizes (port of
`yolov3_tpu/find_anchors.py`).

    python -m yolov3_tpu_torch.find_anchors --csv_dirpath C \
        [--plot_path scatterplot_k_clusters.png]

The reference's reference/find_anchor_sizes.py:19-66: gather (w, h) of
every annotated box, run k-means for k = 2..7, print each k's score and
cluster centres, and save a scatterplot. A human picks the anchor set
and passes it to training with `--anchors`.

The card's host has no scikit-learn, so k-means is written here in
numpy, after scikit-learn's `KMeans(n_init=10)`: greedy k-means++ seeding
(2 + ln k candidates a centre) from an explicit `np.random.Generator`
(seeded 0, as the JAX tool's `random_state=0`),
Lloyd iterations to a tolerance of 1e-4 of the mean feature variance,
empty clusters moved to the points farthest from their centres, and the
run of least inertia kept. The score is scikit-learn's: the negative
inertia at the kept centres. matplotlib is imported only to plot.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple

import numpy as np

from yolov3_tpu_torch.ops import boxes as bbox


def collect_box_sizes(csv_dirpath: str) -> np.ndarray:
    """Stack [N, 2] (w, h) from every annotation CSV in a folder."""
    sizes: List[np.ndarray] = []
    for fn in sorted(os.listdir(csv_dirpath)):
        if not fn.endswith(".csv"):
            continue
        rows = bbox.load_boxes_to_xywhc(os.path.join(csv_dirpath, fn))
        if rows.shape[0]:
            sizes.append(rows[:, 2:4])
    if not sizes:
        return np.zeros((0, 2))
    return np.concatenate(sizes, axis=0)


def _sq_dists(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    return ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.Generator
               ) -> np.ndarray:
    """Greedy k-means++ seeding: each new centre is the best, by the
    potential it leaves, of 2 + ln k candidates drawn with probability
    proportional to the squared distance to the nearest centre."""
    n = x.shape[0]
    trials = 2 + int(np.log(k))
    centers = [x[rng.integers(n)]]
    closest = _sq_dists(x, np.asarray(centers))[:, 0]
    for _ in range(1, k):
        pot = closest.sum()
        if pot <= 0.0:  # fewer distinct points than clusters
            cand = rng.integers(n, size=trials)
        else:
            cand = np.searchsorted(np.cumsum(closest),
                                   rng.random(trials) * pot)
            cand = np.minimum(cand, n - 1)
        d = np.minimum(closest[None, :], _sq_dists(x, x[cand]).T)
        best = int(np.argmin(d.sum(1)))
        centers.append(x[cand[best]])
        closest = d[best]
    return np.asarray(centers)


def _lloyd(x: np.ndarray, centers: np.ndarray, tol: float,
           max_iter: int) -> Tuple[np.ndarray, np.ndarray]:
    for _ in range(max_iter):
        d = _sq_dists(x, centers)
        labels = d.argmin(1)
        new = centers.copy()
        counts = np.bincount(labels, minlength=len(centers))
        for j in np.nonzero(counts)[0]:
            new[j] = x[labels == j].mean(0)
        empty = np.nonzero(counts == 0)[0]
        if len(empty):
            far = np.argsort(-d[np.arange(len(x)), labels])[:len(empty)]
            new[empty] = x[far]
        shift = ((new - centers) ** 2).sum()
        centers = new
        if shift <= tol:
            break
    return centers, _sq_dists(x, centers).argmin(1)


def kmeans(x: np.ndarray, k: int, rng: np.random.Generator,
           n_init: int = 10, max_iter: int = 300, tol: float = 1e-4
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """(centres [k, d], labels [n], inertia) of the best of `n_init`
    k-means runs."""
    x = np.asarray(x, np.float64)
    tol = float(np.mean(np.var(x, axis=0))) * tol
    best = None
    for _ in range(n_init):
        centers, labels = _lloyd(x, _kmeans_pp(x, k, rng), tol, max_iter)
        inertia = float(((x - centers[labels]) ** 2).sum())
        if best is None or inertia < best[2]:
            best = (centers, labels, inertia)
    return best


def find_anchors(csv_dirpath: str, k_range: Tuple[int, int] = (2, 7),
                 plot_path: Optional[str] = "scatterplot_k_clusters.png",
                 ) -> dict:
    """Run k-means for each k; returns {k: (score, centers [k,2])}."""
    sizes = collect_box_sizes(csv_dirpath)
    print(f"Collected {sizes.shape[0]} boxes")
    if sizes.shape[0] < k_range[1]:
        raise ValueError("Not enough boxes for clustering")

    rng = np.random.default_rng(0)
    results, labels = {}, {}
    for k in range(k_range[0], k_range[1] + 1):
        centers, labels[k], inertia = kmeans(sizes, k, rng)
        results[k] = (-inertia, centers)
        print(f"k={k} score={-inertia}")
        print("  cluster centers (w, h):")
        for c in centers:
            print(f"    ({c[0]:.1f}, {c[1]:.1f})")

    if plot_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(2, 3, figsize=(15, 9))
        for ax, k in zip(axes.flat, results):
            centers = results[k][1]
            ax.scatter(sizes[:, 0], sizes[:, 1], c=labels[k], s=4, alpha=0.4)
            ax.scatter(centers[:, 0], centers[:, 1], marker="x", c="red")
            ax.set_title(f"k={k}")
            ax.set_xlabel("box width (px)")
            ax.set_ylabel("box height (px)")
        fig.tight_layout()
        fig.savefig(plot_path)
        plt.close(fig)
        print(f"Saved {plot_path}")
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="find_anchors",
        description="Cluster ground-truth box sizes to pick YOLO anchors")
    parser.add_argument("--csv_dirpath", type=str, required=True,
                        help="folder of annotation csv files")
    parser.add_argument("--plot_path", type=str,
                        default="scatterplot_k_clusters.png",
                        help="scatterplot to write ('' for none)")
    args = parser.parse_args(argv)
    find_anchors(args.csv_dirpath, plot_path=args.plot_path)


if __name__ == "__main__":
    main()
