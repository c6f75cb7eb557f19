"""K-means unit quantizer and run-length deduplication (counterpart of
unitspeech_tpu/models/ssl/kmeans.py; reference textlesslib
kmeans_quantizer.py): the nearest centroid by one product,
argmin(||c||^2 - 2 x.c), which is argmin ||x - c||^2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def kmeans_distances(features: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(T, D), (K, D) -> (T, K) f32: ||c||^2 - 2 x.c, the squared distance
    less ||x||^2."""
    return (centroids ** 2).sum(dim=1)[None, :] - 2.0 * features @ centroids.t()


def kmeans_predict(features: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(T, D), (K, D) -> (T,) int32 nearest-centroid indices."""
    return kmeans_distances(features, centroids).argmin(dim=1).to(torch.int32)


def dedup_consecutive(units):
    """(T,) -> (unique units, run lengths), as torch.unique_consecutive with
    return_counts=True."""
    units = np.asarray(units)
    if len(units) == 0:
        return units, np.zeros((0,), np.int64)
    change = np.flatnonzero(np.diff(units)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(units)]])
    return units[starts], (ends - starts).astype(np.int64)


@dataclass
class KMeansQuantizer:
    """A centroid table (K, D); `.npz` files hold it under "centroids"
    (utils/torch_convert_ssl.convert_sklearn_kmeans converts sklearn's)."""

    centroids: np.ndarray

    @property
    def vocab_size(self) -> int:
        return self.centroids.shape[0]

    def __call__(self, dense_features) -> np.ndarray:
        """(T, D) features, a tensor (the product runs on its device) or an
        array -> (T,) int32 units."""
        x = torch.as_tensor(dense_features, dtype=torch.float32)
        c = torch.as_tensor(self.centroids, dtype=torch.float32, device=x.device)
        return kmeans_predict(x, c).cpu().numpy()

    @classmethod
    def load(cls, path: str) -> "KMeansQuantizer":
        with np.load(path) as z:
            return cls(centroids=np.asarray(z["centroids"], np.float32))

    def save(self, path: str):
        np.savez(path, centroids=self.centroids)
