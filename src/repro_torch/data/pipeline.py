"""Vector + label workload generator (port of ``repro/data/pipeline.py``'s
``VectorLabelDataset``): the paper's §6 label distributions over N(0,1) or
clustered vectors, a pure function of the seed (numpy's generator, so the
same seed gives the JAX package's data)."""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.labels import LabelWorkloadConfig, generate_label_sets


@dataclasses.dataclass(frozen=True)
class VectorLabelDataset:
    """Paper §6 workload generator: vectors + label sets + queries."""
    n: int = 20_000
    dim: int = 32
    n_labels: int = 12
    distribution: str = "zipf"    # zipf | uniform | poisson | multinormal
    zipf_a: float = 1.5
    avg_size: float = 3.0
    n_clusters: int = 0           # >0: clustered (IVF-friendly) vectors
    seed: int = 0

    def generate(self):
        rng = np.random.default_rng(self.seed)
        if self.n_clusters:
            centers = rng.normal(size=(self.n_clusters, self.dim)) * 4.0
            assign = rng.integers(0, self.n_clusters, size=self.n)
            vectors = centers[assign] + rng.normal(size=(self.n, self.dim))
        else:
            vectors = rng.normal(size=(self.n, self.dim))
        vectors = vectors.astype(np.float32)
        label_sets = generate_label_sets(self.n, LabelWorkloadConfig(
            num_labels=self.n_labels, distribution=self.distribution,
            zipf_a=self.zipf_a, mean_set_size=self.avg_size, seed=self.seed))
        return vectors, label_sets

    def queries(self, n_queries: int, k_labels: tuple[int, ...] = (0, 1, 2, 3)):
        """Query vectors + query label sets drawn from base distribution."""
        rng = np.random.default_rng(self.seed + 1)
        qv = rng.normal(size=(n_queries, self.dim)).astype(np.float32)
        base = generate_label_sets(n_queries, LabelWorkloadConfig(
            num_labels=self.n_labels, distribution=self.distribution,
            zipf_a=self.zipf_a, mean_set_size=self.avg_size,
            seed=self.seed + 1))
        qls = []
        for ls in base:
            size = int(rng.choice(k_labels))
            qls.append(tuple(sorted(rng.choice(ls, size=min(size, len(ls)),
                                               replace=False)))
                       if ls and size else ())
        return qv, qls
