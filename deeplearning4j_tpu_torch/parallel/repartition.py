"""Partitioners for balancing examples across workers/hosts (a copy of
deeplearning4j_tpu/parallel/repartition.py: numpy only).

Parity: the Spark module's repartitioners —
spark/impl/common/repartition/BalancedPartitioner.java:17-35 (equal
partition sizes with the remainder spread over the first partitions)
and HashingBalancedPartitioner.java (deterministic key-hash assignment
that stays balanced per class). Here they drive `batch_fn`-style host
partitions for TrainingMaster instead of Spark RDD shuffles.
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np


class BalancedPartitioner:
    """Split n_elements into n_partitions of equal size, the remainder
    going one-each to the first partitions
    (BalancedPartitioner.java:23-35)."""

    def __init__(self, n_partitions: int, n_elements: int):
        if n_partitions < 1:
            raise ValueError(f"n_partitions must be >= 1: {n_partitions}")
        self.n_partitions = n_partitions
        self.n_elements = n_elements
        base = n_elements // n_partitions
        rem = n_elements % n_partitions
        self.sizes = [base + (1 if i < rem else 0)
                      for i in range(n_partitions)]
        self._starts = np.cumsum([0] + self.sizes)

    def partition_of(self, index: int) -> int:
        """Partition id owning element `index` (getPartition role)."""
        if not 0 <= index < self.n_elements:
            raise IndexError(index)
        return int(np.searchsorted(self._starts, index, "right") - 1)

    def bounds(self, partition: int):
        """(start, end) element range of `partition` — the slice a host
        feeds its batch_fn from."""
        return int(self._starts[partition]), \
            int(self._starts[partition + 1])


class HashingBalancedPartitioner:
    """Deterministic key->partition assignment that balances within
    each key class (HashingBalancedPartitioner.java role): the i-th
    element of a class lands on (hash(class) + i) % n, so every
    partition sees ~class-proportional data. STATELESS: the same key
    sequence always produces the same assignment."""

    def __init__(self, n_partitions: int):
        if n_partitions < 1:
            raise ValueError(f"n_partitions must be >= 1: {n_partitions}")
        self.n_partitions = n_partitions

    def partition_of(self, key, occurrence: int = 0) -> int:
        """Partition of the `occurrence`-th element of `key`'s class
        (pure function of its arguments)."""
        cls = key if not isinstance(key, (tuple, list)) else key[0]
        h = zlib.crc32(str(cls).encode())
        return (h + occurrence) % self.n_partitions

    def assign(self, keys: Sequence) -> np.ndarray:
        """Assignment for a key sequence; per class the assignment
        round-robins, so class balance holds per partition.
        Deterministic in the sequence alone."""
        seen: dict = {}
        out = []
        for k in keys:
            cls = k if not isinstance(k, (tuple, list)) else k[0]
            c = seen.get(cls, 0)
            seen[cls] = c + 1
            out.append(self.partition_of(k, c))
        return np.asarray(out)
