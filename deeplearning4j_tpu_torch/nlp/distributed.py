"""Multi-process SequenceVectors training (the dl4j-spark-nlp role;
counterpart of deeplearning4j_tpu/nlp/distributed.py).

Parity: deeplearning4j-scaleout/spark/dl4j-spark-nlp — Spark Word2Vec
(spark/models/embeddings/word2vec/Word2Vec.java:1 — per-partition
training + table averaging) and ParagraphVectors' distributed fit.

Every process of a `torch.distributed` group builds the SAME vocab and
initial tables from the shared corpus (seeded — no broadcast needed),
trains its round-robin corpus shard locally with the in-process
SequenceVectors tiers (scan or dense), and every `sync_every` epochs the
processes exchange their k-epoch TABLE DELTAS, mean-reduced in rank order
exactly like LocalStepTrainer's local-SGD rendezvous
(parallel/wrapper.py), with optional threshold compression and a
per-process residual (the GradientsAccumulator encoding,
EncodingHandler.java:57-73 role) and the same wire accounting.

The tables stay where the model trains them: the deltas, the encoding,
the exchange (`collectives.all_gather`, the port's one caller of
torch.distributed) and the averaged write-back all run on the tables'
device, and the write-back lands in the device tables the next fit
trains in place (the dense tier's `_syn*_dev`), with no host round trip
per rendezvous. The scan tier uploads its tables at each fit and hands
them back on the host, as it does without this wrapper.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.parallel import collectives

_TABLES = ("syn0", "syn1", "syn1neg")


class DistributedSequenceVectors:
    """Data-parallel wrapper over a SequenceVectors instance.

    Usage (one process per host, in a process group):

        sv = Word2Vec.Builder()...build()   # or SequenceVectors(...)
        dsv = DistributedSequenceVectors(sv, sync_every=1)
        dsv.build_vocab(corpus)             # full corpus, every process
        dsv.fit(corpus)                     # trains THIS process's shard

    `sync_every` is in epochs (the reference averages per Spark stage);
    `threshold_compression` > 0 encodes each rendezvous delta as
    sign(delta+residual)*thr with residual carry. `rendezvous_s` sums the
    wall seconds spent in the exchanges.
    """

    def __init__(self, sv, sync_every: int = 1,
                 threshold_compression: float = 0.0,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.sv = sv
        self.sync_every = max(1, int(sync_every))
        self.threshold = float(threshold_compression)
        self._pid = process_index
        self._np = process_count
        self._residual: Dict[str, torch.Tensor] = {}
        self._sent_nnz: List[torch.Tensor] = []   # device scalars
        self._sent_total = 0
        self._n_rendezvous = 0
        self.rendezvous_s = 0.0

    # ------------------------------------------------------------ topology
    def _topology(self):
        if self._pid is not None and self._np is not None:
            return self._pid, self._np
        return collectives.rank(), collectives.world_size()

    @staticmethod
    def shard_sequences(sequences: List[Sequence[str]], pid: int,
                        nprocs: int) -> List[Sequence[str]]:
        """Round-robin per-process partition (the RDD partition role);
        deterministic so every process agrees without coordination."""
        return list(sequences[pid::nprocs])

    # ------------------------------------------------------------- vocab
    def build_vocab(self, sequences: Iterable[Sequence[str]]):
        """Full-corpus vocab on every process: with the shared seed the
        init tables are bit-identical, which replaces the reference's
        vocab broadcast."""
        self.sv.build_vocab(sequences)
        return self

    # -------------------------------------------------------------- sync
    def _tables(self) -> Dict[str, torch.Tensor]:
        """The live tables as f32 tensors: the device tables the model
        trains in place, else a device copy of its host ones."""
        sv = self.sv
        dev = resolve_device(sv.device)
        out = {}
        for n in _TABLES:
            t = getattr(sv, f"_{n}_dev", None)
            if t is None:
                host = getattr(sv, f"_{n}_host", None)
                if host is None:
                    continue
                t = torch.tensor(np.asarray(host, np.float32), device=dev)
            out[n] = t
        return out

    def _set_tables(self, tabs: Dict[str, torch.Tensor]) -> None:
        """Hand the averaged tables to the model as its device tables (the
        next fit trains them in place; the host copies refetch lazily)."""
        for n, t in tabs.items():
            setattr(self.sv, f"_{n}_host", None)
            setattr(self.sv, f"_{n}_dev", t)

    def _encode(self, name: str, delta: torch.Tensor) -> torch.Tensor:
        """Threshold-encode with residual carry (EncodingHandler role);
        no-op when compression is off."""
        if self.threshold <= 0.0:
            return delta
        res = self._residual.get(name)
        if res is None:
            res = torch.zeros_like(delta)
        acc = delta + res
        send = torch.where(acc.abs() >= self.threshold,
                           torch.sign(acc) * self.threshold,
                           torch.zeros_like(acc))
        self._residual[name] = acc - send
        self._sent_nnz.append(torch.count_nonzero(send))
        self._sent_total += send.numel()
        return send

    def _allmean(self, deltas: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Each delta's mean over the processes, summed in rank order and
        divided by their count (the JAX package's mean of the gathered
        stack): every process gets the same bits."""
        pid, nprocs = self._topology()
        if nprocs <= 1:
            return deltas
        out = {}
        for k, d in deltas.items():
            gathered = collectives.all_gather(d.reshape(-1)).view(
                (nprocs,) + tuple(d.shape))
            acc = gathered[0].clone()
            for r in range(1, nprocs):
                acc += gathered[r]
            out[k] = acc / nprocs
        return out

    def wire_stats(self) -> Dict[str, float]:
        """Fraction of delta elements actually shipped at the
        compressed rendezvous (LocalStepTrainer.wire_stats parity —
        same "compression_ratio" key)."""
        if self._sent_total == 0:
            return {"rendezvous": self._n_rendezvous,
                    "compression_ratio": 1.0}
        nnz = sum(int(t) for t in self._sent_nnz)
        return {"rendezvous": self._n_rendezvous,
                "compression_ratio": nnz / self._sent_total}

    # --------------------------------------------------------------- fit
    def fit(self, sequences: Iterable[Sequence[str]],
            epochs: Optional[int] = None):
        """Train this process's shard; rendezvous every `sync_every`
        epochs. Total epoch count comes from the wrapped model."""
        import time

        seqs = list(sequences)
        pid, nprocs = self._topology()
        shard = self.shard_sequences(seqs, pid, nprocs)
        if not shard:
            shard = seqs[:1]    # degenerate corpora: keep SPMD in step
        total = int(epochs if epochs is not None else self.sv.epochs)
        saved = (self.sv.epochs, self.sv.lr_total_epochs)
        # One GLOBAL anneal across all k-epoch chunks (not a per-chunk
        # sawtooth): lr_total_epochs sets the decay denominator and the
        # model's _lr_seen carry continues the numerator across fit()
        # calls. One persistent RNG stream per process so chunks don't
        # replay identical shuffles/negatives and shards decorrelate.
        if self.sv._fit_rng is None:
            self.sv._fit_rng = np.random.default_rng(
                self.sv.seed + 1 + 7919 * pid)
        try:
            self.sv.lr_total_epochs = total
            self.sv._lr_seen = 0
            done = 0
            while done < total:
                k = min(self.sync_every, total - done)
                with torch.no_grad():
                    before = {n: t.clone() for n, t in self._tables().items()}
                self.sv.epochs = k
                self.sv.fit(shard)
                with torch.no_grad():
                    after = self._tables()
                    deltas = {n: self._encode(n, after[n] - before[n])
                              for n in after}
                    t0 = time.perf_counter()
                    mean = self._allmean(deltas)
                    self.rendezvous_s += time.perf_counter() - t0
                    self._n_rendezvous += 1
                    self._set_tables({n: before[n] + mean[n] for n in mean})
                done += k
        finally:
            self.sv.epochs, self.sv.lr_total_epochs = saved
        return self

    # ------------------------------------------------- query pass-through
    def __getattr__(self, item):
        return getattr(self.sv, item)


__all__ = ["DistributedSequenceVectors"]
