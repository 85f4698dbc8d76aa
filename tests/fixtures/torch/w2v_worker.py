"""One process of the port's multi-process SequenceVectors drill
(tests/test_torch_nlp_distributed.py; the counterpart of
tests/helpers/w2v_distributed_worker.py). It imports only the port.

    python w2v_worker.py PID NPROCS PORT OUT_DIR
        [--epochs N] [--sync-every N] [--threshold T] [--device cpu|cuda]

Joins a gloo group of NPROCS, trains its corpus shard through
DistributedSequenceVectors and writes OUT_DIR/syn0_<PID>.npy, the wire
stats OUT_DIR/stats_<PID>.json and, for the `_allmean` check, the mean
of fixed per-process deltas OUT_DIR/allmean_<PID>.npy (process p's delta
drawn from default_rng(100 + p)).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def corpus():
    """The JAX drill's deterministic two-cluster corpus: 'a*' words
    co-occur only with 'a*', 'b*' only with 'b*'."""
    import numpy as np

    rng = np.random.default_rng(7)
    A = [f"a{i}" for i in range(12)]
    B = [f"b{i}" for i in range(12)]
    seqs = []
    for i in range(400):
        pool = A if i % 2 == 0 else B
        seqs.append(list(rng.choice(pool, size=12)))
    return seqs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("pid", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("port")
    ap.add_argument("out_dir")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--sync-every", type=int, default=2)
    ap.add_argument("--threshold", type=float, default=0.0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.nlp.distributed import (
        DistributedSequenceVectors,
    )
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
    from deeplearning4j_tpu_torch.parallel import collectives

    torch.set_num_threads(1)
    if args.nprocs > 1:
        collectives.init_process_group(f"127.0.0.1:{args.port}",
                                       args.nprocs, args.pid,
                                       backend="gloo", device=args.device)
    try:
        sv = SequenceVectors(layer_size=16, window=3, negative=4,
                             epochs=args.epochs, seed=11, mode="scan",
                             device=args.device)
        dsv = DistributedSequenceVectors(
            sv, sync_every=args.sync_every,
            threshold_compression=args.threshold)
        seqs = corpus()
        dsv.build_vocab(seqs)
        dsv.fit(seqs)
        np.save(os.path.join(args.out_dir, f"syn0_{args.pid}.npy"), sv.syn0)
        with open(os.path.join(args.out_dir, f"stats_{args.pid}.json"),
                  "w") as f:
            json.dump(dsv.wire_stats(), f)
        delta = np.random.default_rng(100 + args.pid).normal(
            size=(24, 16)).astype(np.float32)
        mean = dsv._allmean({"syn0": torch.from_numpy(delta).to(
            args.device)})["syn0"]
        np.save(os.path.join(args.out_dir, f"allmean_{args.pid}.npy"),
                mean.cpu().numpy())
    finally:
        collectives.destroy_process_group()
    print("WORKER_OK", args.pid)


if __name__ == "__main__":
    main()
