"""One rank of the port's supervised training gangs (the counterpart of
tests/helpers/distributed_worker.py, for tests/test_torch_cluster_gang.py
and chip_smoke's gang drill). It imports only the port.

    python gang_worker.py PID NPROCS PORT STEPS OUT_DIR [options]

Joins a process group of NPROCS (gloo; `--backend nccl` with one card per
rank), trains a fixed dense net through TrainingMaster for STEPS global
steps on the deterministic global batches of `global_batch` (each rank
its contiguous rows), optionally stops early (`--stop-after`) and resumes
from checkpoints. Rank 0 writes OUT_DIR/final_params.npz (the params, the
iteration, the live world) at the end.

`--cluster` runs the rank as a ClusterSupervisor gang member: a
HeartbeatFile lease is renewed from the StepWatchdog beat path
(`--heartbeat-dir`, `--hang-timeout`: 0 is lease emission only, > 0 arms
the watchdog's escalation), the supervisor's shared resume step is
honored exactly (`--resume-step`), a NonFiniteLossError under
`--guard abort` exits EXIT_NAN, a collective that failed because a peer
died exits EXIT_PEER_LOST with the peer-lost marker (a collateral death,
resilience/cluster.py), and any other error prints its traceback and
exits 1 at once.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

GLOBAL_BATCH = 32
FEATURES = 5
CLASSES = 3

# zero1 gang geometry: every leading dim divisible by the dp extents of
# BOTH a 3-rank gang and the 2-rank gang it shrinks to (lcm 6), so the
# optimizer state really shards before AND after the reshard
ZERO1_BATCH = 24
ZERO1_FEATURES = 12
ZERO1_HIDDEN = 24
ZERO1_CLASSES = 12


def build_net(device, zero1: bool = False):
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    features = ZERO1_FEATURES if zero1 else FEATURES
    hidden = ZERO1_HIDDEN if zero1 else 16
    classes = ZERO1_CLASSES if zero1 else CLASSES
    conf = (NeuralNetConfiguration.Builder().seed(7).updater("adam")
            .learning_rate(1e-2).activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=hidden))
            .layer(OutputLayer(n_out=classes, loss="mcxent"))
            .set_input_type(InputType.feed_forward(features))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def global_batch(step, zero1: bool = False):
    """Deterministic global batch for `step` (the JAX drill's)."""
    import numpy as np

    batch = ZERO1_BATCH if zero1 else GLOBAL_BATCH
    features = ZERO1_FEATURES if zero1 else FEATURES
    classes = ZERO1_CLASSES if zero1 else CLASSES
    rng = np.random.default_rng(1000 + step)
    x = rng.normal(size=(batch, features)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, batch)]
    return x, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("pid", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("port")
    ap.add_argument("steps", type=int)
    ap.add_argument("out_dir")
    ap.add_argument("--stop-after", type=int, default=0)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--averaging-frequency", type=int, default=1)
    ap.add_argument("--threshold-compression", type=float, default=0.0)
    ap.add_argument("--supervise", type=int, default=0)
    ap.add_argument("--cluster", action="store_true")
    ap.add_argument("--heartbeat-dir", default="")
    ap.add_argument("--resume-step", type=int, default=-1)
    ap.add_argument("--hang-timeout", type=float, default=0.0)
    ap.add_argument("--per-rank-ckpt", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--guard", default="", choices=("", "abort"))
    ap.add_argument("--spin-ms", type=float, default=0.0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel.training_master import (
        TrainingMaster,
    )
    from deeplearning4j_tpu_torch.resilience.cluster import (
        EXIT_NAN,
        HeartbeatFile,
        exit_peer_lost,
        heartbeat_path,
        is_peer_loss,
    )

    torch.set_num_threads(1)
    device = (f"cuda:{args.pid}" if args.backend == "nccl"
              else args.device)
    hb = wd = guard = None
    if args.cluster:
        from deeplearning4j_tpu_torch.resilience.supervisor import (
            StepWatchdog,
        )

        # the elastic identity rides the lease: world size from the
        # launch arguments, slot from the supervisor's environment
        slot = os.environ.get("DL4J_TPU_SLOT")
        hb = HeartbeatFile(
            heartbeat_path(args.heartbeat_dir or args.out_dir, args.pid),
            world_size=args.nprocs, slot=int(slot) if slot else None)
        wd = StepWatchdog(timeout_s=args.hang_timeout or 1e9,
                          poll_s=min(0.25, (args.hang_timeout or 1e9) / 4.0),
                          heartbeat=hb)
    TrainingMaster.initialize_distributed(
        f"127.0.0.1:{args.port}", args.nprocs, args.pid,
        backend=args.backend, device=device)
    net = build_net(device, zero1=args.zero1)
    ckpt = (os.path.join(args.out_dir, "ckpt")
            if args.checkpoint_every else None)
    if args.guard == "abort":
        from deeplearning4j_tpu_torch.resilience.supervisor import (
            NonFiniteGuard,
        )

        guard = NonFiniteGuard(policy="abort", check_every=1)
    tm = TrainingMaster(
        net, checkpoint_dir=ckpt, checkpoint_every=args.checkpoint_every,
        averaging_frequency=args.averaging_frequency,
        threshold_compression=args.threshold_compression,
        watchdog=wd, guard=guard, per_rank_checkpoints=args.per_rank_ckpt,
        sharding="zero1" if args.zero1 else None)

    def batch_fn(step):
        if args.spin_ms > 0:
            time.sleep(args.spin_ms / 1e3)
        x, y = global_batch(step, zero1=args.zero1)
        gb = ZERO1_BATCH if args.zero1 else GLOBAL_BATCH
        per = gb // args.nprocs
        s = args.pid * per
        return x[s:s + per], y[s:s + per]

    steps = args.stop_after or args.steps
    restarts = 0
    if args.supervise:
        from deeplearning4j_tpu_torch.resilience.supervisor import Supervisor

        sup = Supervisor(max_restarts=args.supervise,
                         initial_backoff_s=0.2, max_backoff_s=1.0)
        sup.run(tm.fit, batch_fn, steps)
        restarts = len(sup.restart_ledger)
    elif args.cluster:
        from deeplearning4j_tpu_torch.resilience.errors import (
            NonFiniteLossError,
        )

        # resume handshake: the supervisor chose ONE step for the whole
        # gang; honor it exactly (<0 = first launch, auto-resume)
        start = None
        if args.resume_step >= 0:
            start = tm.load_checkpoint_at(args.resume_step)
        try:
            tm.fit(batch_fn, steps, start_step=start)
        except NonFiniteLossError:
            hb.mark("nan_abort")
            os._exit(EXIT_NAN)
        except BaseException as e:   # noqa: BLE001 - gang member fail-fast
            if is_peer_loss(e):
                exit_peer_lost(e, hb)
            # any other fatal error: a PROMPT nonzero exit (a normal exit
            # would wait in the process group's teardown against dead or
            # dying peers until the lease times out)
            import traceback

            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            hb.mark("crash")
            os._exit(1)
        hb.mark("done")
    else:
        tm.fit(batch_fn, steps)

    if args.stop_after:
        print(f"pid={args.pid} stopped-after {args.stop_after}", flush=True)
    else:
        if args.pid == 0:
            from deeplearning4j_tpu_torch.util.tree import leaves

            arrays = [t.detach().cpu().numpy() for t in leaves(net.params)]
            extras = {"score": float(net.score()),
                      "iteration": net.iteration, "restarts": restarts,
                      "world": args.nprocs}
            np.savez(os.path.join(args.out_dir, "final_params.npz"),
                     *arrays, **extras)
        print(f"pid={args.pid} done score={float(net.score()):.5f}",
              flush=True)
    collectives.destroy_process_group()


if __name__ == "__main__":
    main()
