#!/usr/bin/env python3
"""One supervised training rank for the cluster-supervision drills
(jax-free: it imports the port, torch and numpy only).

    python cluster_worker.py OUT RESUME_STEP --hb PATH [options]

Trains `--steps` seeded steps through TrainingMaster(steps_per_dispatch=
k, checkpoint_every=k, preemption=True) under StepWatchdog(heartbeat=
HeartbeatFile(PATH), hang_exit_after=...), after restoring checkpoint
RESUME_STEP (the ClusterSupervisor's resume handshake; 0 starts fresh).
The data are `--data` seeded host batches, step s taking batch s %
--data, so a relaunch replays the stream from the resume step.

On CUDA the k-step group is captured before the watchdog starts (a
guard snapshot is restored after it, so the state is untouched): the
lease then covers steps and checkpoints, and the supervisor's
`startup_grace_s` covers the interpreter, the net's build and the
capture.

`--wedge-window W` wedges the first generation (RESUME_STEP 0) at the
start of its W-th window, after the previous windows' checkpoints:
  host  the port's `train.hang_hard` site, armed with a delay: a Python
        sleep with SIGUSR1 and SIGTERM blocked;
  cuda  a device kernel spinning `--wedge-s` seconds, waited for in
        torch.cuda.synchronize(): the main thread sits inside a CUDA
        wait, where Python defers the SIGUSR1 and SIGTERM handlers.
Either way the watchdog's monitor thread exits the process with
EXIT_HANG after `--hang-exit-after` silent detections, or the
supervisor finds the lease stale and kills it.

Writes OUT/gen-<RESUME_STEP>.json (timings, kernel launches, capture
events), OUT/watchdog-<RESUME_STEP>.log (the watchdog's records, each
with its wall time), OUT/wedge.json just before a wedge, and
OUT/final.npz (every carry tensor and the iteration) when it completes.
"""

import argparse
import json
import logging
import os
import sys
import time

T_START = time.time()
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))


def build_net(args):
    if args.model == "resnet50":
        from deeplearning4j_tpu_torch.zoo.models import ResNet50

        return ResNet50(input_shape=(args.hw, args.hw, 3),
                        compute_dtype="bfloat16",
                        helpers="pallas").init_model(device=args.device)
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.Builder().seed(7).updater("adam")
            .learning_rate(1e-2).activation("tanh").weight_init("xavier")
            .list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=args.classes, loss="mcxent"))
            .set_input_type(InputType.feed_forward(args.features))
            .build())
    return MultiLayerNetwork(conf, device=args.device).init()


def make_data(np, args):
    rng = np.random.default_rng(args.seed)
    shape = ((args.batch, args.hw, args.hw, 3) if args.model == "resnet50"
             else (args.batch, args.features))
    out = []
    for _ in range(args.data):
        x = rng.standard_normal(shape, dtype=np.float32)
        y = np.eye(args.classes, dtype=np.float32)[
            rng.integers(0, args.classes, args.batch)]
        out.append((x, y))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("resume_step", type=int)
    ap.add_argument("--hb", required=True, help="the lease file")
    ap.add_argument("--model", choices=("mlp", "resnet50"), default="mlp")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hw", type=int, default=224)
    ap.add_argument("--features", type=int, default=4)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--timeout", type=float, default=1.0,
                    help="the watchdog's timeout_s")
    ap.add_argument("--hang-exit-after", type=int, default=2)
    ap.add_argument("--wedge-window", type=int, default=0)
    ap.add_argument("--wedge", choices=("host", "cuda"), default="host")
    ap.add_argument("--wedge-s", type=float, default=120.0)
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.backends.cudnn.deterministic")
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as pc
    from deeplearning4j_tpu_torch.parallel import training_master as tmm
    from deeplearning4j_tpu_torch.resilience import (
        HeartbeatFile,
        NonFiniteGuard,
        StepWatchdog,
        injector,
    )
    from deeplearning4j_tpu_torch.util.tree import leaves

    os.makedirs(args.out, exist_ok=True)
    gen = args.resume_step
    handler = logging.FileHandler(
        os.path.join(args.out, f"watchdog-{gen}.log"))
    handler.setFormatter(logging.Formatter("%(created).6f %(message)s"))
    logging.getLogger("deeplearning4j_tpu_torch").addHandler(handler)
    cuda = args.device != "cpu"
    if not cuda:
        # one intra-op thread: the MLP's ops are tiny, and eight OpenMP
        # threads per worker on a loaded host stall a window for seconds
        # (a healthy lease then goes stale, or the 1 s watchdog fires)
        torch.set_num_threads(1)
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = args.deterministic

    net = build_net(args)
    data = make_data(np, args)
    wd = StepWatchdog(timeout_s=args.timeout,
                      heartbeat=HeartbeatFile(args.hb),
                      hang_exit_after=args.hang_exit_after)
    tm = tmm.TrainingMaster(net, checkpoint_dir=os.path.join(args.out,
                                                             "ckpt"),
                            checkpoint_every=args.k,
                            steps_per_dispatch=args.k, watchdog=wd,
                            preemption=True)
    tm.load_checkpoint_at(gen)
    prog = tm._harness.program
    t_capture = 0.0
    if cuda:
        # capture the group outside the lease; the snapshot's restore
        # leaves the state as the checkpoint left it
        t0 = time.time()
        guard = NonFiniteGuard()
        snap = guard.snapshot(net)
        window = [data[s % args.data] for s in range(gen, gen + args.k)]
        prog.run_group(np.stack([x for x, _ in window]),
                       np.stack([y for _, y in window]))
        torch.cuda.synchronize()
        guard.restore(net, snap)
        t_capture = time.time() - t0
    captures_before = prog.group_stats["captures"]

    wedge_at = args.wedge_window if gen == 0 else 0
    if wedge_at and args.wedge == "host":
        injector().inject("train.hang_hard", mode="delay", at_hit=wedge_at,
                          delay_s=args.wedge_s)
    windows = [0]
    orig_hang_site = tmm.fire_hang_hard

    def hang_site():
        windows[0] += 1
        if windows[0] == wedge_at:
            with open(os.path.join(args.out, "wedge.json"), "w") as f:
                json.dump({"time": time.time(), "window": wedge_at,
                           "wedge": args.wedge}, f)
            if args.wedge == "cuda":
                # ~2e9 cycles a second at the card's clock
                torch.cuda._sleep(int(args.wedge_s * 2e9))
                torch.cuda.synchronize()
        orig_hang_site()

    tmm.fire_hang_hard = hang_site

    first = {}

    class FirstWindow:
        def iteration_done(self, net, iteration):
            if not first:
                if cuda:
                    torch.cuda.synchronize()
                first["time"] = time.time()

    net.listeners = [FirstWindow()]
    pc.reset_launch_counts()
    t_ready = time.time()
    tm.fit(lambda s: data[s % args.data], args.steps, start_step=gen,
           collect_training_stats=True)
    if cuda:
        torch.cuda.synchronize()
    t_end = time.time()
    steps_run = args.steps - gen
    counts = pc.launch_counts()
    ckpt_s = sum(r["checkpoint_ms"] for r in tm._stats) / 1e3
    events = [e for e in net._jit_cache.compile_events()
              if "engine_group" in e["key"]]
    doc = {
        "resume_step": gen, "steps_run": steps_run, "pid": os.getpid(),
        "t_start": T_START, "t_ready": t_ready,
        "t_first_window": first.get("time"), "t_end": t_end,
        "capture_s": t_capture, "fit_s": t_end - t_ready,
        "checkpoint_s": ckpt_s,
        "ms_per_step": (t_end - t_ready) * 1e3 / steps_run,
        "ms_per_step_without_checkpoints":
            ((t_end - t_ready) - ckpt_s) * 1e3 / steps_run,
        "launches_per_step": {n: counts[n] / steps_run for n in pc.LAUNCHES},
        "wgmma_per_step": {n: counts[f"{n}/wgmma"] / steps_run
                           for n in pc.LAUNCHES},
        "captures": prog.group_stats["captures"],
        "captures_in_fit": prog.group_stats["captures"] - captures_before,
        "replays": prog.group_stats["replays"],
        "capture_events": [{k: e[k] for k in ("key", "k", "duration_s")}
                           for e in events],
        "heartbeat": wd.heartbeat.counters,
        "iteration": net.iteration,
        "loss": float(net.score()),
    }
    with open(os.path.join(args.out, f"gen-{gen}.json"), "w") as f:
        json.dump(doc, f)
    np.savez(os.path.join(args.out, "final.npz"),
             *[t.detach().float().cpu().numpy()
               for t in leaves(net._train_carry())],
             iteration=np.asarray(net.iteration))
    wd.heartbeat.mark("done")


if __name__ == "__main__":
    main()
