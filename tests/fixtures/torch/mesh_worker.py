"""One rank of the port's tensor- and sequence-parallel gangs: the
scenarios of tests/test_torch_tp.py (a 4-rank gang: dp 2 x tp 2) and
tests/test_torch_ring_attention.py (an 8-rank gang: sp 8, dp 2 x sp 4),
run in sequence over one gloo process group on the CPU (or, with
--device cuda, with CUDA tensors on one card).

    python mesh_worker.py --rank R --world W --port P --io DIR
        [--device cpu|cuda] [--only NAME,NAME]

DIR holds what scaleout_worker.py's `Gang` reads (`spec.json`,
`nets.npz`, `data.npz`); each rank writes `DIR/out-<R>.npz` and
`DIR/out-<R>.json`. It imports only the port (deeplearning4j_tpu_torch),
never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from scaleout_worker import Gang  # noqa: E402

from deeplearning4j_tpu_torch.earlystopping import (  # noqa: E402
    EarlyStoppingConfiguration,
    EarlyStoppingParallelTrainer,
    MaxEpochsTerminationCondition,
)
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    LocalStepTrainer,
    ParallelWrapper,
    StaleGradientTrainer,
    TrainingMaster,
    collectives,
    gather_params,
    make_mesh,
    ring_self_attention,
    shard_params,
)
from deeplearning4j_tpu_torch.util.tree import leaves  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(worker, io, world, extra=(), timeout=240):
    """One gang of `world` ranks of `worker` (a script taking --rank
    --world --port --io) over `io`, each rank's output in
    io/log-<world>-<r>.txt; raises with every rank's log when any rank
    fails. The ranks import only the port: JAX_PLATFORMS is dropped from
    their environment."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.dirname(
        HERE)))
    env.pop("JAX_PLATFORMS", None)
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(io, f"log-{world}-{r}.txt"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, worker, "--rank", str(r), "--world",
             str(world), "--port", str(port), "--io", io, *extra],
            stdout=log, stderr=subprocess.STDOUT, env=env))
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(rcs):
        text = "".join(open(os.path.join(io, f"log-{world}-{r}.txt")).read()
                       for r in range(world))
        raise AssertionError(f"gang of {world} failed {rcs}:\n{text}")


def _error(fn):
    """The (type name, message) `fn` raised, or None."""
    try:
        fn()
    except Exception as e:   # noqa: BLE001 - recorded for the test
        return [type(e).__name__, str(e)]
    return None


# ------------------------------------------------------------- the mesh
def mesh(g):
    """Coordinates, axis groups and one ppermute hop of each mesh this
    world can make, and make_mesh's errors at this world."""
    w = g.world
    shapes = ([dict(dp=2, tp=2), dict(dp=-1, tp=2), dict(tp=-1)]
              if w == 4 else [dict(sp=8), dict(dp=2, sp=4), dict(dp=-1,
                                                                 tp=2)])
    out = []
    for kw in shapes:
        m = make_mesh(**kw)
        rec = {"kw": kw, "shape": m.shape, "coords": m.coords,
               "groups": {a: list(m.group(a).ranks) for a in m.shape}}
        for a, n in m.shape.items():
            if n > 1:
                got = collectives.ppermute(
                    torch.tensor([float(g.rank)], device=g.device),
                    m.group(a))
                rec.setdefault("hop", {})[a] = float(got[0])
        out.append(rec)
    if w == 4:
        # shard_params / gather_params round trip on a dp 2 x tp 2 mesh
        m = make_mesh(dp=2, tp=2)
        tree = {"W": torch.arange(48.0).reshape(8, 6),
                "lead": torch.arange(42.0).reshape(6, 7),
                "v": torch.arange(32.0), "small": torch.arange(6.0),
                "odd": torch.arange(21.0).reshape(7, 3)}
        mine = shard_params(m, tree)
        back = gather_params(m, mine, tree)
        g.put("mesh", "slices", leaves(mine))
        g.facts["roundtrip"] = all(torch.equal(a, b) for a, b in zip(
            leaves(back), leaves(tree)))
    g.facts["mesh"] = {"meshes": out, "errors": {
        "too_many": _error(lambda: make_mesh(dp=w, tp=2)),
        "too_few": _error(lambda: make_mesh(dp=1)),
        "wild2": _error(lambda: make_mesh(dp=-1, tp=-1)),
        "indivisible": _error(lambda: make_mesh(dp=-1, tp=3)),
    }}


# -------------------------------------------------------- tensor parallel
class _Shapes:
    """A listener recording, at its first call inside fit, the shapes of
    the params and updater state this rank holds and the plan's memory
    facts."""

    def __init__(self):
        self.seen = None

    def iteration_done(self, net, iteration):
        if self.seen is None:
            self.seen = {
                "params": [list(t.shape) for t in leaves(net.params)],
                "upd": [list(t.shape) for t in leaves(net.updater_states)],
                "memory": net._tp.memory_facts(),
                "flat_chain": net._flat_chain is not None}


def _tp_fit(g, scen, name, batches, **kw):
    net = g.net(name)
    rec = _Shapes()
    net.listeners = [rec]
    pw = ParallelWrapper(net, tp=2, **kw)
    pw.fit(batches)
    g.keep(scen, net, states=True)
    g.facts[scen].update(rec.seen)
    g.facts[scen]["mesh"] = pw.mesh.shape
    g.facts[scen]["whole_after"] = [list(t.shape)
                                    for t in leaves(net.params)]
    g.facts[scen]["tp_memory"] = pw.tp_memory


def tp_mlp(g):
    """tests/test_parallel.py's tp fit: dp 2 x tp 2, three steps of one
    64-row batch."""
    _tp_fit(g, "tp_mlp", "mlp8", [(g.d("mlp_x"), g.d("mlp_y"))] * 3)


def tp_adam(g):
    """Adam under dp 2 x tp 2: the updater state sliced like its params
    and updated on the slices."""
    _tp_fit(g, "tp_adam", "adam24",
            [(g.d("z_x")[s], g.d("z_y")[s]) for s in range(3)])


def tp_conv(g):
    """The conv + BatchNorm net under dp 2 x tp 2: a conv kernel sharded
    on its trailing dim and an output W on its leading dim, both gathered
    on use."""
    _tp_fit(g, "tp_conv", "conv", [(g.d("conv_x"), g.d("conv_y"))] * 3)


def tp_k2(g):
    """steps_per_dispatch=2 under tp: the k-window body on slices."""
    _tp_fit(g, "tp_k2", "mlp8", [(g.d("mlp_x"), g.d("mlp_y"))] * 3,
            steps_per_dispatch=2)


def tp_early(g):
    """EarlyStoppingParallelTrainer(tp=2): two epochs of two batches."""
    net = g.net("mlp8")
    x, y = g.d("mlp_x"), g.d("mlp_y")
    conf = (EarlyStoppingConfiguration.Builder()
            .epoch_termination_conditions(MaxEpochsTerminationCondition(2))
            .build())
    tr = EarlyStoppingParallelTrainer(conf, net, [(x[:32], y[:32]),
                                                  (x[32:], y[32:])], tp=2)
    tr.fit()
    g.keep("tp_early", net)
    g.facts["tp_early"]["mesh"] = tr.wrapper.mesh.shape


def tp_refusals(g):
    """The refusals under tp 2, as the JAX package raises them."""
    batches = [(g.d("mlp_x"), g.d("mlp_y"))] * 2
    tpm = make_mesh(dp=2, tp=2)
    g.facts["tp_refusals"] = {
        "zero1": _error(lambda: ParallelWrapper(g.net("mlp8"), tp=2,
                                                sharding="zero1")),
        "local_sgd": _error(lambda: ParallelWrapper(
            g.net("mlp8"), tp=2, averaging_frequency=2).fit(batches)),
        "local_step": _error(lambda: LocalStepTrainer(g.net("mlp8"), tpm)),
        "stale": _error(lambda: StaleGradientTrainer(g.net("mlp8"), tpm)),
        "training_master": _error(lambda: TrainingMaster(g.net("mlp8"),
                                                         mesh=tpm)),
    }


# ------------------------------------------------------- ring attention
RING_CASES = [("sp8", dict(sp=8)), ("dp2sp4", dict(dp=2, sp=4))]


def ring(g):
    """ring_self_attention over every mesh of RING_CASES, causal and not:
    each rank's global output."""
    q, k, v = (torch.from_numpy(g.d(f"ring_{n}")).to(g.device)
               for n in "qkv")
    for name, kw in RING_CASES:
        m = make_mesh(**kw)
        for causal in (False, True):
            out = ring_self_attention(q, k, v, m, causal=causal)
            g.put("ring", f"{name}_{'causal' if causal else 'full'}", [out])
    m = make_mesh(sp=8)
    g.facts["ring"] = {
        "indivisible": _error(lambda: ring_self_attention(
            q[:, :30], k[:, :30], v[:, :30], m)),
        "no_axis": _error(lambda: ring_self_attention(q, k, v, m,
                                                      axis_name="xx")),
        "ppermutes": collectives.COUNTS["ppermute"]}


def ring_sp2(g):
    """ring_self_attention over make_mesh(sp=2) (a 2-rank gang), causal
    and not (tests/test_torch_cuda.py: on the card against the CPU)."""
    q, k, v = (torch.from_numpy(g.d(f"ring_{n}")).to(g.device)
               for n in "qkv")
    m = make_mesh(sp=2)
    for causal in (False, True):
        out = ring_self_attention(q, k, v, m, causal=causal)
        g.put("ring_sp2", "causal" if causal else "full", [out])


SCENARIOS = {f.__name__: f for f in (mesh, tp_mlp, tp_adam, tp_conv, tp_k2,
                                     tp_early, tp_refusals, ring, ring_sp2)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--io", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--only", default="")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names = [n for n in a.only.split(",") if n] or list(SCENARIOS)
    TrainingMaster.initialize_distributed(
        f"127.0.0.1:{a.port}", a.world, a.rank, backend="gloo",
        device=a.device)
    g = Gang(a.io, a.rank, a.world, a.device)
    failed = {}
    try:
        for n in names:
            print(f"rank {a.rank}: {n}", flush=True)
            try:
                SCENARIOS[n](g)
            except Exception:   # noqa: BLE001 - reported to the test
                failed[n] = traceback.format_exc()
                raise
    finally:
        g.facts["_failed"] = failed
        np.savez(os.path.join(a.io, f"out-{a.rank}.npz"), **g.arrays)
        with open(os.path.join(a.io, f"out-{a.rank}.json"), "w") as f:
            json.dump(g.facts, f)
        collectives.destroy_process_group()


if __name__ == "__main__":
    main()
