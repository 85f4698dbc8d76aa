"""One rank of the port's scale-out gang: the multi-rank scenarios of
tests/test_torch_scaleout_gang.py, run in sequence over one gloo process
group on the CPU (or, with --device cuda, with CUDA tensors on one card).

    python scaleout_worker.py --rank R --world W --port P --io DIR
        [--device cpu|cuda] [--backend gloo|nccl] [--only NAME,NAME]

With `--backend nccl` each rank drives its own card (cuda:R).

DIR holds `spec.json` (the nets' configurations), `nets.npz` (their
initial params and states as leaves, `<net>/p:i`, `<net>/s:i`) and
`data.npz` (the scenarios' batches). Each rank writes
`DIR/out-<R>.npz` (`<scenario>/<field>:i` arrays) and
`DIR/out-<R>.json` (scalars: scores, wire stats, file lists). It imports
only the port (deeplearning4j_tpu_torch), never JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from deeplearning4j_tpu_torch.nn.conf.graph_conf import (  # noqa: E402
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.network import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    ParallelWrapper,
    StaleGradientTrainer,
    TrainingMaster,
    collectives,
    make_mesh,
)
from deeplearning4j_tpu_torch.util.tree import leaves, unflatten  # noqa: E402


class Gang:
    """The rank's inputs and outputs (module docstring)."""

    def __init__(self, io, rank, world, device):
        self.io, self.rank, self.world, self.device = io, rank, world, device
        with open(os.path.join(io, "spec.json")) as f:
            self.spec = json.load(f)
        self.nets = np.load(os.path.join(io, "nets.npz"))
        self.data = np.load(os.path.join(io, "data.npz"))
        self.arrays = {}
        self.facts = {}

    def net(self, name):
        """A fresh port net `name`: the configuration through JSON, the
        JAX-initialized params and states through their leaves."""
        kind, conf_json = self.spec["nets"][name]
        if kind == "graph":
            net = ComputationGraph(
                ComputationGraphConfiguration.from_json(conf_json),
                device=self.device)
            net.conf.helper_mode = self.spec["helpers"].get(name, "none")
        else:
            net = MultiLayerNetwork(
                MultiLayerConfiguration.from_json(conf_json),
                device=self.device)
        net.init()
        tens = lambda prefix, like: unflatten(like, [
            torch.from_numpy(np.array(self.nets[f"{name}/{prefix}:{i}"])).to(
                device=t.device, dtype=t.dtype)
            for i, t in enumerate(leaves(like))])[0]
        net.params = tens("p", net.params)
        net.states = tens("s", net.states)
        return net

    def d(self, key):
        return np.array(self.data[key])

    def part(self, key_x, key_y):
        """batch_fn(step): this rank's contiguous rows of global batch
        `step` (TrainingMaster's per-process partition)."""
        xs, ys = self.d(key_x), self.d(key_y)
        per = xs.shape[1] // self.world
        lo, hi = self.rank * per, (self.rank + 1) * per
        return lambda s: (xs[s, lo:hi], ys[s, lo:hi])

    def keep(self, scen, net, upd=True, states=False, mgr=None):
        self.put(scen, "params", leaves(net._params_view()))
        if upd:
            u = net.updater_states
            if mgr is not None:
                u = mgr.gather_tree(u)
            self.put(scen, "upd", leaves(u))
        if states:
            self.put(scen, "states", leaves(net.states))
        self.facts.setdefault(scen, {})["score"] = float(net.score())
        self.facts[scen]["iteration"] = int(net.iteration)

    def put(self, scen, field, arrays):
        for i, a in enumerate(arrays):
            self.arrays[f"{scen}/{field}:{i}"] = (
                a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    def ckpt(self, name):
        return os.path.join(self.io, "ckpt", name)

    def steps(self, scen, default):
        """A scenario's step count (`spec["steps"]` overrides)."""
        return int(self.spec.get("steps", {}).get(scen, default))


# ------------------------------------------------------------ scenarios
def barrier():
    """Every rank past this point (a rank reads the files others wrote)."""
    collectives.all_reduce_sum(torch.zeros(1))


def dp_conv(g):
    """(i) per-step dp, BatchNorm over two differing halves."""
    net = g.net("conv")
    ParallelWrapper(net).fit([(g.d("conv_x"), g.d("conv_y"))]
                             * g.steps("dp_conv", 3))
    g.keep("dp_conv", net, upd=False, states=True)


def dp_mlp(g):
    net = g.net("mlp8")
    ParallelWrapper(net).fit([(g.d("mlp_x"), g.d("mlp_y"))] * 5)
    g.keep("dp_mlp", net, upd=False)


def dp_ragged(g):
    net = g.net("mlp8")
    ParallelWrapper(net).fit([(g.d("rag_x"), g.d("rag_y"))])
    g.keep("dp_ragged", net, upd=False)


def dp_fused(g):
    """Per-step dp through the fused tier's kernel-epilogue statistics."""
    net = g.net("mini")
    ParallelWrapper(net).fit([(g.d("mini_x"), g.d("mini_y"))] * 2)
    g.keep("dp_fused", net, upd=False, states=True)


def lsgd(g):
    """(ii) local SGD, k=2."""
    net = g.net("mlp8")
    xs, ys = g.d("lsgd_x"), g.d("lsgd_y")
    ParallelWrapper(net, averaging_frequency=2).fit(
        [(xs[i], ys[i]) for i in range(len(xs))])
    g.keep("lsgd", net, upd=False)


def thr_res(g):
    """(iii) threshold compression: an unreachable threshold."""
    net = g.net("mlp8")
    xs, ys = g.d("thr1_x"), g.d("thr1_y")
    pw = ParallelWrapper(net, averaging_frequency=2,
                         threshold_compression=1e9)
    pw.fit([(xs[i], ys[i]) for i in range(len(xs))])
    g.keep("thr_res", net, upd=False)
    res = leaves(pw._local_step._residual)
    g.facts["thr_res"]["residual_max"] = max(
        float(r.abs().max()) for r in res)
    g.facts["thr_res"]["wire"] = pw._local_step.wire_stats()


def thr_wire(g):
    net = g.net("mlp8")
    xs, ys = g.d("thrw_x"), g.d("thrw_y")
    pw = ParallelWrapper(net, averaging_frequency=4,
                         threshold_compression=3e-2)
    pw.fit([(xs[i], ys[i]) for i in range(len(xs))])
    g.keep("thr_wire", net, upd=False)
    g.facts["thr_wire"]["wire"] = pw._local_step.wire_stats()


def stale(g):
    """(iv) the stale-gradient trainer."""
    net = g.net("mlp8")
    xs, ys = g.d("stale_x"), g.d("stale_y")
    StaleGradientTrainer(net, make_mesh(dp=g.world)).fit(
        [(xs[i], ys[i]) for i in range(len(xs))])
    g.keep("stale", net, upd=False)


def stale_first(g):
    net = g.net("mlp8")
    tr = StaleGradientTrainer(net, make_mesh(dp=g.world))
    x, y = g.d("st1_x"), g.d("st1_y")
    per = x.shape[0] // g.world
    lo = g.rank * per
    tr.step(x[lo:lo + per], y[lo:lo + per])
    g.put("stale_first", "after_step", leaves(net.params))
    tr.flush()
    g.put("stale_first", "after_flush", leaves(net.params))
    g.facts["stale_first"] = {}


def stale_bn(g):
    net = g.net("bnmlp")
    xs, ys = g.d("stbn_x"), g.d("stbn_y")
    StaleGradientTrainer(net, make_mesh(dp=g.world)).fit(
        [(xs[i], ys[i]) for i in range(len(xs))])
    g.keep("stale_bn", net, upd=False, states=True)


def _tm(g, scen, steps, **kw):
    net = g.net("adam24")
    tm = TrainingMaster(net, **kw)
    tm.fit(g.part("z_x", "z_y"), steps)
    g.keep(scen, net, mgr=tm._mesh_mgr)
    return net, tm


def zero1(g):
    """(v) ZeRO-1 against the unsharded run."""
    _, tm = _tm(g, "z1", g.steps("z1", 6), sharding="zero1")
    mgr = tm._mesh_mgr
    g.facts["z1"]["memory"] = mgr.memory_facts(tm.net.updater_states)
    g.facts["z1"]["layout"] = list(mgr.layout)
    _tm(g, "dp_tm", g.steps("z1", 6))


def group_facts(g, scen, program):
    """The captured groups of `program` (none on the CPU): per k, the
    collectives one replay holds; then one eager collective after the
    replays, waited for on the device."""
    facts = g.facts.setdefault(scen, {})
    facts["collectives"] = {
        str(key[1]): c for key, c in program.group_collectives().items()}
    facts["replays"] = program.group_stats["replays"]
    t = collectives.all_reduce_sum(
        torch.ones(1, device=g.device) * (g.rank + 1))
    facts["eager_after"] = float(t.cpu()[0])


def zero1_groups(g):
    """(v) ZeRO-1 k=4 groups against k=1 (over NCCL the k=4 groups are
    captured; a gloo group's collectives cannot be captured on a card, so
    on gloo they run on the CPU)."""
    _tm(g, "z1_k1", 8, sharding="zero1")
    _, tm = _tm(g, "z1_k4", 8, sharding="zero1", steps_per_dispatch=4)
    group_facts(g, "z1_k4", tm._harness.program)


def dp_groups(g):
    """Per-step dp k=4 windows against k=1: ParallelWrapper over the conv
    + BatchNorm net, the gradient all-reduce and the global BatchNorm sums
    (`dp_sum`) inside each group."""
    data = [(g.d("conv_x"), g.d("conv_y"))] * 8
    net = g.net("conv")
    ParallelWrapper(net).fit(data)
    g.keep("dp_k1", net, upd=False, states=True)
    net = g.net("conv")
    pw = ParallelWrapper(net, steps_per_dispatch=4)
    pw.fit(data)
    g.keep("dp_k4", net, upd=False, states=True)
    group_facts(g, "dp_k4", pw._harness.program)


def tp_groups(g):
    """tp 2 (dp = world / 2) k=4 windows against k=1: ParallelWrapper's
    column-parallel Dense and Output layers, their gathers and the dp
    all-reduce inside each group."""
    xs, ys = g.d("z_x"), g.d("z_y")
    data = [(xs[s], ys[s]) for s in range(8)]
    net = g.net("adam24")
    ParallelWrapper(net, tp=2).fit(data)
    g.keep("tp_k1", net, upd=False)
    net = g.net("adam24")
    pw = ParallelWrapper(net, tp=2, steps_per_dispatch=4)
    pw.fit(data)
    g.keep("tp_k4", net, upd=False)
    group_facts(g, "tp_k4", pw._harness.program)


def zero1_group(g):
    """engine/sharding.py build_zero1_group(k=4) driven by hand over two
    4-step windows ("zg_group"), and run_group(4) twice through a second
    StepProgram of the net another program meshed ("zg_other"), against
    8 calls of build_zero1_step from the same state ("zg_step"), on this
    rank's rows of the z batches."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.engine.mesh import MeshManager
    from deeplearning4j_tpu_torch.engine.sharding import (
        build_zero1_group,
        build_zero1_step,
    )

    xs, ys = g.d("z_x"), g.d("z_y")
    per = xs.shape[1] // g.world
    lo = g.rank * per
    for scen in ("zg_step", "zg_group", "zg_other"):
        net = g.net("adam24")
        mgr = MeshManager()
        StepProgram(net).attach_mesh(mgr)
        if scen == "zg_other":
            other = StepProgram(net)
            for lo_s in (0, 4):
                other.run_group(xs[lo_s:lo_s + 4, lo:lo + per],
                                ys[lo_s:lo_s + 4, lo:lo + per])
            g.put(scen, "params", leaves(net._params_view()))
            g.put(scen, "upd", leaves(mgr.gather_tree(net.updater_states)))
            continue
        x, y, fm, lm = net._batch_tensors(xs[:8, lo:lo + per],
                                          ys[:8, lo:lo + per])
        carry = net._train_carry()
        scalars = net._step_scalars(0, 8)
        if scen == "zg_step":
            step, losses = build_zero1_step(net, mgr), []
            for i in range(8):
                carry, loss, _ = step(carry, x[i], y[i], None, scalars[i])
                losses.append(loss)
            losses = torch.stack(losses)
        else:
            group = build_zero1_group(net, mgr, 4)
            parts = []
            for lo_s in (0, 4):
                at = slice(lo_s, lo_s + 4)
                carry, ls = group(carry, x[at], y[at], None, scalars[at])
                parts.append(ls)
            losses = torch.cat(parts)
        net._set_train_carry(carry)
        g.put(scen, "params", leaves(net._params_view()))
        g.put(scen, "upd", leaves(mgr.gather_tree(net.updater_states)))
        g.put(scen, "losses", [losses])
    g.facts["zero1_group"] = {"world": g.world}


def zero1_ckpt(g):
    """(v) checkpoint round trip with retention: 6 steps saved every 2
    (keep 2), a fresh master resumes to 8."""
    d = g.ckpt("z1_rt")
    _tm(g, "z1_rt_a", 6, sharding="zero1", checkpoint_dir=d,
        checkpoint_every=2, keep_last=2, per_rank_checkpoints=True)
    barrier()
    _tm(g, "z1_rt", 8, sharding="zero1", checkpoint_dir=d,
        checkpoint_every=2, keep_last=2, per_rank_checkpoints=True)
    g.facts["z1_rt"]["files"] = sorted(os.listdir(
        os.path.join(d, f"rank-{g.rank}")))


def zero1_save(g):
    """(vi) a sharded save for the cross-package checks: 4 steps, saved
    at step 4."""
    _tm(g, "z1_save", 4, sharding="zero1", checkpoint_dir=g.ckpt("z1_save"),
        checkpoint_every=4, per_rank_checkpoints=True)


def zero1_resume3(g):
    """The reshard on resume from a larger world: steps 0-3 were saved by
    a 3-rank gang; this gang resumes them and trains to 8."""
    d = os.path.join(g.io, "ckpt3")
    net, tm = _tm(g, "z1_resume3", 8, sharding="zero1", checkpoint_dir=d,
                  checkpoint_every=4, per_rank_checkpoints=True)
    g.facts["z1_resume3"]["reshards"] = tm._mesh_mgr.reshards


def zero1_save3(g):
    """The 3-rank gang's part: 4 steps, saved at step 4."""
    _tm(g, "z1_save3", 4, sharding="zero1",
        checkpoint_dir=os.path.join(g.io, "ckpt3"), checkpoint_every=4,
        per_rank_checkpoints=True)


def dist(g):
    """(vii) two-process training against serial, and a stop after 4
    steps resumed by a fresh master against the uninterrupted run."""
    part = g.part("dist_x", "dist_y")
    net = g.net("dist")
    tm = TrainingMaster(net)
    tm.fit(part, 6)
    g.keep("dist", net)
    # the distributed evaluate: every rank ends with the global counts
    g.facts["dist"]["confusion"] = \
        tm.evaluate(part, 6).confusion.matrix.tolist()
    ref = g.net("dist")
    TrainingMaster(ref, checkpoint_dir=g.ckpt("dist_ref"),
                   checkpoint_every=2).fit(part, 6)
    g.keep("dist_ref", ref)
    d = g.ckpt("dist_kill")
    TrainingMaster(g.net("dist"), checkpoint_dir=d,
                   checkpoint_every=2).fit(part, 4)
    barrier()
    resumed = g.net("dist")
    tm = TrainingMaster(resumed, checkpoint_dir=d, checkpoint_every=2)
    start = tm.load_latest_checkpoint()
    tm.fit(part, 6, start_step=start)
    g.keep("dist_kill", resumed)
    g.facts["dist_kill"]["resumed_from"] = start


SCENARIOS = {f.__name__: f for f in (
    dp_conv, dp_mlp, dp_ragged, dp_fused, lsgd, thr_res, thr_wire, stale,
    stale_first, stale_bn, zero1, zero1_groups, zero1_ckpt, zero1_save,
    zero1_resume3, dist, zero1_save3, dp_groups, tp_groups, zero1_group)}
# run only when named in --only
OPT_IN = ("zero1_save3", "dp_groups", "tp_groups", "zero1_group")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--io", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--only", default="")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    # the card's cuDNN convolutions in full f32, as the CPU computes them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names = [n for n in a.only.split(",") if n] or [
        n for n in SCENARIOS if n not in OPT_IN]
    device = f"cuda:{a.rank}" if a.backend == "nccl" else a.device
    TrainingMaster.initialize_distributed(
        f"127.0.0.1:{a.port}", a.world, a.rank, backend=a.backend,
        device=device)
    print(f"rank {a.rank}: joined a {a.backend} group of {a.world}",
          flush=True)
    g = Gang(a.io, a.rank, a.world, device)
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
