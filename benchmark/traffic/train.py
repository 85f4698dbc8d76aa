"""Training traffic: `TrainingMaster.fit(batch_fn, n, start_step=...)`
with the input pipeline on and no checkpoint, over a pool of distinct
seeded host batches, as a user trains from host data.

Parameters (workloads/<cell>.json `params`):
  batch              rows per step
  pool_batches       distinct host batches; batch_fn(step) is
                     pool[step % pool_batches]
  steps_per_dispatch TrainingMaster's k (one captured group per k steps)
  steps_per_call     steps of each fit() call in the window (whole groups)

Set-up builds one TrainingMaster over the program's net with the
benchmark's weights and drives its first steps through the window's own
call and feed: `fit(batch_fn, 1)` (step 0 alone, so the optimizer's
state after one step can be read), then `fit(batch_fn, 1 + k,
start_step=1)`, which captures the k-step group the window replays. The
window then calls fit in `steps_per_call` chunks until `--seconds` have
passed, and ends at a synchronize. After it (and a traced sub-window of
one more call under --trace 1) the program is freed and the float32
reference follows the checked steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import time

from reference import net as refnet
from yardstick import checks, program, trace, weights

END_TO_END = ("train_img_per_s", "setup_s")


def make_pool(ctx, batch: int, n: int):
    """n distinct host batches (x [batch, H, W, C], y one-hot), made on
    the card from the seed and copied to host memory."""
    dev = ctx.device
    gen = weights.generator(ctx.seed, dev, 2)
    shape = ctx.cfg["input_shape"]
    x = weights.images(gen, batch * n, shape, dev).cpu().numpy()
    y = weights.labels(gen, batch * n, ctx.cfg["num_classes"],
                       dev).cpu().numpy()
    return [(x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch])
            for i in range(n)]


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx):
    import torch
    from deeplearning4j_tpu_torch.nn.helpers import pallas_conv
    from deeplearning4j_tpu_torch.parallel.training_master import (
        TrainingMaster,
    )

    p, cfg, dev = ctx.wl["params"], ctx.cfg, ctx.device
    batch, k = p["batch"], p["steps_per_dispatch"]
    lr = cfg["program"]["learning_rate"]
    checked = 1 + k
    params, states = weights.make(ctx.nodes, ctx.seed, dev, ctx.small_gamma)
    pool = make_pool(ctx, batch, p["pool_batches"])
    net = program.build(cfg, dev)
    program.load(net, params, states)
    ctx.hooks.get("built", lambda net: None)(net)
    tm = TrainingMaster(net, steps_per_dispatch=k)

    def batch_fn(step):
        return pool[step % len(pool)]

    tm.fit(batch_fn, 1, start_step=0)
    losses = [float(net.score())]
    upd = net.updater_states
    grad = program.leaf_norms({kk: v["v"] for kk, v in upd.items()
                               if isinstance(v, dict) and "v" in v},
                              minus=None, scale=1.0 / lr)
    tm.fit(batch_fn, checked, start_step=1)
    losses += group_losses(tm, net, k)
    prog = {"losses": losses, "grad": grad,
            "change": program.leaf_norms(net.params, minus=params),
            "stats": program.leaf_norms(net.states, minus=states)}
    del params, states, upd
    _sync(torch, dev)
    setup_s = time.perf_counter() - ctx.t_start

    step, steps = checked, 0
    per_call = p["steps_per_call"]
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while True:
        tm.fit(batch_fn, step + per_call, start_step=step)
        step += per_call
        steps += per_call
        if time.perf_counter() >= deadline:
            break
    _sync(torch, dev)
    window_s = time.perf_counter() - t0
    run = {"kind": "train", "nodes": ctx.nodes, "params": p,
           "window": {"seconds": window_s, "steps": steps,
                      "images": steps * batch}}
    if ctx.trace:
        pallas_conv.reset_launch_counts()
        _, summary = trace.profile(
            lambda: tm.fit(batch_fn, step + per_call, start_step=step))
        summary.update(steps=per_call, images=per_call * batch,
                       launches=pallas_conv.launch_counts(),
                       pipeline=tm.training_stats().get("pipeline"))
        run["trace"] = summary
    peak = (torch.cuda.max_memory_reserved(dev) if dev.type == "cuda"
            else 0)
    del tm, net
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(ctx, pool[:checked])
    numbers, notes = checks.training_numbers(prog, ref)
    return {"setup_s": setup_s,
            "end_to_end": {"train_img_per_s": steps * batch / window_s},
            "attempted": steps, "failed": 0, "numbers": numbers,
            "notes": dict(notes, losses=losses, ref_losses=ref["losses"],
                          reference_s=ref["seconds"],
                          reference_peak_bytes=ref["peak_bytes"]),
            "memory_peak_bytes": peak, "run": run}


def group_losses(tm, net, k: int) -> list:
    """The losses of the checked group's k steps. TrainingMaster has no
    public accessor for a group's per-step losses (PERF.md, Open
    questions): they are read where its step program keeps them; where
    it no longer does, the group's last loss is the public `net.score()`
    and the others are None, which the comparison names as missing."""
    program = getattr(getattr(tm, "_harness", None), "program", None)
    inner = getattr(program, "last_step_losses", None)
    if inner is not None and len(inner) == k:
        return [float(v) for v in inner]
    return [None] * (k - 1) + [float(net.score())]


def reference_steps(ctx, batches, quant=None, rows=None):
    """The float32 reference (or, with `quant`, the control) over the
    first `rows` rows (all by default) of `batches`, from the benchmark's
    weights made again from the seed: nothing of the program's is read."""
    import torch

    dev = ctx.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with weights.exact_float32():
        params, states = weights.make(ctx.nodes, ctx.seed, dev,
                                      ctx.small_gamma)
        xs = [(torch.from_numpy(x[:rows]).to(dev),
               torch.from_numpy(y[:rows]).to(dev)) for x, y in batches]
        out = refnet.train_steps(
            ctx.nodes, params, states, xs,
            lr=ctx.cfg["program"]["learning_rate"],
            momentum=ctx.cfg["momentum"], quant=quant)
    out["seconds"] = time.perf_counter() - t0
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    return out
