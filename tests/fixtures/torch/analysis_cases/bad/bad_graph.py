"""Known host-sync and CUDA-graph violations of the port's analyzer
(true-positive fixtures; parsed only, never imported).

- `StepProgram.group_key` builds a group key from `net.iteration`
  -> graph-per-call-key (line 21)
- `StepProgram._group_body` (a capture root) builds a host tensor and
  sizes a result from the data -> graph-uncapturable-op (lines 26, 27),
  and its helper `_scale` reads a value back -> graph-uncapturable-op
  (line 33)
- `Runner.run` reads the static output after the next replay
  -> graph-read-after-replay (line 41)
- `fit` (a hot root) syncs four ways -> jit-host-sync (lines 46-49)
"""

import torch


class StepProgram:
    def group_key(self, net, xs):
        shapes = tuple(xs.shape[1:])
        return ("engine_group", shapes, net.iteration)

    def _group_body(self, carry, xs):
        out = carry
        for i in range(xs.shape[0]):
            scale = torch.tensor([2.0])
            live = xs[i].nonzero()
            out = _scale(out, scale) + live.sum()
        return out


def _scale(t, s):
    return t * s.item()


class Runner:
    def run(self, grp, xs, ys):
        first = grp.out
        grp.replay(xs)
        grp.replay(ys)
        return first + 1


def fit(net, xs):
    loss = net.step(xs)
    host = loss.cpu()
    arr = xs.numpy()
    torch.cuda.synchronize()
    top = int(loss.max())
    return host, arr, top


def cold_helper(xs):
    # NOT reachable from any root: must not be flagged
    return xs.cpu()
