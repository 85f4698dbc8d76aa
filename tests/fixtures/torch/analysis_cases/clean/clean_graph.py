"""The false-positive guard of the port's jit pass: a key from shapes
only, a captured body with no host op, a clone before the next replay,
and a hot path whose one deliberate read carries its pragma — the
analyzer must report NOTHING here."""

import torch


class StepProgram:
    def group_key(self, net, xs):
        return ("engine_group", tuple(xs.shape[1:]), str(xs.dtype))

    def _group_body(self, carry, xs, scalars):
        out = carry
        for i in range(xs.shape[0]):
            out = out * scalars[i] + torch.clamp_min(xs[i], 0).sum()
        return out


class Runner:
    def run(self, grp, xs, ys):
        first = grp.out.clone()
        grp.replay(xs)
        second = grp.out
        return first + second


def fit(net, xs):
    loss = net.step(xs)
    # analyze: allow=jit-host-sync — the fixture's sanctioned read
    return loss.cpu()
