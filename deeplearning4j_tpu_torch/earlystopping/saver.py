"""Model savers (counterpart of deeplearning4j_tpu/earlystopping/saver.py;
parity: earlystopping/saver/InMemoryModelSaver.java,
LocalFileModelSaver.java, LocalFileGraphSaver.java)."""

from __future__ import annotations

import os

from deeplearning4j_tpu_torch.util.tree import clone


class InMemoryModelSaver:
    """Device copies of the best/latest params and BN states. Reads the
    params without dropping the net's flat train carry."""

    def __init__(self):
        self._best = None
        self._latest = None

    @staticmethod
    def _snap(net, score):
        return (clone(net._params_view()), clone(net.states), score)

    def save_best_model(self, net, score):
        self._best = self._snap(net, score)

    def save_latest_model(self, net, score):
        self._latest = self._snap(net, score)

    @staticmethod
    def _get(saved, like_net):
        if saved is None:
            return None
        if like_net is not None:
            like_net.params, like_net.states = clone(saved[0]), \
                clone(saved[1])
            return like_net
        return saved

    def get_best_model(self, like_net=None):
        return self._get(self._best, like_net)

    def get_latest_model(self, like_net=None):
        return self._get(self._latest, like_net)


class LocalFileModelSaver:
    """Zip-based best/latest checkpoints in a directory.

    Writes ride util/model_serializer.write_model's crash-safe path (tmp
    + fsync + os.replace, sha256 sidecar), so a kill mid-save never
    clobbers the previous best/latest model; loads go through
    `restore_model` (a graph or a layer list), which surfaces a torn file as
    CheckpointIntegrityError instead of silently restoring garbage. A
    model loads on `like_net`'s device and compute dtype when one is
    given (else on the port's default device)."""

    def __init__(self, directory):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag):
        return os.path.join(self.directory, f"{tag}Model.zip")

    def save_best_model(self, net, score):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(net, self._path("best"))

    def save_latest_model(self, net, score):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(net, self._path("latest"))

    def _load(self, tag, like_net):
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model,
        )
        p = self._path(tag)
        if not os.path.exists(p):
            return None
        kw = {}
        if like_net is not None:
            kw = {"device": like_net.device,
                  "compute_dtype": like_net.compute_dtype}
        return restore_model(p, **kw)

    def get_best_model(self, like_net=None):
        return self._load("best", like_net)

    def get_latest_model(self, like_net=None):
        return self._load("latest", like_net)


# graph models serialize identically
LocalFileGraphSaver = LocalFileModelSaver
