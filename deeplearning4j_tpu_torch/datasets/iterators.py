"""DataSet iterators (counterpart of deeplearning4j_tpu/datasets/iterators.py:
DataSetIterator, ListDataSetIterator, AsyncDataSetIterator,
MultipleEpochsIterator, EarlyTerminationDataSetIterator,
BenchmarkDataSetIterator, DevicePrefetchIterator).

AsyncDataSetIterator keeps the host side ahead of the card (a daemon
thread prefetching into a bounded queue); DevicePrefetchIterator stages
the next batches on the card while the current step runs: pinned host
memory, a copy with `non_blocking=True` on a side CUDA stream, and an
event the consumer's stream waits on. The host half of staging
(`host_stage`: dtype conversion and the copy into pinned memory) can run
on the producer thread, so the consumer only issues the copy
(`DeviceStage`, which TrainingMaster and ParallelWrapper also use).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.device import resolve_device


class DataSetIterator:
    """Iterator contract: python-iterable + reset() (+ optional
    total_examples/batch metadata)."""

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        pass

    def has_next(self) -> bool:
        raise NotImplementedError

    # camelCase compatibility
    def hasNext(self):
        return self.has_next()


class ListDataSetIterator(DataSetIterator):
    """Batches over an in-memory list of examples
    (ref: datasets/iterator/impl/ListDataSetIterator.java)."""

    def __init__(self, data: DataSet, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._batches: List[DataSet] = []
        self._pos = 0
        self.reset()

    def reset(self):
        d = self.data
        if self.shuffle:
            idx = np.random.default_rng(
                self.seed + self._epoch).permutation(d.num_examples())
            d = DataSet(d.features[idx],
                        None if d.labels is None else d.labels[idx],
                        None if d.features_mask is None else d.features_mask[idx],
                        None if d.labels_mask is None else d.labels_mask[idx])
        self._batches = d.batch_by(self.batch_size)
        self._pos = 0
        self._epoch += 1

    def has_next(self):
        return self._pos < len(self._batches)

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        b = self._batches[self._pos]
        self._pos += 1
        return b


class HostBatch(tuple):
    """A batch as (features, labels, features_mask, labels_mask) after
    `host_stage`: what DevicePrefetchIterator sends to the device as it
    is."""


def host_stage(item, transform=None, device=None, dtype=torch.float32):
    """The host half of staging a batch for `device`: `transform(item)`,
    a DataSet as its tuple, and for CUDA each array in `dtype` (floating
    arrays only) in pinned memory, in one copy. For the CPU the arrays
    stay as they are. Makes no CUDA stream call, so it may run on any
    thread."""
    if transform is not None:
        item = transform(item)
    if hasattr(item, "features"):  # DataSet
        item = (item.features, item.labels,
                getattr(item, "features_mask", None),
                getattr(item, "labels_mask", None))
    item = tuple(item) if isinstance(item, (tuple, list)) else (item,)
    if device is None or device.type == "cpu":
        return HostBatch(item)
    return HostBatch(None if a is None else _pinned(a, dtype) for a in item)


def _pinned(a, dtype):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(a)))
    dt = dtype if t.is_floating_point() else t.dtype
    if t.device.type != "cpu":
        return t.to(dt)
    if t.dtype == dt and t.is_pinned():
        return t
    out = torch.empty(t.shape, dtype=dt, pin_memory=True)
    return out.copy_(t)


class DeviceStage:
    """The device half of staging: `put(host_batch)` sends each array of
    a HostBatch to `device` with `non_blocking=True` copies on a side
    CUDA stream and records an event after them; `take(entry)` makes the
    current stream wait on that event and calls `record_stream` on every
    staged tensor, so the caching allocator cannot hand a tensor's memory
    to another allocation before the consumer's kernels are done with
    it. The pinned sources stay alive until their copies end (PyTorch's
    pinned-memory allocator records the copy). On the CPU both are
    pass-throughs. One owner thread."""

    def __init__(self, device):
        self.device = device
        self._stream = None

    def put(self, item):
        if self.device.type == "cpu":
            return tuple(item), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            staged = tuple(None if a is None else
                           a.to(self.device, non_blocking=True)
                           for a in item)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return staged, ready

    def take(self, entry):
        staged, ready = entry
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            for t in staged:
                if t is not None:
                    t.record_stream(cur)
        return staged

    def __call__(self, item):
        """`take(put(item))`: the copies run on the side stream, after
        whatever the side stream holds, and the current stream's later
        work waits for them."""
        return self.take(self.put(item))


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch wrapper: a daemon thread keeps a
    bounded queue of upcoming host batches full (ref:
    AsyncDataSetIterator.java:30,36 AsyncPrefetchThread). `prepare(item)
    -> item`, when given, runs on that thread on each item before it is
    queued.

    It calls on `base` exactly what a loop over `base` itself would:
    `reset()` resets the base (and starts nothing), and a pass
    (`__iter__`, or `__next__` with no pass running) starts ONE producer,
    which iterates the base once. So `reset()` then `for b in it` resets
    a shuffled base as often, and yields the same batches in the same
    order, as `reset()` then `for b in base`. Every base call is made
    under a lock and only by the current producer: a superseded producer
    never resets or advances the base again."""

    _SENTINEL = object()

    def __init__(self, base: Iterable, queue_size: int = 4, prepare=None):
        self.base = base
        self.queue_size = queue_size
        self.prepare = prepare
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._gen = 0  # restart generation: stale producers self-terminate
        self._base_lock = threading.Lock()
        self._exhausted = False

    def _start(self):
        self._gen += 1
        gen = self._gen
        q = queue.Queue(maxsize=self.queue_size)
        self._q = q
        self._error = None

        def producer():
            # capture q/gen locally: after a reset() the old thread must
            # never feed (or sentinel-terminate) the new queue
            def put(item) -> bool:
                while self._gen == gen:
                    try:
                        q.put(item, timeout=0.05)
                        return True
                    except queue.Full:
                        continue
                return False  # superseded by a restart

            try:
                with self._base_lock:
                    if self._gen != gen:
                        return
                    it = iter(self.base)
                while True:
                    with self._base_lock:
                        if self._gen != gen:
                            return
                        try:
                            item = next(it)
                        except StopIteration:
                            break
                    if self.prepare is not None:
                        item = self.prepare(item)
                    if not put(item):
                        return
            except BaseException as e:  # surfaced on the consumer side
                if self._gen == gen:
                    self._error = e
            put(self._SENTINEL)

        self._thread = threading.Thread(target=producer, daemon=True,
                                        name="AsyncDataSetIterator-prefetch")
        self._thread.start()

    def __iter__(self):
        self._exhausted = False
        self._start()
        return self

    def reset(self):
        self._gen += 1           # a running producer stops touching base
        self._q = None
        with self._base_lock:
            if hasattr(self.base, "reset"):
                self.base.reset()
        self._exhausted = False

    def __next__(self):
        if self._exhausted:
            # iterator protocol: an exhausted iterator keeps raising
            # StopIteration until __iter__/reset explicitly starts a
            # new pass (restarting here silently fed wrapping
            # pipelines a second epoch)
            raise StopIteration
        if self._q is None:
            self._start()
        item = self._q.get()
        if item is self._SENTINEL:
            self._q = None
            self._exhausted = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    # -------------------------------------------------------- shutdown
    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the prefetch producer and JOIN it (the
        engine.StepHarness session teardown calls this for attached
        iterators, so a fit that raises cannot leak the producer).
        Idempotent and non-terminal: a later __iter__()/reset() starts a
        fresh pass with a new producer."""
        self._gen += 1           # stale producers self-terminate
        q = self._q
        if q is not None:
            # drain so a producer blocked on a full queue re-checks
            # its generation promptly (its put() polls with a timeout,
            # so this is a latency nicety, not correctness)
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=timeout_s)
            if self._thread.is_alive():   # base iterator wedged in I/O
                raise TimeoutError(
                    "AsyncDataSetIterator prefetch thread did not "
                    f"exit within {timeout_s}s (base iterator blocked "
                    "in next()?)")
        self._thread = None
        self._q = None
        self._exhausted = True

    def join(self, timeout_s: float = 5.0) -> None:
        """Alias for close(): stop and join the prefetch thread."""
        self.close(timeout_s=timeout_s)

    def __enter__(self) -> "AsyncDataSetIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MultipleEpochsIterator(DataSetIterator):
    """Replays a base iterator N times (ref: MultipleEpochsIterator.java)."""

    def __init__(self, epochs: int, base):
        self.epochs = epochs
        self.base = base
        self._epoch = 0
        self._inner = None

    def reset(self):
        self._epoch = 0
        self._inner = None
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __next__(self):
        if self._inner is None:
            self._inner = iter(self.base)
        while True:
            try:
                return next(self._inner)
            except StopIteration:
                self._epoch += 1
                if self._epoch >= self.epochs:
                    raise
                if hasattr(self.base, "reset"):
                    self.base.reset()
                self._inner = iter(self.base)


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Caps the number of batches (ref: EarlyTerminationDataSetIterator.java)."""

    def __init__(self, base, max_batches: int):
        self.base = base
        self.max_batches = max_batches
        self._count = 0
        self._inner = None

    def reset(self):
        self._count = 0
        self._inner = None
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __next__(self):
        if self._count >= self.max_batches:
            raise StopIteration
        if self._inner is None:
            self._inner = iter(self.base)
        self._count += 1
        return next(self._inner)


class BenchmarkDataSetIterator(DataSetIterator):
    """Yields the same synthetic batch N times — zero-ETL throughput
    harness (ref: impl/BenchmarkDataSetIterator.java)."""

    def __init__(self, feature_shape, num_classes: int, num_batches: int,
                 seed: int = 0, label_shape=None):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=feature_shape).astype(np.float32)
        if label_shape is not None:
            y = rng.normal(size=label_shape).astype(np.float32)
        else:
            y = np.eye(num_classes, dtype=np.float32)[
                rng.integers(0, num_classes, feature_shape[0])]
        self.batch = DataSet(x, y)
        self.num_batches = num_batches
        self._pos = 0

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < self.num_batches

    def __next__(self):
        if not self.has_next():
            raise StopIteration
        self._pos += 1
        return self.batch


class DevicePrefetchIterator(DataSetIterator):
    """Double-buffered host->device input pipeline: stages up to
    `buffer_size` upcoming batches on the device while the current step
    runs, and yields each as a tuple (features, labels, features_mask,
    labels_mask) of device tensors, in order.

    On CUDA each host array is converted to `dtype` (floating arrays
    only) and copied into pinned memory (`host_stage`; a batch that
    arrives as a HostBatch, staged so by a producer thread, skips this),
    then sent to the card by a DeviceStage (side stream, an event the
    consumer's stream waits on in `__next__`). On the CPU staging is a
    plain pass-through: the host arrays are yielded as they are.

    `transform(batch) -> batch` optionally maps the host batch before
    staging. `device` follows the port's policy: "cuda" unless the
    caller passes "cpu".
    """

    def __init__(self, base: Iterable, buffer_size: int = 2,
                 transform=None, device=None, dtype=torch.float32):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        self.base = base
        self.buffer_size = buffer_size
        self.transform = transform
        self.device = resolve_device(device)
        self.dtype = dtype
        self._stage = DeviceStage(self.device)
        self._src = None
        self._staged = None
        self._src_done = False

    def _put(self, item):
        if not isinstance(item, HostBatch):
            item = host_stage(item, self.transform, self.device, self.dtype)
        return self._stage.put(item)

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()
        self._src = None
        self._staged = None
        self._src_done = False

    def __iter__(self):
        if self._staged is not None:
            # an iteration is already staged (has_next() or a prior
            # __iter__); keep it — restaging would drop the buffered
            # batches when base is a one-shot generator. reset() starts
            # a genuinely fresh pass.
            return self
        self._src = iter(self.base)
        self._src_done = False
        self._staged = []
        for _ in range(self.buffer_size):
            try:
                self._staged.append(self._put(next(self._src)))
            except StopIteration:
                self._src_done = True
                break
        return self

    def has_next(self):
        if self._staged is None:
            self.__iter__()
        return bool(self._staged)

    def __next__(self):
        if self._staged is None:
            self.__iter__()
        if not self._staged:
            # exhausted: clear the stage marker so the next __iter__
            # starts a fresh pass over base (multi-epoch reuse)
            self._staged = None
            raise StopIteration
        out = self._staged.pop(0)
        if not self._src_done:
            # never call next() again after exhaustion: a multi-epoch
            # base would hand us its following epoch
            try:
                self._staged.append(self._put(next(self._src)))
            except StopIteration:
                self._src_done = True
        return self._stage.take(out)

    # -------------------------------------------------------- shutdown
    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the pipeline: drop the staged buffer (a staged batch
        that was never consumed is discarded, never re-yielded) and
        propagate close() to `base`, so a wrapped AsyncDataSetIterator's
        producer thread is joined. Idempotent and non-terminal: a later
        __iter__()/reset() starts a fresh pass."""
        self._src = None
        self._staged = None
        self._src_done = False
        if hasattr(self.base, "close"):
            try:
                self.base.close(timeout_s=timeout_s)
            except TypeError:   # base close() without a timeout param
                self.base.close()

    def __enter__(self) -> "DevicePrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
