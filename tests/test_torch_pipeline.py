"""The port's input pipeline (engine/pipeline.py, datasets/iterators.py), on
the CPU: the semantics tests/test_pipeline.py pins for the JAX package —
StepPrefetcher get/seek/SKIPPED and a fetch error carried to the right
step, IteratorPipeline order and close joining its producer, the
DevicePrefetchIterator's CPU pass-through and close propagation, the
AsyncDataSetIterator's restartable close — and the pipeline metrics.
The CUDA staging (pinned memory, side stream, event) runs on the card:
tests/test_torch_cuda.py.

One producer per pass: `reset()` then a pass over the pipeline resets
and iterates the base exactly as `reset()` then a pass over the base
itself does, so a shuffled epoch trains on the same batches in the same
order with the pipeline on as off. The JAX package's pipeline starts two
producers per such pass (and resets a shuffled base twice more); that
fault stays in the reference, so the port's pipeline-on order equals the
JAX package's pipeline-off order, not its pipeline-on order."""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (
    AsyncDataSetIterator,
    DataSet,
    DevicePrefetchIterator,
    ListDataSetIterator,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.iterators import HostBatch, host_stage
from deeplearning4j_tpu_torch.engine import (
    SKIPPED,
    IteratorPipeline,
    StepHarness,
    StepPrefetcher,
    stack_staged,
)
from deeplearning4j_tpu_torch.observability import metrics as tobs

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.datasets import ListDataSetIterator as JListIterator
from deeplearning4j_tpu.engine.pipeline import (
    IteratorPipeline as JIteratorPipeline,
)


def _batch(step, rows=4):
    rng = np.random.default_rng(500 + step)
    x = rng.normal(size=(rows, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)]
    return x, y


class _Net:
    """The harness reads only a device and a dtype from a net here."""
    device = torch.device("cpu")
    dtype = torch.float32


def _live(prefix, before):
    return [t for t in threading.enumerate()
            if t.name.startswith(prefix) and t.name not in before
            and t.is_alive()]


# ------------------------------------------------------ StepPrefetcher


def test_step_prefetcher_seek_and_skip_predicate():
    calls, condemned = [], set()

    def fetch(s):
        calls.append(s)
        return ("batch", s)

    with StepPrefetcher(fetch, start=0, stop=8, depth=2,
                        skip=lambda s: s in condemned) as pf:
        assert pf.get(0) == ("batch", 0)
        assert pf.get(1) == ("batch", 1)
        condemned.add(3)
        assert pf.get(2) == ("batch", 2)
        # rollback: rewind to 1 — triggers a reseek
        assert pf.get(1) == ("batch", 1)
        assert pf.counters["reseeks"] >= 1
        assert pf.get(2) == ("batch", 2)
        assert pf.get(4) == ("batch", 4)   # 3 skipped by predicate
    assert 3 not in calls[calls.index(4):]  # condemned never refetched


def test_step_prefetcher_carries_fetch_error_to_the_right_step():
    def fetch(s):
        if s == 2:
            raise ValueError("bad shard")
        return s

    with StepPrefetcher(fetch, start=0, stop=6, depth=2) as pf:
        assert pf.get(0) == 0
        assert pf.get(1) == 1
        with pytest.raises(ValueError, match="bad shard"):
            pf.get(2)
        assert pf.get(3) == 3   # producer restarts past the error
        assert pf.counters["errors"] == 1


def test_step_prefetcher_skipped_marker_and_close():
    before = {t.name for t in threading.enumerate()}
    pf = StepPrefetcher(lambda s: SKIPPED if s == 1 else s, start=0,
                        stop=4, depth=2)
    assert pf.get(0) == 0
    assert pf.get(1) is None            # the fetch's skip policy ate it
    assert pf.get(2) == 2
    pf.close()
    assert not _live("StepPrefetcher", before)
    with pytest.raises(RuntimeError, match="closed"):
        pf.get(3)
    assert pf.facts()["batches"] == 3


# ------------------------------------------------------ IteratorPipeline


def test_iterator_pipeline_keeps_order_and_epochs():
    data = [_batch(s) for s in range(5)]
    pipe = IteratorPipeline(data, depth=2, device="cpu")
    for _ in range(2):                  # two epochs over one pipeline
        pipe.reset()
        got = list(pipe)
        assert len(got) == 5
        for (x, y), item in zip(data, got):
            np.testing.assert_array_equal(np.asarray(item[0]), x)
            np.testing.assert_array_equal(np.asarray(item[1]), y)
    assert pipe.facts()["batches"] == 10
    pipe.close()


def test_iterator_pipeline_stages_on_the_producer_thread():
    """`stage` (with the rest of the host half of staging) runs once per
    batch, on the producer thread, never on the consumer's."""
    threads = []

    def stage(batch):
        threads.append(threading.current_thread().name)
        x, y = batch
        return x * 2, y

    data = [_batch(s) for s in range(4)]
    with IteratorPipeline(data, depth=2, stage=stage, device="cpu") as pipe:
        got = list(pipe)
    assert len(threads) == 4
    assert set(threads) == {"AsyncDataSetIterator-prefetch"}
    for (x, y), item in zip(data, got):
        np.testing.assert_array_equal(item[0], x * 2)
        np.testing.assert_array_equal(item[1], y)


def test_iterator_pipeline_over_a_producer_stages_on_the_consumer():
    """A source that is already an AsyncDataSetIterator is not wrapped
    again; its batches are then staged (and `stage` applied once) by the
    device stage."""
    calls = []

    def stage(batch):
        calls.append(threading.current_thread().name)
        return batch

    src = AsyncDataSetIterator([_batch(s) for s in range(3)], queue_size=2)
    with IteratorPipeline(src, depth=2, stage=stage, device="cpu") as pipe:
        assert pipe._async is src and src.prepare is None
        assert len(list(pipe)) == 3
    assert calls == [threading.current_thread().name] * 3


def _shuffled(pkg="port", rows=16, batch=4, seed=5):
    """A shuffled list iterator whose features name their row."""
    x = np.arange(rows, dtype=np.float32).reshape(rows, 1) * [[1.0, -1.0]]
    y = np.eye(2, dtype=np.float32)[np.arange(rows) % 2]
    if pkg == "jax":
        return JListIterator(JDataSet(x, y), batch_size=batch, shuffle=True,
                             seed=seed)
    return ListDataSetIterator(DataSet(x, y), batch_size=batch, shuffle=True,
                               seed=seed)


def _epoch_orders(data, epochs=2):
    """The rows of each batch over `epochs` passes of the trainer's
    pattern (reset, then iterate)."""
    out = []
    for _ in range(epochs):
        data.reset()
        out.append([np.asarray(b[0] if isinstance(b, tuple)
                               else b.features)[:, 0].astype(int).tolist()
                    for b in data])
    return out


def test_pipeline_prepares_each_batch_once_per_pass():
    """reset() then a pass starts one producer: `stage` (the host half of
    staging) runs once per batch and the base is reset as often as a
    pass over it alone resets it."""
    calls, resets = [], []

    class Counted(ListDataSetIterator):
        def reset(self):
            resets.append(1)
            super().reset()

    x = np.zeros((16, 2), np.float32)
    base = Counted(DataSet(x, np.eye(2, dtype=np.float32)[np.arange(16) % 2]),
                   batch_size=4)
    resets.clear()
    pipe = IteratorPipeline(base, depth=2, device="cpu",
                            stage=lambda b: calls.append(1) or b)
    for epoch in range(2):
        pipe.reset()
        assert len(list(pipe)) == 4
        assert len(calls) == 4 * (epoch + 1)
        assert len(resets) == 2 * (epoch + 1)   # reset() + the pass's iter
    pipe.close()


def test_pipeline_on_equals_off_over_shuffled_epochs():
    on = IteratorPipeline(_shuffled(), depth=2, device="cpu")
    assert _epoch_orders(on) == _epoch_orders(_shuffled())
    on.close()


def test_port_pipeline_order_is_jax_pipeline_off_order():
    """The JAX package's pipeline starts two producers per reset-then-
    iterate pass and so shuffles its epochs into another order than its
    synchronous path; the port's pipeline follows the synchronous
    order."""
    port_on = IteratorPipeline(_shuffled(), depth=2, device="cpu")
    jax_on = JIteratorPipeline(_shuffled("jax"), depth=2)
    ours, jax_off = _epoch_orders(port_on), _epoch_orders(_shuffled("jax"))
    theirs_on = _epoch_orders(jax_on)
    port_on.close()
    jax_on.close()
    assert ours == jax_off
    assert ours != theirs_on


def test_superseded_producer_never_touches_the_base_again():
    """A producer superseded by reset() stops calling the base: the base
    sees exactly the calls of the new pass."""
    log = []

    class Slow:
        def __init__(self):
            self.i = 0

        def reset(self):
            log.append("reset")
            self.i = 0

        def __iter__(self):
            log.append("iter")
            return self

        def __next__(self):
            time.sleep(0.01)
            self.i += 1
            log.append("next")
            if self.i > 50:
                raise StopIteration
            return _batch(self.i)

    it = AsyncDataSetIterator(Slow(), queue_size=1)
    next(iter(it))                      # producer 1 is now running
    it.reset()
    mark = len(log)
    got = [next(iter(it)) for _ in range(1)]
    it.close()
    assert log[mark - 1] == "reset" and log[mark] == "iter"
    # after the reset only the new pass's producer called the base: one
    # iter, then nexts, and never a second iter or reset
    assert "reset" not in log[mark:] and log[mark:].count("iter") == 1
    assert len(got) == 1


def test_iterator_pipeline_close_joins_its_producer():
    before = {t.name for t in threading.enumerate()}
    pipe = IteratorPipeline([_batch(s) for s in range(6)], depth=2,
                            device="cpu")
    next(iter(pipe))
    pipe.close()
    assert pipe._async._thread is None
    assert not _live("AsyncDataSetIterator", before)


def test_harness_session_joins_wrapped_producer():
    before = {t.name for t in threading.enumerate()}
    harness = StepHarness(_Net(), program=object())
    pipe = harness.build_iterator_pipeline(
        [_batch(s) for s in range(4)], depth=2)
    with pytest.raises(RuntimeError):
        with harness.session():
            next(iter(pipe))            # producer thread is now live
            raise RuntimeError("fit crashed")
    assert pipe._async._thread is None
    assert not _live("AsyncDataSetIterator", before)
    assert harness.pipeline_stats()["batches"] == 1


def test_pipeline_metrics():
    reg = tobs.get_registry()
    base = reg.counter_value("dl4j_pipeline_batches_total")
    with IteratorPipeline([_batch(s) for s in range(3)], depth=3,
                          device="cpu") as pipe:
        assert len(list(pipe)) == 3
    assert reg.counter_value("dl4j_pipeline_batches_total") == base + 3
    snap = reg.snapshot()
    assert snap["histograms"]["dl4j_pipeline_wait_seconds"]["count"] >= 3
    assert snap["gauges"]["dl4j_pipeline_depth"][""] == 3.0


# --------------------------------------------------------- iterators


def test_device_prefetch_cpu_is_a_pass_through():
    d = DataSet(np.arange(20.0).reshape(10, 2), np.eye(2)[np.arange(10) % 2])
    it = DevicePrefetchIterator(ListDataSetIterator(d, batch_size=4),
                                buffer_size=2, device="cpu")
    got = list(it)
    assert [b[0].shape for b in got] == [(4, 2), (4, 2), (2, 2)]
    assert isinstance(got[0][0], np.ndarray)   # the host array itself
    assert got[0][2] is None and got[0][3] is None
    assert len(list(it)) == 3                  # a second pass


def test_device_prefetch_takes_a_host_batch_as_is():
    """A HostBatch (staged by a producer thread) is not transformed
    again; anything else goes through `host_stage` first."""
    x, y = _batch(0)
    seen = []
    it = DevicePrefetchIterator(
        [HostBatch((x, y, None, None)), DataSet(x, y)], device="cpu",
        transform=lambda b: seen.append(b) or b)
    got = list(it)
    assert len(seen) == 1 and isinstance(seen[0], DataSet)
    for item in got:
        assert type(item) is tuple and item[0] is x and item[1] is y
        assert item[2] is None and item[3] is None
    hb = host_stage(DataSet(x, y))
    assert isinstance(hb, HostBatch) and hb[0] is x and hb[1] is y


def test_device_prefetch_close_propagates_to_async_base():
    base = AsyncDataSetIterator([_batch(s) for s in range(4)],
                                queue_size=2)
    it = DevicePrefetchIterator(base, buffer_size=2, device="cpu")
    first = next(iter(it))
    it.close()
    assert base._thread is None and first is not None
    with DevicePrefetchIterator(AsyncDataSetIterator([_batch(0)]),
                                device="cpu") as cm:
        assert len(list(cm)) == 1
    assert cm.base._thread is None


def test_device_prefetch_defaults_to_cuda():
    """The port's device policy: without device="cpu" the stage is on
    CUDA, and without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetchIterator([_batch(0)])


def test_async_iterator_close_is_reusable():
    data = [_batch(s) for s in range(3)]
    it = AsyncDataSetIterator(data, queue_size=2)
    first = next(iter(it))
    it.close()
    with pytest.raises(StopIteration):
        next(it)                  # closed: exhausted until restarted
    again = list(it)              # __iter__ restarts a fresh pass
    assert len(again) == 3
    np.testing.assert_array_equal(first[0], again[0][0])
    it.close()                    # idempotent


def test_async_iterator_surfaces_the_base_error():
    def gen():
        yield _batch(0)
        raise OSError("disk gone")

    it = AsyncDataSetIterator(gen(), queue_size=2)
    assert next(iter(it))[0].shape == (4, 3)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    it.close()


def test_list_iterator_shuffles_per_epoch_and_datasets_split():
    d = DataSet(np.arange(12.0).reshape(6, 2), np.arange(6.0))
    it = ListDataSetIterator(d, batch_size=6, shuffle=True, seed=3)
    e1 = next(iter(it)).labels.copy()
    e2 = next(iter(it)).labels.copy()
    assert sorted(e1) == sorted(e2) == list(range(6))
    assert not np.array_equal(e1, e2)
    tr, te = d.split_test_and_train(4)
    assert tr.num_examples() == 4 and te.num_examples() == 2
    x, y, fm, lm = d                     # tuple unpacking
    assert fm is None and lm is None and x.shape == (6, 2)
    md = MultiDataSet([x, x], [y])
    assert md.num_examples() == 6 and md.features_mask is None


def test_stack_staged():
    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    out = stack_staged(parts)
    assert tuple(out.shape) == (4, 2, 3)
    assert torch.equal(out[2], parts[2])
