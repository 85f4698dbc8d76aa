"""The port's ParallelInference (deeplearning4j_tpu_torch/parallel/
inference.py) on the CPU: concurrent mixed-size requests equal a direct
`output`, buckets stay capped, load is shed when the queue is full,
deadlines hold, and shutdown fails every waiter fast."""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from deeplearning4j_tpu_torch.resilience.errors import (
    DeadlineExceededError,
    OverloadedError,
    ShutdownError,
)
from deeplearning4j_tpu_torch.zoo.models import ResNet50


@pytest.fixture(scope="module")
def small_resnet():
    """ResNet-50 at reduced input size (f32, so batch composition cannot
    move a row's result past rounding noise), kernels' plain versions on
    the CPU; BN states randomized so the affine prologue is not the
    identity."""
    net = ResNet50(num_classes=10, input_shape=(32, 32, 3),
                   helpers="pallas").init_model(device="cpu")
    gen = torch.Generator().manual_seed(3)
    for name, st in net.states.items():
        if "mean" in st:
            c = st["mean"].shape[0]
            st["mean"] = torch.randn(c, generator=gen) * 0.1
            st["var"] = torch.rand(c, generator=gen) + 0.5
    return net


def test_concurrent_mixed_requests_match_direct_output(small_resnet):
    net = small_resnet
    pi = ParallelInference(net, batch_limit=8, queue_limit=64,
                           max_wait_ms=5.0, default_timeout_s=60.0)
    rng = np.random.default_rng(0)
    sizes = [1, 3, 8, 5, 2, 12]
    reqs = [rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
            for n in sizes]
    results = [None] * len(reqs)

    def call(i):
        results[i] = pi.output(reqs[i])

    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        st = pi.stats()
    finally:
        pi.shutdown()
    assert st["warmed_buckets"] == [1, 2, 4, 8]
    assert max(st["bucket_fill"]) <= 8          # capped at next_pow2(8)
    assert st["requests_completed"] == len(reqs)
    for x, got in zip(reqs, results):
        assert isinstance(got, np.ndarray) and got.shape == (x.shape[0], 10)
        # rows are independent in eval mode: a padded batch gives the
        # same rows as a direct call, up to f32 accumulation order
        np.testing.assert_allclose(got, net.output(x).numpy(),
                                   rtol=1e-4, atol=1e-6)


class _SlowNet:
    """Stand-in model whose output blocks until released."""

    def __init__(self, release=None):
        self.release = release
        self.started = threading.Event()

    def output(self, x):
        self.started.set()
        if self.release is not None:
            self.release.wait(timeout=10.0)
        return torch.as_tensor(np.asarray(x)) * 2


def test_sheds_load_when_queue_full():
    release = threading.Event()
    net = _SlowNet(release=release)
    pi = ParallelInference(net, batch_limit=1, queue_limit=1,
                           max_wait_ms=0.0, default_timeout_s=5.0,
                           warmup=False)
    try:
        results = []
        t = threading.Thread(target=lambda: results.append(
            pi.output(np.ones((1, 2), np.float32))))
        t.start()
        assert net.started.wait(timeout=5.0)
        t2 = threading.Thread(target=lambda: results.append(
            pi.output(np.ones((1, 2), np.float32))))
        t2.start()
        deadline = time.monotonic() + 5.0
        while pi.queue_depth() < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        with pytest.raises(OverloadedError):
            pi.output(np.ones((1, 2), np.float32))
        release.set()
        t.join(timeout=5.0)
        t2.join(timeout=5.0)
        assert len(results) == 2
        for r in results:
            np.testing.assert_array_equal(r, np.full((1, 2), 2.0))
    finally:
        release.set()
        pi.shutdown()


def test_deadline_instead_of_hang():
    release = threading.Event()
    pi = ParallelInference(_SlowNet(release=release), batch_limit=1,
                           max_wait_ms=0.0, warmup=False)
    try:
        with pytest.raises(DeadlineExceededError):
            pi.output(np.ones((1, 2), np.float32), timeout_s=0.2)
    finally:
        release.set()
        pi.shutdown()


def test_shutdown_fails_every_waiter():
    release = threading.Event()
    net = _SlowNet(release=release)
    pi = ParallelInference(net, batch_limit=1, queue_limit=8,
                           max_wait_ms=0.0, default_timeout_s=10.0,
                           warmup=False)
    errors = []

    def call():
        try:
            pi.output(np.ones((1, 2), np.float32))
        except Exception as e:   # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    assert net.started.wait(timeout=5.0)
    deadline = time.monotonic() + 5.0
    while pi.queue_depth() < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert pi.queue_depth() == 3
    pi.shutdown()
    for t in threads:
        t.join(timeout=5.0)
        assert not t.is_alive(), "caller hung through shutdown"
    assert len(errors) == 4
    assert all(isinstance(e, ShutdownError) for e in errors)
    assert not pi.healthy
    with pytest.raises(ShutdownError):
        pi.output(np.ones((1, 2), np.float32))
    release.set()


def test_oversized_request_is_split_and_reassembled():
    pi = ParallelInference(_SlowNet(), batch_limit=4, max_wait_ms=0.0,
                           warmup=False)
    try:
        x = np.arange(22, dtype=np.float32).reshape(11, 2)
        np.testing.assert_array_equal(pi.output(x), x * 2)
        st = pi.stats()
        assert max(st["bucket_fill"]) <= 4
        assert st["batches_dispatched"] >= 3
    finally:
        pi.shutdown()


def test_request_queue_dequeues_by_priority_class():
    from deeplearning4j_tpu_torch.parallel.inference import (
        _Pending,
        _RequestQueue,
    )

    q = _RequestQueue(maxsize=8)
    order = [("low", 0), ("normal", 1), ("high", 2), ("normal", 3),
             ("high", 4)]
    idx = {"high": 0, "normal": 1, "low": 2}
    for cls, tag in order:
        p = _Pending((np.full((1, 1), tag),), priority_idx=idx[cls])
        q.put_nowait(p)
    got = [int(q.get_nowait().xs[0][0, 0]) for _ in order]
    assert got == [2, 4, 1, 3, 0]   # high, then normal, then low; FIFO within
