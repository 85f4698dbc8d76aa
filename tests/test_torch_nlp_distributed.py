"""The port's multi-process SequenceVectors (deeplearning4j_tpu_torch/nlp/
distributed.py), the cases of the JAX package's
tests/test_nlp_distributed.py: two gloo processes
(tests/fixtures/torch/w2v_worker.py, which imports only the port) reach
single-process semantic quality, hold bit-identical tables after the
final rendezvous, compress their deltas, and partition the corpus as the
JAX package does; `_allmean` of fixed deltas agrees with the JAX
package's to 1e-6.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch")
WORKER = os.path.join(FIXTURES, "w2v_worker.py")
sys.path.insert(0, FIXTURES)
from mesh_worker import free_port  # noqa: E402
from w2v_worker import corpus  # noqa: E402


def _launch(nprocs, out_dir, extra=()):
    port = free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), str(nprocs), str(port), out_dir,
         *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(nprocs)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The plain drill and the compressed one, each a 2-process gang."""
    plain = str(tmp_path_factory.mktemp("w2v_dist"))
    comp = str(tmp_path_factory.mktemp("w2v_comp"))
    _launch(2, plain)
    _launch(2, comp, ("--threshold", "5e-3", "--epochs", "6",
                      "--sync-every", "2"))
    return {"plain": plain, "comp": comp}


def _cluster_quality(syn0, words):
    """Mean intra-cluster minus inter-cluster cosine similarity of the
    a*/b* word groups (tests/test_nlp_distributed.py's measure)."""
    idx = {w: i for i, w in enumerate(words)}
    A = np.stack([syn0[idx[f"a{i}"]] for i in range(12)])
    B = np.stack([syn0[idx[f"b{i}"]] for i in range(12)])

    def cos(m1, m2):
        n1 = m1 / np.linalg.norm(m1, axis=1, keepdims=True)
        n2 = m2 / np.linalg.norm(m2, axis=1, keepdims=True)
        return (n1 @ n2.T).mean()

    return (cos(A, A) + cos(B, B)) / 2 - cos(A, B)


@pytest.fixture(scope="module")
def single():
    """The JAX package's single-process oracle (scan mode, 6 epochs)."""
    from deeplearning4j_tpu.nlp.sequence_vectors import SequenceVectors

    sv = SequenceVectors(layer_size=16, window=3, negative=4, epochs=6,
                         seed=11, mode="scan")
    seqs = corpus()
    sv.build_vocab(seqs)
    sv.fit(seqs)
    words = [sv.vocab.word_at_index(i) for i in range(sv.vocab.num_words())]
    return sv, words


def test_two_process_w2v_matches_single_quality(runs, single):
    s0 = np.load(os.path.join(runs["plain"], "syn0_0.npy"))
    s1 = np.load(os.path.join(runs["plain"], "syn0_1.npy"))
    # after the final rendezvous both processes hold the same tables
    np.testing.assert_array_equal(s0, s1)
    sv, words = single
    q_dist = _cluster_quality(s0, words)
    q_single = _cluster_quality(np.asarray(sv.syn0), words)
    assert q_single > 0.3, f"oracle failed to separate: {q_single}"
    assert q_dist > 0.7 * q_single, (q_dist, q_single)
    stats = json.load(open(os.path.join(runs["plain"], "stats_0.json")))
    assert stats == {"rendezvous": 3, "compression_ratio": 1.0}


def test_two_process_w2v_threshold_compression(runs, single):
    s0 = np.load(os.path.join(runs["comp"], "syn0_0.npy"))
    s1 = np.load(os.path.join(runs["comp"], "syn0_1.npy"))
    np.testing.assert_array_equal(s0, s1)
    stats = json.load(open(os.path.join(runs["comp"], "stats_0.json")))
    assert stats["rendezvous"] == 3
    # compression actually engaged
    assert 0.0 < stats["compression_ratio"] < 1.0
    q = _cluster_quality(s0, single[1])
    assert q > 0.2, f"compressed run lost semantic separation: {q}"


def test_allmean_matches_jax_allmean(runs, monkeypatch):
    """The JAX package's `_allmean` on the same two fixed deltas (its
    process_allgather stacked by hand) against each process's mean."""
    from jax.experimental import multihost_utils

    from deeplearning4j_tpu.nlp.distributed import (
        DistributedSequenceVectors as JDSV,
    )

    deltas = [np.random.default_rng(100 + p).normal(size=(24, 16)).astype(
        np.float32) for p in range(2)]
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda d: np.stack(deltas))
    want = JDSV(None, process_index=0, process_count=2)._allmean(
        {"syn0": deltas[0]})["syn0"]
    for p in range(2):
        got = np.load(os.path.join(runs["plain"], f"allmean_{p}.npy"))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_shard_sequences_partition():
    from deeplearning4j_tpu.nlp.distributed import (
        DistributedSequenceVectors as JDSV,
    )
    from deeplearning4j_tpu_torch.nlp.distributed import (
        DistributedSequenceVectors,
    )

    seqs = [[str(i)] for i in range(7)]
    p0 = DistributedSequenceVectors.shard_sequences(seqs, 0, 2)
    p1 = DistributedSequenceVectors.shard_sequences(seqs, 1, 2)
    assert [s[0] for s in p0] == ["0", "2", "4", "6"]
    assert [s[0] for s in p1] == ["1", "3", "5"]
    assert len(p0) + len(p1) == 7
    for n in (1, 2, 3):
        for p in range(n):
            assert DistributedSequenceVectors.shard_sequences(seqs, p, n) \
                == JDSV.shard_sequences(seqs, p, n)


def test_one_process_is_the_wrapped_fit_with_the_global_anneal():
    """At world 1 (no group) a rendezvous averages nothing: the wrapper's
    fit is the model's own fit under the per-process RNG stream and one
    global anneal, up to the rounding of before + (after - before) (the
    JAX package's write-back), and queries pass through."""
    from deeplearning4j_tpu_torch.nlp.distributed import (
        DistributedSequenceVectors,
    )
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors

    seqs = corpus()[:40]
    kw = dict(layer_size=8, window=2, negative=2, epochs=2, seed=5,
              mode="scan", device="cpu")
    sv = SequenceVectors(**kw)
    dsv = DistributedSequenceVectors(sv, sync_every=2).build_vocab(seqs)
    dsv.fit(seqs)
    ref = SequenceVectors(**kw)
    ref.build_vocab(seqs)
    ref._fit_rng = np.random.default_rng(5 + 1)
    ref.lr_total_epochs = 2
    ref.fit(seqs)
    np.testing.assert_allclose(np.asarray(sv.syn0), np.asarray(ref.syn0),
                               rtol=0, atol=1e-9)
    assert dsv.vocab is sv.vocab and sv.epochs == 2
    assert dsv.wire_stats() == {"rendezvous": 1, "compression_ratio": 1.0}
