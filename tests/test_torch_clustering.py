"""The port's clustering package (deeplearning4j_tpu_torch/clustering/)
against the JAX package's, on the CPU, on the same seeded NumPy inputs.

Tolerances, stated once:
  - pairwise_distance per metric and knn's distances: 1e-5 (absolute
    and relative); knn's indices equal (no ties in the seeded data);
  - the t-SNE affinities: P_conditional and the sparse P within 1e-4
    absolute (the 50-step beta bisection may take one comparison the
    other way near log(perplexity)), the symmetrized sparse P within
    1e-6 absolute, `mutual` equal; the gradient within 1e-5 of its
    largest entry, the KL within 1e-5 relative;
  - t-SNE loops: a chaotic map (early exaggeration drives y from 1e-4
    to ~50 in a few steps, and one ulp grows to a different embedding
    by step 50), so a loop is held step by step from the same y0: at
    each of 50 iterations the JAX step and the port's step run on the
    port's state, and agree within STEP_TOL of max(1, max|y|);
  - k-means: the k-means++ centres equal, the assignments equal, the
    centres and inertia within 1e-5 relative;
  - VP and KD trees: indices equal, distances equal to float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.clustering import distances as jd
from deeplearning4j_tpu.clustering import kmeans as jk
from deeplearning4j_tpu.clustering import tsne as jt
from deeplearning4j_tpu.clustering import (
    KDTree as JKDTree,
    VPTree as JVPTree,
)
from deeplearning4j_tpu_torch.clustering import (
    KDTree,
    KMeansClustering,
    NearestNeighborsClient,
    NearestNeighborsServer,
    Tsne,
    VPTree,
    knn,
    pairwise_distance,
)
from deeplearning4j_tpu_torch.clustering import tsne as pt
from deeplearning4j_tpu_torch.resilience.errors import ServingError

@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small (hundreds of rows): one intra-op thread
    runs them fastest, and several test processes sharing the cores
    (pytest-xdist) no longer wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIST_TOL = 1e-5
P_TOL = 1e-4
PSYM_TOL = 1e-6
GRAD_TOL = 1e-5
STEP_TOL = 1e-4
KMEANS_TOL = 1e-5


def _blobs(rng, n_per=30, d=5, centers=((0,) * 5, (8,) * 5, (-8, 8, -8, 8, -8))):
    xs, labels = [], []
    for i, c in enumerate(centers):
        xs.append(rng.normal(size=(n_per, d)) + np.asarray(c))
        labels += [i] * n_per
    return np.concatenate(xs).astype(np.float32), np.asarray(labels)


def _tsne_data(rng):
    """200 points in three 6-d blobs (N = 200 for the loop checks)."""
    x = np.concatenate([rng.normal(size=(67, 6)) + c
                        for c in (0.0, 6.0, -6.0)])[:200]
    return x.astype(np.float32)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean",
                                    "manhattan", "cosine", "dot"])
def test_pairwise_distance_oracle(rng, metric):
    x = rng.normal(size=(7, 4)).astype(np.float32)
    y = rng.normal(size=(5, 4)).astype(np.float32)
    got = pairwise_distance(x, y, metric, device="cpu").numpy()
    want = np.asarray(jd.pairwise_distance(x, y, metric))
    np.testing.assert_allclose(got, want, rtol=DIST_TOL, atol=DIST_TOL)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    brute = {
        "euclidean": lambda: np.sqrt(
            ((x64[:, None] - y64[None]) ** 2).sum(-1)),
        "sqeuclidean": lambda: ((x64[:, None] - y64[None]) ** 2).sum(-1),
        "manhattan": lambda: np.abs(x64[:, None] - y64[None]).sum(-1),
        "cosine": lambda: 1 - (x64 / np.linalg.norm(x64, axis=1)[:, None])
        @ (y64 / np.linalg.norm(y64, axis=1)[:, None]).T,
        "dot": lambda: -(x64 @ y64.T),
    }[metric]()
    np.testing.assert_allclose(got, brute, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="unknown metric"):
        pairwise_distance(x, y, "chebyshev", device="cpu")


def test_knn_device_matches_brute(rng):
    corpus = rng.normal(size=(200, 8)).astype(np.float32)
    queries = rng.normal(size=(11, 8)).astype(np.float32)
    idx, dist = knn(queries, corpus, k=5, tile=4, device="cpu")
    assert idx.dtype == torch.int64 and tuple(idx.shape) == (11, 5)
    jidx, jdist = jd.knn(queries, corpus, k=5, tile=4)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(dist.numpy(), jdist, rtol=DIST_TOL,
                               atol=DIST_TOL)
    brute = np.sqrt(((queries[:, None, :].astype(np.float64)
                      - corpus[None]) ** 2).sum(-1))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.argsort(brute, axis=1)[:, :5])
    # tensors stay on their device; k is capped at the corpus size
    i2, _ = knn(torch.tensor(queries), torch.tensor(corpus[:3]), k=9)
    assert tuple(i2.shape) == (11, 3)


def test_knn_ties_compare_as_sets(rng):
    """Duplicated corpus rows tie exactly: the port and JAX may order a
    tie differently, so the neighbour SETS are compared."""
    base = rng.normal(size=(20, 3)).astype(np.float32)
    corpus = np.concatenate([base, base])
    idx, _ = knn(base, corpus, k=4, device="cpu")
    jidx, _ = jd.knn(base, corpus, k=4)
    for a, b in zip(idx.numpy(), jidx):
        assert set(a[:2]) == set(b[:2]) == {a[0] % 20, a[0] % 20 + 20}


def test_vptree_exact(rng):
    pts = rng.normal(size=(120, 6))
    tree = VPTree(pts, metric="euclidean", seed=3)
    q = rng.normal(size=(6,))
    idx, dist = tree.search(q, k=7)
    jidx, jdist = JVPTree(pts, metric="euclidean", seed=3).search(q, k=7)
    assert idx == jidx and dist == jdist
    brute = np.linalg.norm(pts - q, axis=1)
    np.testing.assert_array_equal(idx, np.argsort(brute)[:7])
    np.testing.assert_allclose(dist, np.sort(brute)[:7], rtol=1e-9)


def test_vptree_other_metrics(rng):
    pts = rng.normal(size=(60, 4))
    q = rng.normal(size=(4,))
    for metric, fn in [
        ("manhattan", lambda a: np.abs(pts - a).sum(1)),
        ("cosine", lambda a: 1 - (pts @ a) /
         (np.linalg.norm(pts, axis=1) * np.linalg.norm(a))),
    ]:
        idx, _ = VPTree(pts, metric=metric).search(q, k=3)
        np.testing.assert_array_equal(idx, np.argsort(fn(q))[:3])
        assert idx == JVPTree(pts, metric=metric).search(q, k=3)[0]
    with pytest.raises(ValueError, match="unknown metric"):
        VPTree(pts, metric="dot")


def test_kdtree_matches_brute(rng):
    pts = rng.normal(size=(100, 3))
    tree, jtree = KDTree(3), JKDTree(3)
    for p in pts:
        tree.insert(p)
        jtree.insert(p)
    q = rng.normal(size=(3,))
    idx, dist = tree.knn(q, k=4)
    assert (idx, dist) == jtree.knn(q, k=4)
    brute = np.linalg.norm(pts - q, axis=1)
    np.testing.assert_array_equal(idx, np.argsort(brute)[:4])
    i0, d0 = tree.nn(q)
    assert i0 == int(np.argmin(brute))
    assert d0 == pytest.approx(float(np.min(brute)))
    with pytest.raises(ValueError, match="3-d point"):
        tree.insert(np.zeros(2))


def test_kmeans_recovers_blobs(rng):
    x, labels = _blobs(rng)
    km = KMeansClustering.setup(3, max_iterations=50, device="cpu")
    cs = km.apply(x)
    assert len(cs.clusters) == 3
    for i in range(3):
        assign = cs.assignments[labels == i]
        dominant = np.bincount(assign, minlength=3).max()
        assert dominant / len(assign) > 0.95
    means = np.stack([x[labels == i].mean(0) for i in range(3)])
    d = pairwise_distance(means, cs.centers, device="cpu").numpy()
    assert float(d.min(axis=1).max()) < 1.0
    # against the JAX package: the same k-means++ centres, the same
    # assignments, centres and inertia within KMEANS_TOL
    np.testing.assert_array_equal(
        km._init_centers(torch.tensor(x)),
        jk.KMeansClustering(3)._init_centers(x))
    jcs = jk.KMeansClustering.setup(3, max_iterations=50).apply(x)
    np.testing.assert_array_equal(cs.assignments, jcs.assignments)
    np.testing.assert_allclose(cs.centers, jcs.centers, rtol=KMEANS_TOL,
                               atol=KMEANS_TOL)
    assert cs.inertia == pytest.approx(jcs.inertia, rel=KMEANS_TOL)
    assert [c.point_indices for c in cs.clusters] \
        == [c.point_indices for c in jcs.clusters]


def test_kmeans_too_few_points():
    with pytest.raises(ValueError, match="k=5"):
        KMeansClustering(5, device="cpu").apply(np.zeros((3, 2), np.float32))


def test_tsne_separates_clusters(rng):
    x, labels = _blobs(rng, n_per=25, d=10,
                       centers=((0,) * 10, (10,) * 10, (-10, 10) * 5))
    t = Tsne(perplexity=10.0, max_iter=300, seed=1, device="cpu")
    emb = t.fit_transform(x)
    assert emb.shape == (75, 2)
    assert np.isfinite(emb).all()
    assert t.kl_history_.shape == (300,) and t.kl_ == t.kl_history_[-1]
    intra, inter = [], []
    for i in range(3):
        pts = emb[labels == i]
        intra.append(np.linalg.norm(pts - pts.mean(0), axis=1).mean())
        for j in range(i + 1, 3):
            inter.append(np.linalg.norm(
                pts.mean(0) - emb[labels == j].mean(0)))
    assert max(intra) * 2.0 < min(inter)
    # the seeded start is the same on every device and run
    np.testing.assert_array_equal(t.initial_embedding(75).numpy(),
                                  Tsne(seed=1).initial_embedding(75).numpy())


def test_tsne_perplexity_guard():
    with pytest.raises(ValueError, match="perplexity"):
        Tsne(perplexity=30.0, device="cpu").fit_transform(
            np.zeros((10, 3), np.float32))


def test_tsne_dense_affinities_and_gradient_match_jax(rng):
    """`_beta_search` through `_p_conditional`, and `_tsne_grad`, on
    the same arrays."""
    x = _tsne_data(rng)
    n = x.shape[0]
    pc = pt._p_conditional(torch.tensor(x), 10.0).numpy()
    jpc = np.asarray(jt._p_conditional(jnp.asarray(x), 10.0))
    np.testing.assert_allclose(pc, jpc, atol=P_TOL)
    np.testing.assert_allclose(pc.sum(1), 1.0, atol=1e-5)
    p = np.maximum((jpc + jpc.T) / (2.0 * n), 1e-12).astype(np.float32)
    y = (1e-2 * rng.normal(size=(n, 2))).astype(np.float32)
    for ex in (12.0, 1.0):
        g, kl = pt._tsne_grad(torch.tensor(y), torch.tensor(p), ex)
        jg, jkl = jt._tsne_grad(jnp.asarray(y), jnp.asarray(p), ex)
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg,
                                   atol=GRAD_TOL * np.abs(jg).max())
        assert float(kl) == pytest.approx(float(jkl), rel=GRAD_TOL)


def test_tsne_sparse_affinities_match_jax(rng):
    """`_p_sparse` and `_symmetrize_block` (and the self-entry drop of
    the chunked tier's kNN) on the same arrays."""
    x = _tsne_data(rng)
    n, k = x.shape[0], 30
    t = Tsne(perplexity=10.0, row_block=64, device="cpu")
    idx, psym, mutual = t.sparse_affinities(torch.tensor(x))
    jidx, jdist = jd.knn(x, x, k + 1, tile=64)
    is_self = jidx == np.arange(n)[:, None]
    is_self[np.cumsum(is_self, axis=1) > 1] = False
    order = np.argsort(is_self, axis=1, kind="stable")
    jidx = np.take_along_axis(jidx, order, 1)[:, :k].astype(np.int32)
    d = np.take_along_axis(jdist, order, 1)[:, :k]
    # equal, except where two neighbours lie within rounding of each
    # other (the two packages' f32 distances order such a pair either way)
    for r, c in zip(*np.nonzero(idx.numpy() != jidx)):
        gaps = np.abs(d[r] - d[r, c])
        assert np.sort(gaps)[1] < DIST_TOL, (r, c)
    # the affinities from here on: both packages on JAX's neighbours
    idx = torch.tensor(jidx.astype(np.int64))
    p = pt._p_sparse(torch.tensor(d * d), 10.0)
    jp = jt._p_sparse(jnp.asarray(d * d), 10.0)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=P_TOL)
    for r0 in range(0, n, 64):
        ps, mu = pt._symmetrize_block(idx[r0:r0 + 64], p[r0:r0 + 64], r0,
                                      idx, p, n)
        jps, jmu = jt._symmetrize_block(
            jnp.asarray(jidx)[r0:r0 + 64], jp[r0:r0 + 64], jnp.int32(r0),
            jnp.asarray(jidx), jp, n)
        np.testing.assert_allclose(ps.numpy(), np.asarray(jps),
                                   atol=PSYM_TOL)
        np.testing.assert_array_equal(mu.numpy(), np.asarray(jmu))
    assert not mutual.all() and mutual.any()
    assert psym.shape == p.shape and (psym >= 1e-12).all()


def _step_err(a, b):
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("method", ["exact", "chunked"])
def test_tsne_loop_step_by_step_matches_jax(rng, method):
    """A 50-iteration loop at N = 200 from one y0: at every iteration the
    JAX step and the port's step, on the port's current state, agree
    within STEP_TOL (and their KL within GRAD_TOL); the loop is the one
    `fit_transform` runs (its result equals the hand loop's bits)."""
    x = _tsne_data(rng)
    n = x.shape[0]
    t = Tsne(perplexity=10.0, max_iter=50, method=method, row_block=64,
             device="cpu")
    y0 = t.initial_embedding(n)
    if method == "exact":
        pc = pt._p_conditional(torch.tensor(x), 10.0)
        p = torch.clamp_min((pc + pc.T) / (2.0 * n), 1e-12)
        y, vel = y0.clone(), torch.zeros_like(y0)
        for it in range(50):
            ex, mom = t._schedule(it)
            jg, jkl = jt._tsne_grad(jnp.asarray(y.numpy()),
                                    jnp.asarray(p.numpy()), ex)
            jv = mom * jnp.asarray(vel.numpy()) - 200.0 * jg
            jy = jnp.asarray(y.numpy()) + jv
            jy = np.asarray(jy - jnp.mean(jy, axis=0))
            g, kl = pt._tsne_grad(y, p, ex)
            vel = mom * vel - 200.0 * g
            y = y + vel
            y = y - torch.mean(y, dim=0)
            assert _step_err(y.numpy(), jy) < STEP_TOL, it
            assert float(kl) == pytest.approx(float(jkl), rel=GRAD_TOL)
        got = y.numpy()
    else:
        idx, psym, mutual = t.sparse_affinities(torch.tensor(x))
        n_pad = 256
        y = torch.cat([y0, torch.full((n_pad - n, 2), 1e6)])
        vel = torch.zeros_like(y)
        jargs = (jnp.asarray(idx.numpy().astype(np.int32)),
                 jnp.asarray(psym.numpy()), jnp.asarray(mutual.numpy()))
        for it in range(50):
            ex, mom = t._schedule(it)
            # copies: the JAX step donates its y/vel buffers
            jy, _, jkl = jt._chunked_step(
                jnp.array(y.numpy().copy()), jnp.array(vel.numpy().copy()),
                *jargs, jnp.float32(ex), jnp.float32(mom),
                jnp.float32(200.0), 64, n)
            y, vel, kl = pt._chunked_step(y, vel, idx, psym, mutual, ex,
                                          mom, 200.0, 64, n)
            assert _step_err(y[:n].numpy(), np.asarray(jy)[:n]) \
                < STEP_TOL, it
            assert float(kl) == pytest.approx(float(jkl), rel=GRAD_TOL)
            # sentinel rows stay put with zero velocity
            assert (y[n:] == 1e6).all() and (vel[n:] == 0).all()
        got = y[:n].numpy()
    emb = t.fit_transform(x)
    np.testing.assert_array_equal(emb, got)
    assert t.kl_ == pytest.approx(float(kl), rel=0, abs=0)


def test_nearest_neighbors_server_client(rng):
    """REST k-NN microservice round trip (ref nearestneighbor-server/
    -client modules); the JSON records are the JAX package's."""
    corpus = rng.normal(size=(150, 6)).astype(np.float32)
    server = NearestNeighborsServer(corpus, port=0, device="cpu").start()
    try:
        client = NearestNeighborsClient(
            f"http://127.0.0.1:{server.port}")
        st = client.status()
        assert st == {"num_points": 150, "dims": 6, "metric": "euclidean"}
        q = rng.normal(size=(6,))
        idx, dist = client.knn(q, k=5)
        brute = np.linalg.norm(corpus - q.astype(np.float32), axis=1)
        np.testing.assert_array_equal(idx, np.argsort(brute)[:5])
        qs = rng.normal(size=(3, 6))
        batch = client.knn_batch(qs, k=2)
        assert len(batch) == 3 and len(batch[0]["indices"]) == 2
        jidx, jdist = jd.knn(qs.astype(np.float32), corpus, k=2)
        assert [r["indices"] for r in batch] == jidx.tolist()
        np.testing.assert_allclose([r["distances"] for r in batch], jdist,
                                   rtol=DIST_TOL, atol=DIST_TOL)
        with pytest.raises(ServingError) as ei:
            client._exchange("POST", "/nope", {"points": [[0.0] * 6]})
        assert ei.value.status == 400 and "no route" in ei.value.message
    finally:
        server.stop()
    with pytest.raises(ConnectionError):
        NearestNeighborsClient(f"http://127.0.0.1:{server.port}",
                               timeout=2.0).status()


def test_tsne_chunked_matches_exact(rng):
    """The streamed tier reproduces the exact tier's embedding quality
    on an overlap-sized problem: similar KL, the same cluster
    structure."""
    n_per = 200
    centers = np.array([[8, 0, 0], [0, 8, 0], [0, 0, 8]], np.float32)
    x = np.concatenate(
        [rng.normal(size=(n_per, 3)).astype(np.float32) + c
         for c in centers])
    labels = np.repeat(np.arange(3), n_per)

    def sep(y):
        cents = np.stack([y[labels == i].mean(0) for i in range(3)])
        intra = np.mean(
            [np.linalg.norm(y[labels == i] - cents[i], axis=1).mean()
             for i in range(3)])
        inter = np.mean([np.linalg.norm(cents[i] - cents[j])
                         for i in range(3) for j in range(i + 1, 3)])
        return intra / inter

    kls = {}
    for method in ("exact", "chunked"):
        t = Tsne(perplexity=20, max_iter=150, seed=3, method=method,
                 row_block=128, device="cpu")
        y = t.fit_transform(x)
        assert sep(y) < 0.5, f"{method} failed to separate clusters"
        kls[method] = t.kl_
    # chunked P is KNN-sparse, exact is dense: KLs agree to ~15%
    assert abs(kls["chunked"] - kls["exact"]) < 0.15 * kls["exact"] + 0.1


def test_tsne_chunked_padding_and_method_guard(rng):
    """row_block that doesn't divide N exercises the sentinel-row
    padding; bad method names raise; without a card the default device
    raises."""
    x = rng.normal(size=(300, 4)).astype(np.float32)
    t = Tsne(perplexity=10, max_iter=60, seed=1, method="chunked",
             row_block=128, device="cpu")   # pads 300 -> 384
    y = t.fit_transform(x)
    assert y.shape == (300, 2) and np.all(np.isfinite(y))
    assert np.isfinite(t.kl_)
    with pytest.raises(ValueError):
        Tsne(method="dense")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Tsne(max_iter=1).fit_transform(x)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            knn(x, x, 2)
