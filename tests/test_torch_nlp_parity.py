"""The port's embedding trainers and graph embeddings
(deeplearning4j_tpu_torch/nlp/, graph/) against the JAX package's, on
the CPU, from the same seeds.

Equal exactly (the host side is the JAX package's code, and every random
draw happens there in the same order): vocab order and counts, Huffman
codes and points, the initial tables, the alias tables, the packed slabs
and their lrs (native and NumPy fallback), the walks, the tokenizers' and
vectorizers' outputs, and both loaders' `native.available()` (the
fallback draws another random stream).

Within TABLE_TOL of max(1, max|JAX table|) after a fit (f32; the two
packages round the batched dot products and the scatter sums in other
orders, by a few 1e-6 over these runs): syn0/syn1/syn1neg for
skip-gram/CBOW x negative sampling/hierarchical softmax in both tiers,
GloVe, PV-DBOW and PV-DM (with the doc vectors), infer_vector, DeepWalk
and Node2Vec.

Serializer files written by either package read in the other;
`vectors_from_arrays` gives the JAX model's words_nearest and continues
a fit from the JAX package's state; a deliberately duplicated scatter
pins the summing (and capping) semantics.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.graph as jg
import deeplearning4j_tpu.nlp as jn
from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.nlp import sequence_vectors as jsv
from deeplearning4j_tpu.nlp.sentence_iterator import (
    LabelledDocument as JDoc,
    MovingWindowIterator as JMovingWindow,
)
from deeplearning4j_tpu.nlp.tokenization import (
    EndingPreProcessor as JEnding,
    NGramTokenizerFactory as JNGram,
)
from deeplearning4j_tpu.nlp.vocab import (
    AbstractCache as JCache,
    build_huffman as j_huffman,
)

import deeplearning4j_tpu_torch.graph as tg
import deeplearning4j_tpu_torch.nlp as tn
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch.nlp import sequence_vectors as tsv
from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    LabelledDocument as TDoc,
    MovingWindowIterator as TMovingWindow,
)
from deeplearning4j_tpu_torch.nlp.serializer import vectors_from_arrays
from deeplearning4j_tpu_torch.nlp.tokenization import (
    EndingPreProcessor as TEnding,
    NGramTokenizerFactory as TNGram,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    AbstractCache as TCache,
    build_huffman as t_huffman,
)

TABLE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topics(n=300, seed=5):
    """tests/test_nlp.py's two-topic corpus, as token lists."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "cow", "sheep", "goat"]
    tech = ["cpu", "gpu", "ram", "disk", "cache", "bus"]
    return [list(rng.choice(animals if rng.random() < 0.5 else tech,
                            size=8)) for _ in range(n)]


def _zipf(vocab=2500, n=20000, seq=200, seed=0):
    """bench.py word2vec's zipf-1.1 corpus, cut down."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    p /= p.sum()
    c = rng.choice(vocab, size=n, p=p)
    return [[f"w{i}" for i in c[k:k + seq]] for k in range(0, n, seq)]


def _close(want, got, what=""):
    want = np.asarray(want)
    got = np.asarray(got)
    assert want.shape == got.shape, what
    err = float(np.abs(want - got).max()) if want.size else 0.0
    lim = TABLE_TOL * max(1.0, float(np.abs(want).max()))
    assert err <= lim, f"{what}: {err:.3e} > {lim:.3e}"


def _tables_close(j, t):
    for name in ("syn0", "syn1", "syn1neg"):
        a, b = getattr(j, name), getattr(t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b, name)


MODES = {"sg-ns": dict(negative=5, use_hierarchic_softmax=False,
                       use_cbow=False),
         "sg-hs": dict(negative=0, use_hierarchic_softmax=True,
                       use_cbow=False),
         "cbow-ns": dict(negative=5, use_hierarchic_softmax=False,
                         use_cbow=True),
         "cbow-hs": dict(negative=0, use_hierarchic_softmax=True,
                         use_cbow=True),
         "sg-ns+hs": dict(negative=3, use_hierarchic_softmax=True,
                          use_cbow=False)}


def _pair(mode, tier, **kw):
    args = dict(layer_size=16, window=3, epochs=2, seed=3, mode=tier,
                dense_batch_size=256, **MODES[mode])
    args.update(kw)
    return jsv.SequenceVectors(**args), tsv.SequenceVectors(device="cpu",
                                                            **args)


# ------------------------------------------------------------ host side


def test_native_loaders_agree():
    assert jnative.available() == tnative.available()


@pytest.mark.parametrize("corpus", ["topics", "zipf"])
def test_vocab_huffman_and_initial_tables_equal(corpus):
    seqs = _topics() if corpus == "topics" else _zipf()
    j, t = _pair("sg-ns+hs", "dense")
    j.build_vocab(seqs)
    t.build_vocab(seqs)
    assert j.vocab.words() == t.vocab.words()
    np.testing.assert_array_equal(j.vocab.counts(), t.vocab.counts())
    assert j._max_code_len == t._max_code_len
    for a, b in zip(j.vocab.vocab_words(), t.vocab.vocab_words()):
        assert (a.codes, a.points, a.index) == (b.codes, b.points, b.index)
    for name in ("syn0", "syn1", "syn1neg"):
        np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
    np.testing.assert_array_equal(j._unigram, t._unigram)
    for a, b in zip(j._alias_tables(), t._alias_tables()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(j._hs_device_tables(), t._hs_device_tables()):
        np.testing.assert_array_equal(a, b)


def test_huffman_of_a_handmade_cache_equal():
    jc, tc = JCache(min_word_frequency=2), TCache(min_word_frequency=2)
    for tok in "a a a a b b b c c d e e f f f f f".split():
        jc.add_token(tok)
        tc.add_token(tok)
    jc.finalize_vocab()
    tc.finalize_vocab()
    assert j_huffman(jc) == t_huffman(tc)
    assert [(w.word, w.codes, w.points) for w in jc.vocab_words()] == \
        [(w.word, w.codes, w.points) for w in tc.vocab_words()]


def _slabs(sv, seqs):
    """Every (rows, lrs) the dense fit ships, with the device work cut
    out."""
    got = []

    def spy(tables, rows, lrs, W, hs_tabs):
        got.append((np.array(rows), np.array(lrs)))
        return tables

    sv._dispatch_slab = spy
    sv.fit(seqs)
    return got


@pytest.mark.parametrize("packer", ["native", "fallback"])
@pytest.mark.parametrize("mode", ["sg-ns", "sg-hs", "cbow-ns", "cbow-hs"])
def test_packed_slabs_equal(monkeypatch, mode, packer):
    if packer == "native" and not tnative.available():
        pytest.skip("the native library is not built on this host")
    if packer == "fallback":
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "w2v_sg_pack", lambda *a, **k: None)
            monkeypatch.setattr(mod, "w2v_cbow_pack", lambda *a, **k: None)
    seqs = _zipf(n=12000)
    j, t = _pair(mode, "dense", sampling=1e-3)
    js, ts = _slabs(j, seqs), _slabs(t, seqs)
    assert len(js) == len(ts) and len(js) >= 2
    for (jr, jl), (tr, tl) in zip(js, ts):
        assert jr.dtype == tr.dtype == np.int16
        np.testing.assert_array_equal(jr, tr)
        np.testing.assert_array_equal(jl, tl)


def test_tokenizers_iterators_and_vectorizers_equal(tmp_path):
    text = "The Cat's 3 dogs, running! Horses-and ponies; the END."
    for pre in (jn.CommonPreprocessor, jn.StopWordsPreProcessor):
        jt = jn.DefaultTokenizerFactory().set_token_pre_processor(pre())
        tt = tn.DefaultTokenizerFactory().set_token_pre_processor(
            getattr(tn, pre.__name__)())
        assert jt.create(text).get_tokens() == tt.create(text).get_tokens()
    jt = jn.DefaultTokenizerFactory().set_token_pre_processor(JEnding())
    tt = tn.DefaultTokenizerFactory().set_token_pre_processor(TEnding())
    assert jt.create(text).get_tokens() == tt.create(text).get_tokens()
    assert (JNGram(jn.DefaultTokenizerFactory(), 1, 3).create(text)
            .get_tokens() == TNGram(tn.DefaultTokenizerFactory(), 1, 3)
            .create(text).get_tokens())
    assert jn.StopWords.get_stop_words() == tn.StopWords.get_stop_words()
    sents = [" ".join(s) for s in _topics(n=30)]
    assert (list(JMovingWindow(sents, jn.DefaultTokenizerFactory(), 5))
            == list(TMovingWindow(sents, tn.DefaultTokenizerFactory(), 5)))
    (tmp_path / "lines.txt").write_text("\n".join(sents[:5]) + "\n\n")
    assert (list(jn.BasicLineIterator(tmp_path / "lines.txt"))
            == list(tn.BasicLineIterator(tmp_path / "lines.txt")))
    docs = sents + ["cpu and gpu", "the cat sat"]
    for cls in ("BagOfWordsVectorizer", "TfidfVectorizer"):
        np.testing.assert_array_equal(
            getattr(jn, cls)().fit_transform(docs),
            getattr(tn, cls)().fit_transform(docs))


@pytest.mark.parametrize("kind", ["uniform", "weighted", "node2vec"])
def test_walks_equal(kind):
    rng = np.random.default_rng(9)
    jgr, tgr = jg.Graph(40), tg.Graph(40)
    for _ in range(120):
        a, b = (int(v) for v in rng.integers(0, 40, 2))
        w = float(rng.uniform(0.1, 3.0))
        jgr.add_edge(a, b, weight=w)
        tgr.add_edge(a, b, weight=w)
    if kind == "uniform":
        jw = jg.RandomWalkIterator(jgr, 12, 3, seed=4)
        tw = tg.RandomWalkIterator(tgr, 12, 3, seed=4)
    elif kind == "weighted":
        jw = jg.WeightedRandomWalkIterator(jgr, 12, 3, seed=4)
        tw = tg.WeightedRandomWalkIterator(tgr, 12, 3, seed=4)
    else:
        jw = jg.Node2VecWalkIterator(jgr, 12, 3, p=0.5, q=2.0, seed=4)
        tw = tg.Node2VecWalkIterator(tgr, 12, 3, p=0.5, q=2.0, seed=4)
    assert list(jw) == list(tw)


def test_edge_list_loaders_equal(tmp_path):
    p = tmp_path / "e.csv"
    p.write_text("# c\n0,1,0.5\n1,2,2.5\n2,0,1.0\n3,1,4.0\n")
    for fn in ("load_delimited_edge_list", "load_weighted_edge_list"):
        a, b = getattr(jg, fn)(str(p), 4), getattr(tg, fn)(str(p), 4)
        for v in range(4):
            assert ([(e.to, e.weight) for e in a.edges_from(v)]
                    == [(e.to, e.weight) for e in b.edges_from(v)])


# ------------------------------------------------------- device steps


def test_duplicate_scatter_sums_and_caps():
    """Duplicate indices sum, as `.at[idx].add` does (`t[idx] += x` would
    keep one); past _DUP_CAP occurrences the sum is rescaled to the cap;
    the same table as the JAX package's."""
    import jax.numpy as jnp

    idx = np.array([1, 1, 1, 2] + [3] * 20 + [0], np.int64)
    rows = np.ones((idx.size, 4), np.float32)
    rows[-1] = 5.0
    base = np.zeros((5, 4), np.float32)
    got = tsv._dedup_scatter_add(torch.tensor(base), torch.tensor(idx),
                                 torch.tensor(rows)).numpy()
    want = np.zeros((5, 4), np.float32)
    want[0], want[1], want[2], want[3] = 5.0, 3.0, 1.0, tsv._DUP_CAP
    # rows 0-2 exactly; row 3 is 20 rows scaled by 8/20 (f32 rounding)
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    ref = np.asarray(jsv._dedup_scatter_add(
        jnp.asarray(base), jnp.asarray(idx, jnp.int32), jnp.asarray(rows)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    # random rows with heavy duplication, against the JAX package
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.zipf(1.5, 4000).clip(1, 50).astype(np.int64) - 1
    rows = rng.normal(size=(idx.size, 8)).astype(np.float32)
    ref = np.asarray(jsv._dedup_scatter_add(
        jnp.asarray(table), jnp.asarray(idx, jnp.int32), jnp.asarray(rows)))
    got = tsv._dedup_scatter_add(torch.tensor(table), torch.tensor(idx),
                                 torch.tensor(rows)).numpy()
    _close(ref, got, "capped scatter")


def test_scan_step_sums_duplicates_in_a_chunk():
    """The scan tier's steps sum duplicate rows inside a chunk and chain
    chunks, as the JAX step's scan does."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    syn0 = rng.normal(size=(6, 8)).astype(np.float32) * 0.3
    syn1 = rng.normal(size=(6, 8)).astype(np.float32) * 0.3
    center = np.array([0, 0, 0, 1, 0, 0, 2, 2], np.int64)
    ctx = rng.integers(0, 3, (8, 4)).astype(np.int64)
    labels = np.zeros((8, 4), np.float32)
    labels[:, 0] = 1.0
    j0, j1, jl = jsv._NegSamplingStep(chunk=4)(
        jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(center, jnp.int32),
        jnp.asarray(ctx, jnp.int32), jnp.asarray(labels), jnp.float32(0.5))
    t0, t1, tl = tsv._NegSamplingStep(chunk=4)(
        torch.tensor(syn0), torch.tensor(syn1), torch.tensor(center),
        torch.tensor(ctx), torch.tensor(labels), 0.5)
    _close(np.asarray(j0), t0.numpy(), "syn0")
    _close(np.asarray(j1), t1.numpy(), "syn1neg")
    assert abs(float(jl) - float(tl)) <= 1e-5


# ------------------------------------------------------------ fits


@pytest.mark.parametrize("tier", ["scan", "dense"])
@pytest.mark.parametrize("mode", list(MODES))
def test_fit_tables_within_tolerance(mode, tier):
    seqs = _zipf(n=8000) if tier == "scan" else _zipf()
    j, t = _pair(mode, tier)
    j.fit(seqs)
    t.fit(seqs)
    _tables_close(j, t)


def test_dense_fit_of_the_topic_corpus_within_tolerance():
    """Twelve words in batches of 128: every word repeats in every batch
    (the capped scatter's regime)."""
    seqs = _topics()
    j, t = _pair("sg-ns", "dense", dense_batch_size=128, epochs=3)
    j.fit(seqs)
    t.fit(seqs)
    _tables_close(j, t)


def test_glove_within_tolerance():
    seqs = _topics(n=200)
    kw = dict(layer_size=16, window=4, epochs=5, batch_size=128,
              learning_rate=0.1, seed=5)
    j = jn.Glove(**kw).fit(seqs)
    t = tn.Glove(device="cpu", **kw).fit(seqs)
    _close(j.syn0, t.syn0, "glove")


@pytest.mark.parametrize("algo", ["dbow", "dm"])
def test_paragraph_vectors_and_infer_within_tolerance(algo):
    sents = [" ".join(s) for s in _topics(n=60)]
    j = (jn.ParagraphVectors.Builder().layer_size(12).negative_sample(5)
         .epochs(3).seed(4).sequence_learning_algorithm(algo).build())
    t = (tn.ParagraphVectors.Builder().layer_size(12).negative_sample(5)
         .epochs(3).seed(4).sequence_learning_algorithm(algo)
         .device("cpu").build())
    j.fit([JDoc(s, [f"D{i}"]) for i, s in enumerate(sents)])
    t.fit([TDoc(s, [f"D{i}"]) for i, s in enumerate(sents)])
    assert j.labels == t.labels
    for name in ("syn0", "syn1neg", "doc_vectors"):
        _close(getattr(j, name), getattr(t, name), name)
    # a long text: several chunks per step, each seeing the one before
    text = "cat dog horse cow sheep goat " * 12
    _close(j.infer_vector(text), t.infer_vector(text), "infer_vector")
    assert abs(j.similarity_doc("D0", "D1")
               - t.similarity_doc("D0", "D1")) <= 1e-4


def _two_cliques(G):
    g = G(10)
    for i in range(5):
        for k in range(i + 1, 5):
            g.add_edge(i, k)
            g.add_edge(i + 5, k + 5)
    g.add_edge(4, 5)
    return g


@pytest.mark.parametrize("kind", ["deepwalk", "node2vec"])
def test_graph_embeddings_within_tolerance(kind):
    kw = dict(vector_size=16, window_size=3, learning_rate=0.05, seed=7)
    if kind == "deepwalk":
        j, t = jg.DeepWalk(**kw), tg.DeepWalk(device="cpu", **kw)
    else:
        j = jg.Node2Vec(p=0.5, q=2.0, **kw)
        t = tg.Node2Vec(p=0.5, q=2.0, device="cpu", **kw)
    j.fit_graph(_two_cliques(jg.Graph), 20, 20)
    t.fit_graph(_two_cliques(tg.Graph), 20, 20)
    _tables_close(j._sv, t._sv)
    assert set(j.verts_nearest(0, 4)) == set(t.verts_nearest(0, 4))


def test_dense_deepwalk_within_tolerance():
    """Above 2048 vertices DeepWalk takes the dense tier's HS body."""
    rng = np.random.default_rng(3)
    n = 2100
    edges = rng.integers(0, n, (6000, 2))
    graphs = [jg.Graph(n), tg.Graph(n)]
    for a, b in edges:
        for g in graphs:
            g.add_edge(int(a), int(b))
    kw = dict(vector_size=8, window_size=3, seed=2)
    j, t = jg.DeepWalk(**kw), tg.DeepWalk(device="cpu", **kw)
    j.fit_graph(graphs[0], 10, 1)
    t.fit_graph(graphs[1], 10, 1)
    assert t._sv._dense and t._sv.syn1neg is None
    _tables_close(j._sv, t._sv)


# ------------------------------------------------- carrying state across


def _trained_jax(tier):
    j = jsv.SequenceVectors(layer_size=16, window=3, epochs=1, seed=3,
                            mode=tier, dense_batch_size=256,
                            **MODES["sg-ns+hs"])
    j.fit(_zipf())
    return j


@pytest.fixture(scope="module")
def jax_dense():
    """A trained JAX model, shared: the tests read it and copy its
    tables, never write them."""
    return _trained_jax("dense")


@pytest.fixture(scope="module")
def jax_scan():
    return _trained_jax("scan")


def test_vectors_from_arrays_words_nearest(jax_dense):
    j = jax_dense
    t = vectors_from_arrays(j.vocab.words(), j.vocab.counts(), j.syn0,
                            j.syn1, j.syn1neg, device="cpu")
    assert t.vocab.words() == j.vocab.words()
    np.testing.assert_array_equal(t.syn0, j.syn0)
    for w in ("w0", "w3", "w17", "w150"):
        jn_, tn_ = j.words_nearest(w, 10), t.words_nearest(w, 10)
        if jn_ != tn_:   # ties may order differently: compare as sets
            assert set(jn_) == set(tn_), w
        assert abs(j.similarity(w, "w1") - t.similarity(w, "w1")) <= 1e-6


@pytest.mark.parametrize("tier", ["scan", "dense"])
def test_fit_continues_from_the_same_state(jax_dense, tier):
    """Both packages continue from the JAX package's trained tables: the
    port through vectors_from_arrays, JAX through its own tables."""
    seqs = _zipf(n=6000, seed=1)
    j0 = jax_dense
    j = jsv.SequenceVectors(layer_size=16, window=3, epochs=1, seed=11,
                            mode=tier, dense_batch_size=256,
                            **MODES["sg-ns+hs"])
    j.vocab = j0.vocab
    j._max_code_len = j0._max_code_len
    j._unigram, j._unigram_cdf = j0._unigram, j0._unigram_cdf
    j.syn0, j.syn1 = np.array(j0.syn0), np.array(j0.syn1)
    j.syn1neg = np.array(j0.syn1neg)
    t = vectors_from_arrays(j0.vocab.words(), j0.vocab.counts(), j0.syn0,
                            j0.syn1, j0.syn1neg, device="cpu")
    t.window, t.negative, t.seed, t.epochs = 3, 3, 11, 1
    t._mode, t.dense_batch_size = tier, 256
    assert t._max_code_len == j._max_code_len
    np.testing.assert_array_equal(t._unigram, j._unigram)
    j.fit(seqs)
    t.fit(seqs)
    _tables_close(j, t)


@pytest.mark.parametrize("fmt", ["text", "text.gz", "binary", "full"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serializer_files_cross(jax_scan, tmp_path, fmt, writer):
    j = jax_scan
    t = vectors_from_arrays(j.vocab.words(), j.vocab.counts(), j.syn0,
                            j.syn1, j.syn1neg, device="cpu")
    src, dst = ((j, tn.WordVectorSerializer) if writer == "jax"
                else (t, jn.WordVectorSerializer))
    wsrc = (jn.WordVectorSerializer if writer == "jax"
            else tn.WordVectorSerializer)
    p = tmp_path / {"text": "v.txt", "text.gz": "v.txt.gz",
                    "binary": "v.bin", "full": "m.npz"}[fmt]
    if fmt.startswith("text"):
        wsrc.write_word_vectors(src, p)
        got = dst.read_word_vectors(p)
        atol = 1e-6
    elif fmt == "binary":
        wsrc.write_word_vectors_binary(src, p)
        got = dst.read_word_vectors_binary(p)
        atol = 0.0
    else:
        wsrc.write_full_model(src, p)
        got = dst.read_full_model(p)
        atol = 0.0
        np.testing.assert_array_equal(got.syn1, j.syn1)
        np.testing.assert_array_equal(got.syn1neg, j.syn1neg)
        np.testing.assert_array_equal(got.vocab.counts(), j.vocab.counts())
    # the binary reader indexes its vocab alphabetically (all counts 1):
    # compare word by word
    assert sorted(got.vocab.words()) == sorted(j.vocab.words())
    if fmt != "binary":
        assert got.vocab.words() == j.vocab.words()
    for w in j.vocab.words():
        np.testing.assert_allclose(got.get_word_vector(w),
                                   j.get_word_vector(w), rtol=0, atol=atol)
    # the bytes are the same whichever package writes them
    if fmt in ("text", "binary"):
        q = tmp_path / ("other" + p.suffix)
        other, model = ((tn.WordVectorSerializer, t) if writer == "jax"
                        else (jn.WordVectorSerializer, j))
        write = (other.write_word_vectors if fmt == "text"
                 else other.write_word_vectors_binary)
        write(model, q)
        assert q.read_bytes() == p.read_bytes()
