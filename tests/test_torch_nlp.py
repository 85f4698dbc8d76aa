"""The port's NLP package (deeplearning4j_tpu_torch/nlp/) on its own, on
the CPU: the counterparts of tests/test_nlp.py — vocab/Huffman,
tokenization, Word2Vec semantic quality in both tiers and all four modes,
ParagraphVectors, GloVe, serialization, vectorizers, the native packers,
the packer thread's bit-identity and the int16 wire (ref: deeplearning4j-nlp
tests assert similarity rankings on a corpus). Every trainer runs with
device="cpu"; tests/test_torch_nlp_parity.py holds the port against the
JAX package."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nlp import (
    BagOfWordsVectorizer,
    CollectionSentenceIterator,
    CommonPreprocessor,
    DefaultTokenizerFactory,
    Glove,
    ParagraphVectors,
    TfidfVectorizer,
    Word2Vec,
    WordVectorSerializer,
)
from deeplearning4j_tpu_torch.nlp.sentence_iterator import LabelledDocument
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, build_huffman


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Small tensors: one intra-op thread runs them fastest, and test
    processes sharing the cores (pytest-xdist) do not wait on each
    other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n=300, seed=5):
    """Two-topic synthetic corpus: animal words co-occur, tech words
    co-occur — embeddings must separate the clusters."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "cow", "sheep", "goat"]
    tech = ["cpu", "gpu", "ram", "disk", "cache", "bus"]
    sents = []
    for _ in range(n):
        words = rng.choice(animals if rng.random() < 0.5 else tech,
                           size=8, replace=True)
        sents.append(" ".join(words))
    return sents, animals, tech


def test_vocab_and_huffman():
    cache = AbstractCache(min_word_frequency=2)
    for tok in ("a a a a b b b c c d".split()):
        cache.add_token(tok)
    cache.finalize_vocab()
    assert cache.words() == ["a", "b", "c"]  # d dropped (freq 1)
    assert cache.index_of("a") == 0
    max_len = build_huffman(cache)
    assert max_len >= 1
    # most frequent word has the shortest code
    wa = cache.word_for("a")
    wc = cache.word_for("c")
    assert len(wa.codes) <= len(wc.codes)


def test_tokenizer_preprocessing():
    tf = DefaultTokenizerFactory()
    tf.set_token_pre_processor(CommonPreprocessor())
    toks = tf.create("Hello, World! 123 foo-bar").get_tokens()
    assert "hello" in toks and "world" in toks
    assert all("!" not in t and "," not in t for t in toks)


@pytest.mark.parametrize(
    "mode", ["negative", "hs", "cbow-negative", "cbow-hs"])
def test_word2vec_semantic_clusters(mode):
    sents, animals, tech = _corpus()
    w2v = (Word2Vec.Builder()
           .layer_size(24).window_size(4)
           .negative_sample(5 if mode.endswith("negative") else 0)
           .use_hierarchic_softmax(mode.endswith("hs"))
           .elements_learning_algorithm(
               "CBOW" if mode.startswith("cbow") else "SkipGram")
           .min_word_frequency(1).epochs(3).batch_size(256).seed(1)
           .device("cpu")
           .iterate(CollectionSentenceIterator(sents))
           .build())
    w2v.fit()
    assert w2v.has_word("cat") and w2v.has_word("cpu")
    # intra-cluster similarity dominates inter-cluster
    intra = np.mean([w2v.similarity("cat", "dog"),
                     w2v.similarity("cpu", "gpu")])
    inter = np.mean([w2v.similarity("cat", "cpu"),
                     w2v.similarity("dog", "ram")])
    assert intra > inter + 0.2, (intra, inter)
    # nearest neighbors of an animal are animals
    near = w2v.words_nearest("horse", top_n=3)
    assert sum(w in animals for w in near) >= 2, near


def test_word2vec_serialization_round_trip(tmp_path):
    sents, _, _ = _corpus(n=50)
    w2v = (Word2Vec.Builder().layer_size(8).epochs(1).seed(2)
           .device("cpu")
           .iterate(CollectionSentenceIterator(sents)).build())
    w2v.fit()
    p = tmp_path / "vecs.txt"
    WordVectorSerializer.write_word_vectors(w2v, p)
    loaded = WordVectorSerializer.read_word_vectors(p)
    assert loaded.vocab.num_words() == w2v.vocab.num_words()
    np.testing.assert_allclose(loaded.get_word_vector("cat"),
                               w2v.get_word_vector("cat"), atol=1e-5)
    # native full-model round trip
    p2 = tmp_path / "model.npz"
    WordVectorSerializer.write_full_model(w2v, p2)
    full = WordVectorSerializer.read_full_model(p2)
    np.testing.assert_array_equal(full.syn0, w2v.syn0)
    assert full.vocab.word_at_index(0) == w2v.vocab.word_at_index(0)


def test_paragraph_vectors_dbow_separates_topics():
    sents, _, _ = _corpus(n=80)
    docs = [LabelledDocument(s, [f"DOC_{i}"]) for i, s in enumerate(sents)]
    pv = (ParagraphVectors.Builder()
          .layer_size(16).negative_sample(5).epochs(5).seed(3)
          .device("cpu")
          .iterate(docs).build())
    pv.fit()
    # doc vectors of same-topic docs should be closer than cross-topic
    def topic(s):
        return "animal" if "cat" in s or "dog" in s or "horse" in s \
            or "cow" in s or "sheep" in s or "goat" in s else "tech"
    sims_intra, sims_inter = [], []
    for i in range(0, 40):
        for j in range(i + 1, 40):
            s = pv.similarity_doc(f"DOC_{i}", f"DOC_{j}")
            (sims_intra if topic(sents[i]) == topic(sents[j])
             else sims_inter).append(s)
    assert np.mean(sims_intra) > np.mean(sims_inter), (
        np.mean(sims_intra), np.mean(sims_inter))


def test_paragraph_vectors_infer(tmp_path):
    sents, _, _ = _corpus(n=60)
    docs = [LabelledDocument(s, [f"DOC_{i}"]) for i, s in enumerate(sents)]
    pv = (ParagraphVectors.Builder()
          .layer_size(12).negative_sample(5).epochs(3).seed(4)
          .device("cpu")
          .iterate(docs).build())
    pv.fit()
    v = pv.infer_vector("cat dog horse cow")
    assert v.shape == (12,) and np.any(v != 0)


def test_glove_clusters():
    sents, animals, tech = _corpus(n=200)
    seqs = [s.split() for s in sents]
    glove = Glove(layer_size=16, window=4, epochs=20, batch_size=128,
                  learning_rate=0.1, seed=5, device="cpu")
    glove.fit(seqs)
    intra = glove.similarity("cat", "dog")
    inter = glove.similarity("cat", "cpu")
    assert intra > inter, (intra, inter)


def test_bow_tfidf():
    docs = ["the cat sat", "the dog sat", "cpu and gpu"]
    bow = BagOfWordsVectorizer()
    m = bow.fit_transform(docs)
    assert m.shape[0] == 3
    i_the = bow.vocab.index_of("the")
    assert m[0, i_the] == 1.0 and m[2, i_the] == 0.0
    tfidf = TfidfVectorizer()
    t = tfidf.fit_transform(docs)
    # 'the' (2 docs) weighted below 'cpu' (1 doc) within doc 2
    i_cpu = tfidf.vocab.index_of("cpu")
    assert t[2, i_cpu] > t[0, tfidf.vocab.index_of("the")]


def test_stopwords_preprocessor():
    from deeplearning4j_tpu_torch.nlp import (
        CommonPreprocessor,
        DefaultTokenizerFactory,
        StopWords,
        StopWordsPreProcessor,
    )

    assert "the" in StopWords.get_stop_words()
    tf = DefaultTokenizerFactory()
    tf.set_token_pre_processor(
        StopWordsPreProcessor(base=CommonPreprocessor()))
    toks = tf.create("The cat and the dog!").get_tokens()
    assert toks == ["cat", "dog"]


def test_moving_window_iterator():
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import MovingWindowIterator
    from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory

    wins = list(MovingWindowIterator(
        ["the quick brown fox"], DefaultTokenizerFactory(),
        window_size=3))
    assert len(wins) == 4
    assert wins[0]["words"] == ["<s>", "the", "quick"]
    assert wins[0]["focus"] == "the"
    assert wins[-1]["words"] == ["brown", "fox", "</s>"]
    import pytest as _pt

    with _pt.raises(ValueError, match="odd"):
        list(MovingWindowIterator([], DefaultTokenizerFactory(), 4))


def test_file_sentence_iterator(tmp_path):
    from deeplearning4j_tpu_torch.nlp.sentence_iterator import FileSentenceIterator

    (tmp_path / "a.txt").write_text("hello world\n\nsecond line\n")
    (tmp_path / "b.txt").write_text("third\n")
    it = FileSentenceIterator(str(tmp_path))
    assert list(it) == ["hello world", "second line", "third"]
    assert list(it) == ["hello world", "second line", "third"]  # re-iter


@pytest.mark.parametrize(
    "mode", ["negative", "hs", "cbow-negative", "cbow-hs"])
def test_word2vec_dense_tier_semantic_clusters(mode):
    """The dense tier (native epoch builder + slab-scan updates) learns
    the same cluster structure as the scan tier in all four modes."""
    sents, animals, tech = _corpus()
    w2v = (Word2Vec.Builder()
           .layer_size(24).window_size(4)
           .negative_sample(5 if mode.endswith("negative") else 0)
           .use_hierarchic_softmax(mode.endswith("hs"))
           .elements_learning_algorithm(
               "CBOW" if mode.startswith("cbow") else "SkipGram")
           .min_word_frequency(1).epochs(10).seed(1)
           .device("cpu")
           .mode("dense")
           .iterate(CollectionSentenceIterator(sents))
           .build())
    # small batches for the tiny test vocab: large batches put every
    # word in every batch (the duplicate-collapse regime that makes
    # scan the small-vocab default)
    w2v.dense_batch_size = 128
    w2v.fit()
    intra = np.mean([w2v.similarity("cat", "dog"),
                     w2v.similarity("cpu", "gpu")])
    inter = np.mean([w2v.similarity("cat", "cpu"),
                     w2v.similarity("dog", "ram")])
    assert intra > inter + 0.2, (intra, inter)


def test_native_w2v_pack_shapes_and_distribution():
    """The native epoch builders emit well-formed rows: correct window
    structure, in-vocab negatives, and a negative distribution that
    follows the alias tables."""
    from deeplearning4j_tpu_torch import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(0)
    V, n, window, K = 50, 4000, 3, 5
    corpus = rng.integers(0, V, n).astype(np.int32)
    sid = (np.arange(n) // 200).astype(np.int32)   # 200-token sequences
    p = (np.arange(1, V + 1)[::-1] ** 0.75).astype(np.float64)
    p /= p.sum()
    # Vose tables
    prob = np.zeros(V); alias = np.zeros(V, np.int32)
    scaled = p * V
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]; alias[s] = l
        scaled[l] -= 1.0 - scaled[s]
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
    pk = native.w2v_sg_pack(corpus, sid, window, K,
                            prob.astype(np.float32), alias, 7)
    assert pk.shape[1] == 2 + K
    # every row's center/positive are real corpus values, negatives in-vocab
    assert pk.min() >= 0 and pk.max() < V
    # pair count is within the reduced-window envelope
    assert n <= pk.shape[0] <= n * 2 * window
    # negative marginal tracks the unigram^0.75 distribution
    emp = np.bincount(pk[:, 2:].ravel(), minlength=V) / pk[:, 2:].size
    assert np.corrcoef(emp, p)[0, 1] > 0.99
    # determinism: same seed -> same pack
    pk2 = native.w2v_sg_pack(corpus, sid, window, K,
                             prob.astype(np.float32), alias, 7)
    np.testing.assert_array_equal(pk, pk2)
    # cbow layout: context slots either -1 or in-vocab, center col correct
    ck = native.w2v_cbow_pack(corpus, sid, window, K,
                              prob.astype(np.float32), alias, 7)
    assert ck.shape[1] == 2 * window + 1 + K
    assert ck[:, :2 * window].min() >= -1
    assert set(np.unique(ck[:, 2 * window])) <= set(range(V))


def test_word2vec_dense_lazy_tables_and_serialization(tmp_path):
    """Dense-tier tables stay device-resident after fit and materialize
    lazily through the properties; serialization sees numpy arrays."""
    sents, _, _ = _corpus(n=60)
    w2v = (Word2Vec.Builder().layer_size(8).epochs(1).seed(2)
           .device("cpu")
           .mode("dense")
           .iterate(CollectionSentenceIterator(sents)).build())
    w2v.fit()
    assert w2v._syn0_dev is not None or w2v._syn0_host is not None
    arr = w2v.syn0
    assert isinstance(arr, np.ndarray) and arr.ndim == 2
    p = tmp_path / "vecs.txt"
    WordVectorSerializer.write_word_vectors(w2v, p)
    loaded = WordVectorSerializer.read_word_vectors(p)
    np.testing.assert_allclose(loaded.get_word_vector("cat"),
                               w2v.get_word_vector("cat"), atol=1e-5)


def test_word2vec_binary_serialization_round_trip(tmp_path):
    """Google word2vec .bin format round trip (the loadGoogleModel
    binary path of WordVectorSerializer.java)."""
    sents, _, _ = _corpus(n=40)
    w2v = (Word2Vec.Builder().layer_size(12).epochs(1).seed(2)
           .device("cpu")
           .iterate(CollectionSentenceIterator(sents)).build())
    w2v.fit()
    p = tmp_path / "vecs.bin"
    WordVectorSerializer.write_word_vectors_binary(w2v, p)
    loaded = WordVectorSerializer.read_word_vectors_binary(p)
    assert loaded.vocab.num_words() == w2v.vocab.num_words()
    np.testing.assert_allclose(loaded.get_word_vector("cat"),
                               w2v.get_word_vector("cat"), atol=1e-6)
    # words survive byte-exact incl. order-independent lookup
    for w in ("cat", "dog", "cpu"):
        np.testing.assert_allclose(loaded.get_word_vector(w),
                                   w2v.get_word_vector(w), atol=1e-6)


def test_dense_pipelined_packing_bit_identical():
    """pipeline_packing (r5: packer thread + bounded queue) must be
    bit-identical to the inline path — the rng lives on the producer
    in serial order, so threading changes scheduling, not results."""
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors

    sents, _, _ = _corpus()
    seqs = [s.split() for s in sents]

    def run(pipelined):
        sv = SequenceVectors(layer_size=16, window=3, negative=4,
                             epochs=3, seed=5, mode="dense",
                             dense_batch_size=128, device="cpu")
        sv.pipeline_packing = pipelined
        sv.build_vocab(seqs)
        sv.fit(seqs)
        return np.asarray(sv.syn0), np.asarray(sv.syn1neg)

    s0a, s1a = run(True)
    s0b, s1b = run(False)
    np.testing.assert_array_equal(s0a, s0b)
    np.testing.assert_array_equal(s1a, s1b)


def test_dense_int16_wire_trains_and_queries():
    """The sub-32k-vocab int16 wire format (r5) actually ships int16
    rows, and the fitted tables stay finite and queryable."""
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors

    sents, _, _ = _corpus()
    seqs = [s.split() for s in sents]
    sv = SequenceVectors(layer_size=16, window=3, negative=4,
                         epochs=2, seed=5, mode="dense",
                         dense_batch_size=128, device="cpu")
    sv.build_vocab(seqs)
    assert sv.vocab.num_words() < 32768   # int16 wire precondition
    shipped = []
    orig = sv._dispatch_slab

    def spy(tables, rows, lrs, W, hs_tabs):
        shipped.append(rows.dtype)
        return orig(tables, rows, lrs, W, hs_tabs)

    sv._dispatch_slab = spy
    sv.fit(seqs)
    assert shipped and all(dt == np.int16 for dt in shipped), shipped
    assert np.all(np.isfinite(np.asarray(sv.syn0)))
    assert np.all(np.isfinite(np.asarray(sv.syn1neg)))
    assert np.isfinite(sv.similarity("cat", "dog"))


def test_tables_handed_out_are_copies():
    """A table or vector a caller holds never changes under a later fit
    (the device tables train in place; on the CPU a view of one would),
    and it is read-only, as the JAX package's are."""
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors

    seqs = [s.split() for s in _corpus(n=60)[0]]
    for mode in ("scan", "dense"):
        sv = SequenceVectors(layer_size=8, window=2, negative=3, epochs=1,
                             seed=3, mode=mode, dense_batch_size=64,
                             device="cpu")
        sv.fit(seqs)
        held, vec = sv.syn0, sv.get_word_vector("cat")
        kept = held.copy()
        assert not held.flags.writeable and not vec.flags.writeable
        sv.fit(seqs)
        np.testing.assert_array_equal(held, kept)
        assert not np.array_equal(sv.syn0, kept)


def test_trainers_default_to_cuda_and_raise_without_it():
    """device=None means CUDA: without a GPU the fit raises and names the
    way out (device='cpu'); nothing falls back to the CPU silently."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    sents, _, _ = _corpus(n=20)
    w2v = (Word2Vec.Builder().layer_size(8).epochs(1)
           .iterate(CollectionSentenceIterator(sents)).build())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        w2v.fit()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Glove(layer_size=8).fit([s.split() for s in sents])
