"""The port's data and evaluation modules against the JAX package, on
the CPU: normalizers (their to_dict both ways, numpy and torch inputs,
normalizer.json in model zips both ways), the record readers and
iterators (batches bit for bit on tests/test_records.py's cases, the
native CSV parser against its NumPy fallback), the fetchers (local files
or the seeded stand-ins, never a socket) and every evaluation (regression,
binary, ROC, ROCBinary, ROCMultiClass, calibration; the HTML exports).

Tolerances: integer counts and everything computed from them (confusion
matrices, ROC curves and AUCs, binary metrics) equal exactly; float64
sums (regression statistics, calibration's probability sums) accumulate
in another order on the device, so rtol 1e-12."""

import json
import os
import socket

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.datasets as jdata
import deeplearning4j_tpu.eval as jeval
from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.datasets import fetchers as jfetchers
from deeplearning4j_tpu.datasets import normalizers as jnorm
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch import datasets as data
from deeplearning4j_tpu_torch import eval as ev
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets import fetchers, normalizers
from deeplearning4j_tpu_torch.util import model_serializer as ser

SUM_RTOL = 1e-12
JAX_FETCH = jfetchers._fetch


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _same_batches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for f in ("features", "labels", "features_mask", "labels_mask"):
            x, y = getattr(a, f, None), getattr(b, f, None)
            assert (x is None) == (y is None), f
            if isinstance(y, list):
                for u, v in zip(x, y):
                    _bits(u, v)
            elif y is not None:
                _bits(x, y)


# ------------------------------------------------------------ normalizers

def _image_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, size=(6, 4, 4, 3)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]


NORMALIZERS = {
    "NormalizerStandardize": (), "NormalizerMinMaxScaler": (-1.0, 2.0),
    "ImagePreProcessingScaler": (-0.5, 0.5), "VGG16ImagePreProcessor": ()}


@pytest.mark.parametrize("kind", list(NORMALIZERS))
def test_normalizer_to_dict_crosses_both_ways(kind):
    x, y = _image_data()
    args = NORMALIZERS[kind]
    ours = getattr(normalizers, kind)(*args).fit(data.DataSet(x, y))
    theirs = getattr(jnorm, kind)(*args).fit(jdata.DataSet(x, y))
    assert json.dumps(ours.to_dict()) == json.dumps(theirs.to_dict())
    xt = _image_data(1)[0]
    want = theirs.transform(jdata.DataSet(xt.copy())).features
    _bits(ours.transform(data.DataSet(xt.copy())).features, want)
    # each package's dict read by the other transforms to the same bits
    a = normalizers.normalizer_from_dict(theirs.to_dict())
    b = jnorm.normalizer_from_dict(ours.to_dict())
    _bits(a.transform(xt.copy()), b.transform(jdata.DataSet(xt.copy()))
          .features)
    assert type(a).__name__ == kind


@pytest.mark.parametrize("kind", list(NORMALIZERS))
def test_normalizer_on_tensors_matches_numpy(kind):
    x, y = _image_data()
    args = NORMALIZERS[kind]
    n = getattr(normalizers, kind)(*args).fit(
        [(torch.from_numpy(x[:3]), y[:3]), (torch.from_numpy(x[3:]), y[3:])])
    ref = getattr(normalizers, kind)(*args).fit(data.DataSet(x, y))
    assert json.dumps(n.to_dict()) == json.dumps(ref.to_dict())
    xt = _image_data(1)[0]
    got = n.transform(torch.from_numpy(xt))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _bits(got.numpy(), ref.transform(xt.copy()))
    u8 = torch.from_numpy(xt.astype(np.uint8))
    _bits(n.transform(u8).numpy(), ref.transform(
        xt.astype(np.uint8).astype(np.float32)))
    if kind == "NormalizerStandardize":
        np.testing.assert_allclose(n.revert_features(got).numpy(), xt,
                                   rtol=1e-5, atol=1e-3)


def _port_net():
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.Builder().seed(3).list()
            .layer(DenseLayer(n_out=4, activation="relu"))
            .layer(OutputLayer(n_out=2, loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_normalizer_json_in_model_zips_crosses_both_ways(tmp_path):
    from deeplearning4j_tpu import MultiLayerNetwork as JMLN

    x, y = _image_data()
    feats = x.reshape(6, -1)[:, :3]
    mine = normalizers.NormalizerStandardize().fit(data.DataSet(feats, y))
    net = _port_net()
    ser.write_model(net, tmp_path / "port.zip", normalizer=mine)
    back = jser.read_normalizer(str(tmp_path / "port.zip"))
    assert json.dumps(back.to_dict()) == json.dumps(mine.to_dict())
    # and the JAX package restores the port-written net itself
    jnet = jser.restore_multi_layer_network(str(tmp_path / "port.zip"))
    assert isinstance(jnet, JMLN)

    theirs = jnorm.NormalizerMinMaxScaler().fit(jdata.DataSet(feats, y))
    jser.write_model(jnet, str(tmp_path / "jax.zip"), normalizer=theirs)
    got = ser.read_normalizer(tmp_path / "jax.zip")
    assert isinstance(got, normalizers.NormalizerMinMaxScaler)
    assert json.dumps(got.to_dict()) == json.dumps(theirs.to_dict())
    assert ser.ModelSerializer.read_normalizer(tmp_path / "jax.zip") \
        is not None
    ser.write_model(net, tmp_path / "plain.zip")
    assert ser.read_normalizer(tmp_path / "plain.zip") is None


# --------------------------------------------------------- record readers

def _csv(tmp_path, name, lines):
    p = tmp_path / name
    p.write_text("\n".join(lines))
    return str(p)


def test_csv_record_reader_rows(tmp_path):
    p = _csv(tmp_path, "d.csv", ["h1,h2,h3", "1,2,0", "3,4,1", "5,6,2"])
    rr = data.CSVRecordReader(p, skip_lines=1)
    assert list(rr) == list(jdata.CSVRecordReader(p, skip_lines=1))
    assert len(list(rr)) == 3


@pytest.mark.parametrize("native_path", [True, False])
def test_record_reader_dataset_iterator_classification(tmp_path,
                                                       native_path):
    p = _csv(tmp_path, "d.csv", [f"{i * 0.5},{i * 2},{i % 3}"
                                 for i in range(11)])
    readers = [data.CSVRecordReader(p), jdata.CSVRecordReader(p)]
    if not native_path:
        for r in readers:
            r.to_matrix = lambda: None
    ours = data.RecordReaderDataSetIterator(readers[0], batch_size=4,
                                            label_index=2, num_classes=3)
    theirs = jdata.RecordReaderDataSetIterator(readers[1], batch_size=4,
                                               label_index=2, num_classes=3)
    _same_batches(list(ours), list(theirs))
    _same_batches(list(ours), list(theirs))      # reset + re-iterate
    if native_path and native.available():
        assert ours._native_batches is not None


def test_record_reader_regression_and_features_only(tmp_path):
    rows = [[1, 2, 0.5, 1.5], [3, 4, 2.5, 3.5], [5, 6, 4.5, 5.5]]
    p = _csv(tmp_path, "r.csv", [",".join(map(str, r)) for r in rows])
    for kw in (dict(label_index=2, label_index_to=3, regression=True),
               dict(label_index=1, regression=True), {}):
        # in-memory records, and the CSV file's whole-file native path
        for ours, theirs in ((data.CollectionRecordReader(rows),
                              jdata.CollectionRecordReader(rows)),
                             (data.CSVRecordReader(p),
                              jdata.CSVRecordReader(p))):
            _same_batches(
                list(data.RecordReaderDataSetIterator(ours, batch_size=2,
                                                      **kw)),
                list(jdata.RecordReaderDataSetIterator(theirs, batch_size=2,
                                                       **kw)))


def test_classification_requires_num_classes():
    with pytest.raises(ValueError, match="num_classes"):
        data.RecordReaderDataSetIterator(
            data.CollectionRecordReader([[1, 0]]), 2, label_index=1)
    with pytest.raises(ValueError, match="num_classes"):
        data.SequenceRecordReaderDataSetIterator(
            data.CollectionSequenceRecordReader([[[1, 0]]]), 2,
            label_index=1)


def test_sequence_record_readers(tmp_path):
    p1 = _csv(tmp_path, "s1.csv", ["1,2,0", "3,4,1", "5,6,0"])
    p2 = _csv(tmp_path, "s2.csv", ["7,8,1", "9,10,0"])
    p3 = _csv(tmp_path, "s3.csv", ["1,1,1"])
    for kw in (dict(label_index=2, num_classes=2),
               dict(label_index=2, regression=True), {}):
        _same_batches(
            list(data.SequenceRecordReaderDataSetIterator(
                data.CSVSequenceRecordReader([p1, p2, p3]), batch_size=2,
                **kw)),
            list(jdata.SequenceRecordReaderDataSetIterator(
                jdata.CSVSequenceRecordReader([p1, p2, p3]), batch_size=2,
                **kw)))
    seqs = [[[1, 0], [2, 1]], [[3, 0]]]
    _same_batches(
        list(data.SequenceRecordReaderDataSetIterator(
            data.CollectionSequenceRecordReader(seqs), batch_size=2,
            label_index=1, num_classes=2)),
        list(jdata.SequenceRecordReaderDataSetIterator(
            jdata.CollectionSequenceRecordReader(seqs), batch_size=2,
            label_index=1, num_classes=2)))


def test_multi_dataset_iterator():
    rows = [[i, i + 1, i % 2, i * 0.1] for i in range(7)]

    def build(pkg):
        return (pkg.RecordReaderMultiDataSetIterator.Builder(batch_size=3)
                .add_reader("r", pkg.CollectionRecordReader(rows))
                .add_input("r", 0, 1)
                .add_output_one_hot("r", 2, 2)
                .add_output("r", 3, 3)
                .build())

    _same_batches(list(build(data)), list(build(jdata)))
    with pytest.raises(ValueError, match="no reader"):
        (data.RecordReaderMultiDataSetIterator.Builder(2)
         .add_input("missing").add_output("missing", 0, 0).build())


def test_native_csv_parser_and_fallback():
    text = "# header comment\n1.5,2,3\n-4,5e-2,6\n\n7,8,9\n"
    want = jnative.parse_csv_f32(text)
    _bits(native.parse_csv_f32(text), want)
    _bits(native.parse_csv_fallback(text.encode(), ","), want)
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(500, 11)) * 10.0 ** rng.integers(
        -8, 8, size=(500, 11))).astype(np.float32)
    big = "\n".join(",".join(repr(float(v)) for v in r) for r in a)
    _bits(native.parse_csv_f32(big), native.parse_csv_fallback(
        big.encode()))
    _bits(native.parse_csv_f32(big), a)
    for bad, match in (("1,2\n3\n", "ragged"), ("1,abc\n", "numeric|parse")):
        with pytest.raises(ValueError, match=match):
            native.parse_csv_f32(bad)
        with pytest.raises(ValueError):
            native.parse_csv_fallback(bad.encode())


def test_native_builds_into_the_port_and_u8_kernels():
    assert native.available()        # built by g++, as native/build.sh
    assert os.path.exists(os.path.join(native._BUILD_DIR, native._LIB_NAME))
    src = np.arange(256, dtype=np.uint8)
    _bits(native.u8_to_f32(src), jnative.u8_to_f32(src))
    img = np.arange(2 * 3 * 4 * 5, dtype=np.uint8).reshape(2, 3, 4, 5)
    _bits(native.chw_u8_to_hwc_f32(img, 1.0, 0.0),
          np.transpose(img, (0, 2, 3, 1)).astype(np.float32))
    _bits(native.chw_u8_to_hwc_f32(img), jnative.chw_u8_to_hwc_f32(img))


# -------------------------------------------------------------- fetchers

@pytest.fixture
def no_network(monkeypatch, tmp_path):
    """An empty data directory and no way to open a socket; the JAX
    package's download attempt (`_fetch`) is replaced by a miss."""
    def refuse(*a, **k):
        raise AssertionError("a fetcher opened a socket")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)
    monkeypatch.setattr(socket, "getaddrinfo", refuse)
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setattr(jfetchers, "_fetch", lambda url, fname: None)
    return tmp_path / "data"


@pytest.mark.parametrize("name,kw", [
    ("MnistDataSetIterator", dict(batch_size=256, num_examples=600)),
    ("MnistDataSetIterator", dict(batch_size=100, train=False,
                                  num_examples=300)),
    ("IrisDataSetIterator", dict(batch_size=50)),
    ("CifarDataSetIterator", dict(batch_size=128, num_examples=300)),
    ("LFWDataSetIterator", dict(batch_size=16, num_examples=40,
                                image_shape=(16, 16, 3))),
    ("CurvesDataSetIterator", dict(batch_size=25, num_examples=60)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_fetcher_stand_ins_equal_jax_and_open_no_socket(no_network, name,
                                                        kw):
    ours = list(getattr(fetchers, name)(**kw))
    assert not os.path.exists(no_network)     # nothing written either
    _same_batches(ours, list(getattr(jfetchers, name)(**kw)))


def test_mnist_reads_local_idx_files(no_network, monkeypatch):
    import gzip
    import struct

    # the JAX package's own _fetch reads the local file it finds (sockets
    # stay refused)
    monkeypatch.setattr(jfetchers, "_fetch", JAX_FETCH)
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, size=(20, 28, 28)).astype(np.uint8)
    labs = rng.integers(0, 10, size=20).astype(np.uint8)
    os.makedirs(no_network)
    for kind, arr in (("images", imgs), ("labels", labs)):
        head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
            ">" + "I" * arr.ndim, *arr.shape)
        with open(no_network / f"mnist_train_{kind}.gz", "wb") as f:
            f.write(gzip.compress(head + arr.tobytes()))
    ours = fetchers.MnistDataSetIterator(8, shuffle=False)
    theirs = jfetchers.MnistDataSetIterator(8, shuffle=False)
    _same_batches(list(ours), list(theirs))
    _bits(ours.data.features[..., 0], native.u8_to_f32(imgs))
    with pytest.raises(RuntimeError, match="never downloads"):
        fetchers.load_mnist(train=False, synthetic_fallback=False)


def test_iterator_helpers_match_jax():
    x, y = _image_data()
    for make in (lambda p: p.MultipleEpochsIterator(
                     3, p.ListDataSetIterator(p.DataSet(x, y), 4)),
                 lambda p: p.EarlyTerminationDataSetIterator(
                     p.ListDataSetIterator(p.DataSet(x, y), 2), 2),
                 lambda p: p.BenchmarkDataSetIterator((4, 3), 5, 3,
                                                      seed=1)):
        _same_batches(list(make(data)), list(make(jdata)))


# ------------------------------------------------------------ evaluations

def _cls_data(seed, n=300, c=4, time_steps=None):
    rng = np.random.default_rng(seed)
    shape = (n, c) if time_steps is None else (n, time_steps, c)
    logits = rng.normal(size=shape) * 2
    p = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)
    lab = np.eye(c, dtype=np.float32)[rng.integers(0, c, shape[:-1])]
    mask = None if time_steps is None else (
        rng.random((n, time_steps)) > 0.3).astype(np.float32)
    return lab, p, mask


def _feed(ours, theirs, batches, as_tensor=False):
    for b in batches:
        ours.eval(*[None if a is None else
                    (torch.from_numpy(a) if as_tensor else a) for a in b])
        theirs.eval(*b)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_regression_evaluation_matches_jax(as_tensor):
    rng = np.random.default_rng(5)
    batches = [(rng.normal(size=(50, 3)), rng.normal(size=(50, 3)), None)
               for _ in range(3)]
    m = (rng.random((10, 6)) > 0.4).astype(np.float32)
    batches.append((rng.normal(size=(10, 6, 3)).astype(np.float32),
                    rng.normal(size=(10, 6, 3)).astype(np.float32), m))
    ours = ev.RegressionEvaluation(column_names=["a", "b", "c"],
                                   device="cpu")
    theirs = jeval.RegressionEvaluation(column_names=["a", "b", "c"])
    _feed(ours, theirs, batches, as_tensor)
    for q in ("mean_squared_error", "mean_absolute_error",
              "root_mean_squared_error", "relative_squared_error",
              "pearson_correlation", "r_squared"):
        for c in range(3):
            np.testing.assert_allclose(getattr(ours, q)(c),
                                       getattr(theirs, q)(c), rtol=SUM_RTOL)
    np.testing.assert_array_equal(ours.count, theirs.count)
    assert ours.stats().splitlines()[0] == theirs.stats().splitlines()[0]
    merged = ev.RegressionEvaluation(device="cpu").merge(ours).merge(ours)
    np.testing.assert_allclose(merged.sum_sq_err, 2 * theirs.sum_sq_err,
                               rtol=SUM_RTOL)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_binary_evaluation_matches_jax(as_tensor):
    rng = np.random.default_rng(6)
    batches = [((rng.random((40, 5)) > 0.5).astype(np.float32),
                rng.random((40, 5)).astype(np.float32), None),
               ((rng.random((8, 7, 5)) > 0.5).astype(np.float32),
                rng.random((8, 7, 5)).astype(np.float32),
                (rng.random((8, 7)) > 0.2).astype(np.float32))]
    ours = ev.EvaluationBinary(device="cpu")
    theirs = jeval.EvaluationBinary()
    _feed(ours, theirs, batches, as_tensor)
    for k in ("tp", "fp", "tn", "fn"):
        _bits(getattr(ours, k), getattr(theirs, k))
    assert ours.stats() == theirs.stats()
    assert ours.average_accuracy() == theirs.average_accuracy()
    ours.merge(ours)
    _bits(ours.tp, 2 * theirs.tp)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_roc_evaluations_match_jax(as_tensor):
    rng = np.random.default_rng(7)
    s = rng.random(400).astype(np.float32)
    y01 = (rng.random(400) < s).astype(np.float32)
    mask = (rng.random(400) > 0.1).astype(np.float32)
    two = (np.stack([1 - y01, y01], 1), np.stack([1 - s, s], 1), mask)
    one = (y01[:, None], s[:, None], None)
    for batches in ([one], [two, one]):
        ours, theirs = ev.ROC(device="cpu"), jeval.ROC()
        _feed(ours, theirs, batches, as_tensor)
        assert ours.calculate_auc() == theirs.calculate_auc() > 0.7
        for a, b in zip(ours.get_roc_curve() + ours.precision_recall_curve(),
                        theirs.get_roc_curve()
                        + theirs.precision_recall_curve()):
            _bits(a, b)
    lab, p, _ = _cls_data(8)
    lab3, p3, m3 = _cls_data(9, n=20, time_steps=6)
    batches = [(lab, p, None), (lab3, p3, m3)]
    for cls in ("ROCBinary", "ROCMultiClass"):
        ours, theirs = getattr(ev, cls)(50, device="cpu"), \
            getattr(jeval, cls)(50)
        _feed(ours, theirs, batches, as_tensor)
        assert ours.average_auc() == theirs.average_auc()
        assert [ours.calculate_auc(c) for c in range(4)] == \
            [theirs.calculate_auc(c) for c in range(4)]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_calibration_matches_jax(as_tensor):
    lab, p, _ = _cls_data(10, n=1000, c=3)
    keep = (np.random.default_rng(11).random(200) > 0.25).astype(np.float32)
    batches = [(lab[:800], p[:800], None), (lab[800:], p[800:], keep)]
    ours = ev.EvaluationCalibration(device="cpu")
    theirs = jeval.EvaluationCalibration()
    _feed(ours, theirs, batches, as_tensor)
    for c in range(3):
        for a, b, exact in zip(ours.reliability_info(c),
                               theirs.reliability_info(c),
                               (False, True, True)):
            if exact:
                _bits(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=SUM_RTOL)
        _bits(ours.probability_histogram(c)[1],
              theirs.probability_histogram(c)[1])
    _bits(ours.residual_plot()[1], theirs.residual_plot()[1])
    np.testing.assert_allclose(ours.expected_calibration_error(),
                               theirs.expected_calibration_error(),
                               rtol=SUM_RTOL)
    with pytest.raises(ValueError, match="one-hot"):
        ours.eval(lab[None], p[None])


def test_classification_evaluation_takes_tensors():
    lab, p, _ = _cls_data(12)
    ours, theirs = ev.Evaluation(), jeval.Evaluation()
    ours.eval(torch.from_numpy(lab), torch.from_numpy(p), top_n=2)
    theirs.eval(lab, p, top_n=2)
    _bits(ours.confusion.matrix, theirs.confusion.matrix)
    assert ours.stats() == theirs.stats()


def test_html_exports_match_jax(tmp_path):
    rng = np.random.default_rng(13)
    s = rng.random(300).astype(np.float32)
    y01 = (rng.random(300) < s).astype(np.float32)
    ours, theirs = ev.ROC(device="cpu"), jeval.ROC()
    _feed(ours, theirs, [(y01[:, None], s[:, None], None)])
    page = ev.export_roc_charts_to_html(ours, str(tmp_path / "roc.html"))
    assert page == jeval.export_roc_charts_to_html(theirs)
    assert (tmp_path / "roc.html").read_text() == page
    lab, p, _ = _cls_data(14, c=2)
    cal = ev.EvaluationCalibration(device="cpu").eval(lab, p)
    page = ev.export_evaluation_calibration_to_html(cal)
    assert "reliability class 1" in page and "macro ECE" in page


def test_evaluations_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    for cls in (ev.RegressionEvaluation, ev.EvaluationBinary, ev.ROC,
                ev.ROCBinary, ev.ROCMultiClass, ev.EvaluationCalibration):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls()
