"""The port's HDF5 reader (deeplearning4j_tpu_torch/modelimport/hdf5.py)
against h5py: every attribute and every dataset of the Keras fixtures bit
for bit, a group whose B-tree has several levels, object headers with
continuation blocks, scalar, empty and string data; what lies outside the
subset raises; and chip_smoke.py's HDF5 writer, whose files h5py reads
as written."""

import glob
import os
import sys

import h5py
import numpy as np
import pytest

from deeplearning4j_tpu_torch.modelimport import KerasModelImport, hdf5
from deeplearning4j_tpu_torch.modelimport.hdf5 import KerasImportError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures", "*.h5"))
                  + glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                           "torch", "*.h5")))


def _same_value(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == object:
            assert list(got.ravel()) == list(want.ravel())
        else:
            assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want), (type(got), type(want))
        assert got == want or (got != got and want != want)


def _same_tree(ours, theirs, path="/"):
    """Every attribute, member name (in order) and dataset equal; returns
    the number of datasets compared."""
    assert list(ours.attrs) == list(theirs.attrs), path
    for k in theirs.attrs:
        _same_value(ours.attrs[k], theirs.attrs[k])
    if isinstance(theirs, h5py.Dataset):
        assert isinstance(ours, hdf5.Dataset), path
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
        _same_value(np.asarray(ours[()]), np.asarray(theirs[()]))
        return 1
    assert isinstance(ours, hdf5.Group), path
    assert list(ours) == list(theirs), path
    return sum(_same_tree(ours[k], theirs[k], f"{path}{k}/") for k in theirs)


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_reader_matches_h5py_on_keras_fixture(path):
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        assert _same_tree(ours, theirs) > 0
        mc = ours.attrs["model_config"]
        assert isinstance(mc, str) and mc.startswith("{")


def _root_btree_level(f):
    r = f._reader
    return r._map[f._table[0] + 5]


def test_reader_many_groups_and_continuation_blocks(tmp_path):
    """200 groups: the root's B-tree has several levels over many symbol
    table nodes. Attributes added after a group's creation overflow its
    first header block into continuation blocks."""
    path = tmp_path / "many.h5"
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        for i in range(200):
            g = f.create_group(f"layer_{i:03d}")
            g.create_dataset("kernel", data=rng.normal(size=(3, i % 5 + 1))
                             .astype(np.float32))
        big = f["layer_007"]
        for j in range(40):
            big.attrs[f"attr_{j:02d}"] = rng.normal(size=(j + 1,))
        big.attrs["names"] = [f"n{j}" for j in range(30)]
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        assert _same_tree(ours, theirs) == 200
        assert _root_btree_level(ours) > 0
        assert len(list(ours._leaf_nodes(ours._table[0]))) > 8
        kinds = [m[0] for m in ours._reader.messages(ours["layer_007"]
                                                      ._header)]
        assert hdf5.MSG_CONTINUATION in kinds


def test_reader_scalar_empty_and_string_data(tmp_path):
    path = tmp_path / "kinds.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("scalar_f64", data=np.float64(2.5))
        f.create_dataset("scalar_i64", data=np.int64(-7))
        f.create_dataset("empty_f32", data=np.zeros((0,), np.float32))
        f.create_dataset("empty_2d", data=np.zeros((0, 3), np.float64))
        f.create_dataset("i32_be", data=np.arange(6, dtype=">i4")
                         .reshape(2, 3))
        f.create_dataset("u8", data=np.arange(5, dtype=np.uint8))
        f.create_dataset("f16", data=np.linspace(0, 1, 4).astype(np.float16))
        f.create_dataset("fixed_str", data=np.array([b"ab", b"cde"]))
        f.create_dataset("vlen_str", data=["x", "yz", ""],
                         dtype=h5py.string_dtype())
        f.attrs["fixed_scalar"] = np.bytes_(b"fixed")
        f.attrs["vlen_scalar"] = "vlen é"
        f.attrs["vlen_list"] = ["a", "bb", "ccc"]
        f.attrs["fixed_list"] = np.array([b"x", b"yy"])
        f.attrs["empty_f64"] = np.zeros(0)
        f.attrs["int_scalar"] = np.int64(3)
        f.attrs["float_array"] = np.arange(4, dtype=np.float32)
        f.create_group("empty_group")
    with hdf5.File(path) as ours, h5py.File(path, "r") as theirs:
        assert _same_tree(ours, theirs) == 9
        assert ours["scalar_f64"][()] == 2.5
        assert len(ours["empty_group"]) == 0
        assert ours.get("missing") is None and "u8" in ours
        assert ours["/empty_group"].name == "/empty_group"


def test_reader_rejects_chunked_and_compressed(tmp_path):
    path = tmp_path / "chunked.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("chunked", data=np.zeros((8, 8), np.float32),
                         chunks=(4, 4))
        f.create_dataset("gzip", data=np.zeros((8, 8), np.float32),
                         compression="gzip")
        f.create_dataset("plain", data=np.ones(3, np.float32))
    with hdf5.File(path) as ours:
        np.testing.assert_array_equal(np.asarray(ours["plain"]), np.ones(3))
        with pytest.raises(KerasImportError, match="chunked"):
            ours["chunked"]
        with pytest.raises(KerasImportError, match="chunked|compression"):
            ours["gzip"]


def test_reader_rejects_newer_format_versions(tmp_path):
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones(3, np.float32))
    with pytest.raises(KerasImportError, match="superblock version [23]"):
        hdf5.File(path)


def test_reader_rejects_truncated_and_foreign_files(tmp_path):
    src = FIXTURES[0]
    data = open(src, "rb").read()
    cut = tmp_path / "cut.h5"
    cut.write_bytes(data[:len(data) // 2])

    def read_all(group):
        for name in group:
            obj = group[name]
            if isinstance(obj, hdf5.Dataset):
                np.asarray(obj)
            else:
                read_all(obj)

    with pytest.raises(KerasImportError):
        with hdf5.File(cut) as f:
            read_all(f)
    other = tmp_path / "other.h5"
    other.write_bytes(b"not hdf5 at all" * 100)
    with pytest.raises(KerasImportError, match="not an HDF5 file"):
        hdf5.File(other)


def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_chip_smoke_writer_is_read_as_written(tmp_path):
    """chip_smoke.py's writer: h5py and the port's reader both read back
    every attribute and array as written (fixed-length and
    variable-length strings, a float64 attribute, empty groups)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(1)
    conf = '{"class_name": "Functional", "config": {"note": "é"}}'
    weights = {"in": {},
               "c1": {"kernel": rng.normal(size=(3, 3, 3, 8))
                      .astype(np.float32),
                      "bias": rng.normal(size=(8,)).astype(np.float32)},
               "pool": {},
               "bn": {w: rng.normal(size=(8,)).astype(np.float32)
                      for w in ("gamma", "beta", "moving_mean",
                                "moving_variance")}}
    path = tmp_path / "w.h5"
    n = cs.write_keras_h5(np, str(path), cs.keras_h5_tree(np, conf, weights))
    assert n == sum(a.nbytes for ws in weights.values() for a in ws.values())
    with h5py.File(path, "r") as theirs, hdf5.File(path) as ours:
        _same_tree(ours, theirs)
        assert theirs.attrs["model_config"] == conf
        mw = theirs["model_weights"]
        assert [s.decode() for s in mw.attrs["layer_names"]] == list(weights)
        for layer, ws in weights.items():
            names = mw[layer].attrs["weight_names"]
            assert [s.decode() for s in names] == [f"{layer}/{w}:0"
                                                   for w in ws]
            for w, a in ws.items():
                got = mw[f"{layer}/{layer}/{w}:0"][()]
                assert got.dtype == a.dtype and got.tobytes() == a.tobytes()


def test_chip_smoke_writer_round_trips_a_keras_model(tmp_path):
    """The keras_resblock fixture's config and weights, rewritten by
    chip_smoke.py's writer in the tf.keras 2 layout, import through the
    port to Keras's own outputs."""
    cs = _chip_smoke()
    src = os.path.join(ROOT, "tests", "fixtures", "torch",
                       "keras_resblock.h5")
    with h5py.File(src, "r") as f:
        conf = f.attrs["model_config"]
        weights = {}
        for layer in f["model_weights"].attrs["layer_names"]:
            g = f["model_weights"][layer]
            weights[layer] = {n.split("/")[-1]: g[n][()]
                              for n in g.attrs["weight_names"]}
    path = tmp_path / "resblock.h5"
    cs.write_keras_h5(np, str(path), cs.keras_h5_tree(np, conf, weights))
    net = KerasModelImport.import_keras_model_and_weights(str(path),
                                                          device="cpu")
    exp = np.load(src.replace(".h5", "_expected.npz"))
    np.testing.assert_allclose(net.output(exp["x"]).numpy(), exp["y"],
                               rtol=1e-4, atol=1e-5)
