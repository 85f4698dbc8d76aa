"""The port's ring attention (deeplearning4j_tpu_torch/parallel/
ring_attention.py) across processes: one 8-rank gloo gang
(tests/fixtures/torch/mesh_worker.py, which imports only the port) runs
`ring_self_attention` at sp 8 and at dp 2 x sp 4, causal and not, on the
same seeded numpy q/k/v, and the tests hold every rank's global output
against the JAX package's `ring_self_attention` on the virtual CPU
devices (sp 8 and sp 4) and against dense attention.

Tolerance: JAX's tests/test_ring_attention.py, rtol 2e-4 / atol 2e-5
(the blockwise online softmax folds in another order than one softmax).
Every rank's output equals rank 0's bit for bit.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.ring_attention import (
    ring_self_attention as jring,
)
from deeplearning4j_tpu_torch.parallel import make_mesh, ring_self_attention
from deeplearning4j_tpu_torch.parallel.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch")
sys.path.insert(0, FIXTURES)
from mesh_worker import RING_CASES, launch  # noqa: E402

WORKER = os.path.join(FIXTURES, "mesh_worker.py")
RING_TOL = dict(rtol=2e-4, atol=2e-5)
B, T, H, D = 2, 32, 2, 8


def _qkv():
    rng = np.random.default_rng(21)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _dense(q, k, v, causal):
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((T, T), bool))[None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    io = str(tmp_path_factory.mktemp("ring"))
    q, k, v = _qkv()
    with open(os.path.join(io, "spec.json"), "w") as f:
        json.dump({"nets": {}, "helpers": {}}, f)
    np.savez(os.path.join(io, "nets.npz"))
    np.savez(os.path.join(io, "data.npz"), ring_q=q, ring_k=k, ring_v=v)
    launch(WORKER, io, 8, ("--only", "mesh,ring"))
    out = [dict(np.load(os.path.join(io, f"out-{r}.npz"))) for r in range(8)]
    facts = []
    for r in range(8):
        with open(os.path.join(io, f"out-{r}.json")) as f:
            facts.append(json.load(f))
    return {"out": out, "facts": facts}


def test_ranks_agree_and_no_scenario_failed(gang):
    for f in gang["facts"]:
        assert f["_failed"] == {}
    ref = gang["out"][0]
    assert len([k for k in ref if k.startswith("ring/")]) == 4
    for o in gang["out"][1:]:
        for k in ref:
            np.testing.assert_array_equal(o[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name,sp", [(n, kw["sp"]) for n, kw in RING_CASES])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_ring_and_dense(gang, name, sp, causal):
    q, k, v = _qkv()
    got = gang["out"][0][f"ring/{name}_{'causal' if causal else 'full'}:0"]
    mesh = jmake_mesh(sp=sp, devices=jax.devices("cpu")[:sp])
    want = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mesh, causal=causal))
    np.testing.assert_allclose(got, want, **RING_TOL)
    np.testing.assert_allclose(got, _dense(q, k, v, causal), **RING_TOL)


def test_ring_errors_match_jax(gang):
    """JAX's two ValueErrors (ring_attention.py:95-102), in the gang and
    on a mesh of one process: the divisibility check comes before any
    collective."""
    r = gang["facts"][3]["ring"]
    assert r["indivisible"] == ["ValueError",
                                "sequence length 30 not divisible by sp=8"]
    assert r["no_axis"][0] == "ValueError"
    assert r["no_axis"][1].startswith("mesh has no axis 'xx'")
    # two rings (causal and not) of n-1 hops each at sp 8 and at sp 4,
    # after the mesh scenario's five hops (one per axis of size > 1 of
    # its three meshes)
    assert r["ppermutes"] == 2 * 7 + 2 * 3 + 5
    q = torch.zeros(1, 6, 1, 4)
    m = Mesh({"dp": 1, "pp": 1, "sp": 4, "ep": 1, "tp": 1}, 4, 0)
    with pytest.raises(ValueError, match="sequence length 6 not divisible "
                                         "by sp=4"):
        ring_self_attention(q, q, q, m)
    with pytest.raises(ValueError, match="mesh has no axis 'seq'"):
        ring_self_attention(q, q, q, make_mesh(), axis_name="seq")


@pytest.mark.parametrize("causal", [False, True])
def test_one_process_ring_is_dense_attention_in_its_dtype(causal):
    """sp 1 (no group): one fold, the output in q's dtype."""
    q, k, v = _qkv()
    t = lambda a: torch.from_numpy(a)
    out = ring_self_attention(t(q), t(k), t(v), make_mesh(), causal=causal)
    np.testing.assert_allclose(out.numpy(), _dense(q, k, v, causal),
                               **RING_TOL)
    bf = ring_self_attention(t(q).bfloat16(), t(k).bfloat16(),
                             t(v).bfloat16(), make_mesh(), causal=causal)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), out.numpy(), atol=5e-2)
