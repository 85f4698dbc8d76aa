"""The serving wire across the two packages: a JAX ModelClient against a
port ModelServer and a port ModelClient against a JAX ModelServer, on the
npz and JSON wires, for predict and generate; and model zips hot-swapped
across them (a JAX-written zip into the port's registry, a port-written
zip into the JAX registry), all over HTTP.

Weights: the port's nets are twins of the JAX nets (configuration through
JSON, params and states through `params_from_jax`; the decoder through
`load_jax_params`). Tolerances:
  * predict outputs agree within TOL = 1e-5 absolute (f32 MLP);
  * generated tokens equal the serving package's own oracle bit for bit,
    and the other package's on every request whose JAX top-1 margin
    exceeds MARGIN = 1e-3 at every step (tests/test_torch_decode_parity.py
    declares the same; at least four such requests are required).
"""

import random

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.engine.decode_program import (
    DecodeProgram as JDecodeProgram,
)
from deeplearning4j_tpu.nn import attention as ja
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel.serving import ModelClient as JClient
from deeplearning4j_tpu.parallel.serving import ModelServer as JServer
from deeplearning4j_tpu.serving.continuous import (
    DecodeEngine as JDecodeEngine,
    sequential_decode as jsequential,
)
from deeplearning4j_tpu.util.model_serializer import (
    ModelSerializer as JSerializer,
)
from deeplearning4j_tpu.zoo.decoder import (
    CausalTransformer as JCausalTransformer,
)
from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.serving import (
    ModelClient,
    ModelServer,
)
from deeplearning4j_tpu_torch.serving import continuous as tcont
from deeplearning4j_tpu_torch.serving.continuous import (
    DecodeEngine,
    sequential_decode,
)
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_jax,
    write_model,
)
from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

pytestmark = pytest.mark.serving

TOL = 1e-5
MARGIN = 1e-3
VOCAB, CTX, SLOTS, PAGE = 64, 64, 4, 8
WIRES = ["npz", "json"]


@pytest.fixture(autouse=True)
def _isolation():
    yield
    tcont.reap_stray_engines()


def _jax_net(seed):
    conf = (JNNC.Builder().seed(seed).updater("sgd").learning_rate(0.1)
            .activation("tanh").weight_init("xavier")
            .list()
            .layer(JDense(n_out=16))
            .layer(JOut(n_out=6, loss="mcxent"))
            .set_input_type(JInputType.feed_forward(8))
            .build())
    return JMLN(conf).init()


def _port_of(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, device="cpu").init()
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    net.params, net.states = params_from_jax(
        tonp(jnet.params), tonp(jnet.states), device="cpu")
    return net


@pytest.fixture(scope="module")
def nets():
    j1, j2 = _jax_net(7), _jax_net(8)
    return j1, _port_of(j1), j2, _port_of(j2)


def _x(rows=5, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, 8)).astype(
        np.float32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _url(server):
    return f"http://127.0.0.1:{server.port}"


# ============================================================ predict
@pytest.mark.parametrize("wire", WIRES)
def test_jax_client_against_port_server(nets, wire):
    j1, t1, _, _ = nets
    x = _x()
    server = ModelServer(t1, model_name="m", device="cpu").start()
    try:
        client = JClient(_url(server), wire=wire, breaker=None)
        r = client.predict(x, model="m")
        assert r["model"] == "m" and r["version"] == "v1"
        assert _err(r["outputs"], np.asarray(j1.output(x))) <= TOL
        st = client.status()
        assert st["model"] == "MultiLayerNetwork"
        assert st["total_traces"] == st["trace_counts"]["predict"]
    finally:
        server.stop()


@pytest.mark.parametrize("wire", WIRES)
def test_port_client_against_jax_server(nets, wire):
    j1, t1, _, _ = nets
    x = _x(seed=1)
    server = JServer(j1, model_name="m").start()
    try:
        client = ModelClient(_url(server), wire=wire, breaker=None)
        r = client.predict(x, model="m")
        assert r["model"] == "m" and r["version"] == "v1"
        assert _err(r["outputs"], t1.output(x).numpy()) <= TOL
        assert client.healthz() and client.readyz()
        assert client.metrics()["dl4j_jit_traces_total"] >= 1
    finally:
        server.stop()


def test_error_bodies_cross_both_ways(nets):
    """The taxonomy is one wire format: each package's client reads the
    other's 400 and 404 as the same ServingError."""
    from deeplearning4j_tpu.resilience import ServingError as JServingError
    from deeplearning4j_tpu_torch.resilience import ServingError

    j1, t1, _, _ = nets
    port_srv = ModelServer(t1, device="cpu").start()
    jax_srv = JServer(j1).start()
    try:
        for client, err in ((JClient(_url(port_srv), breaker=None),
                             JServingError),
                            (ModelClient(_url(jax_srv), breaker=None),
                             ServingError)):
            with pytest.raises(err) as ei:
                client.predict(_x(), decode_top=2)
            assert ei.value.status == 400
            with pytest.raises(err) as ei:
                client.predict(_x(), model="absent")
            assert ei.value.status == 404
            assert ei.value.error_class == "ModelNotFoundError"
    finally:
        port_srv.stop()
        jax_srv.stop()


def test_wrong_shape_is_400_in_the_port_and_500_in_jax(nets):
    """A request of the wrong per-example shape: the port's
    ParallelInference rejects it before queueing (ValueError, 400); the
    JAX server fails inside the batch (a TypeError from the matmul,
    500). A reference-side fact (ROADMAP queue 3), pinned here."""
    from deeplearning4j_tpu.resilience import ServingError as JServingError
    from deeplearning4j_tpu.resilience.retry import Retry as JRetry

    j1, t1, _, _ = nets
    bad = np.zeros((2, 5), np.float32)
    port_srv = ModelServer(t1, device="cpu").start()
    jax_srv = JServer(j1).start()
    try:
        with pytest.raises(JServingError) as ei:
            JClient(_url(port_srv), breaker=None,
                    retry=JRetry(max_attempts=1)).predict(bad)
        assert (ei.value.status, ei.value.error_class) == (400,
                                                           "ValueError")
        with pytest.raises(JServingError) as ei:
            JClient(_url(jax_srv), breaker=None,
                    retry=JRetry(max_attempts=1)).predict(bad)
        assert (ei.value.status, ei.value.error_class) == (500,
                                                           "TypeError")
    finally:
        port_srv.stop()
        jax_srv.stop()


# ========================================================= hot swaps
def test_jax_zip_hot_swaps_into_the_port_registry(nets, tmp_path):
    j1, t1, j2, _ = nets
    zp = str(tmp_path / "jax_v2.zip")
    JSerializer.write_model(j2, zp)
    x = _x(seed=2)
    server = ModelServer(t1, model_name="m", device="cpu").start()
    try:
        client = ModelClient(_url(server), breaker=None)
        assert _err(client.predict(x, model="m")["outputs"],
                    np.asarray(j1.output(x))) <= TOL
        assert client.put_version("m", "v2", zp)["active"] == "v2"
        r = client.predict(x, model="m")
        assert r["version"] == "v2"
        assert _err(r["outputs"], np.asarray(j2.output(x))) <= TOL
        assert client.rollback("m")["active"] == "v1"
    finally:
        server.stop()


def test_port_zip_hot_swaps_into_the_jax_registry(nets, tmp_path):
    j1, _, j2, t2 = nets
    zp = str(tmp_path / "port_v2.zip")
    write_model(t2, zp)
    x = _x(seed=3)
    server = JServer(j1, model_name="m").start()
    try:
        client = JClient(_url(server), breaker=None)
        assert client.put_version("m", "v2", zp)["active"] == "v2"
        r = client.predict(x, model="m")
        assert r["version"] == "v2"
        assert _err(r["outputs"], t2.output(x).numpy()) <= TOL
    finally:
        server.stop()


# =========================================================== generate
@pytest.fixture(scope="module")
def decoders():
    """A JAX decoder and its port twin, their programs, and JAX's top-1
    margin at every step of each request (read by wrapping JAX's
    `lm_logits` while its program is built)."""
    logits = []
    orig = ja.lm_logits

    def lm(x, e):
        out = orig(x, e)
        jax.debug.callback(lambda v: logits.append(np.asarray(v)), out)
        return out

    ja.lm_logits = lm
    try:
        jm = JCausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                                n_layers=2, max_ctx=CTX, seed=3).init()
        pj = JDecodeProgram(jm, max_slots=SLOTS, page_size=PAGE)
        pj.warmup(pj.init_kv())
    finally:
        ja.lm_logits = orig
    tm = CausalTransformer(vocab_size=VOCAB, d_model=32, n_heads=4,
                           n_layers=2, max_ctx=CTX, seed=3,
                           device="cpu").load_jax_params(jm.params)
    pt = DecodeProgram(tm, max_slots=SLOTS, page_size=PAGE)
    pt.warmup(pt.init_kv())
    rng = random.Random(17)
    reqs = [([rng.randrange(VOCAB) for _ in range(rng.randrange(2, 20))],
             rng.randrange(4, 12)) for _ in range(10)]
    oracle_j, margins = [], []
    for prompt, mx in reqs:
        logits.clear()
        _, toks = jsequential(pj, prompt, mx)
        oracle_j.append(toks)
        margins.append(min(float(np.diff(np.sort(lg[0])[-2:])[0])
                           for lg in logits))
    oracle_t = [sequential_decode(pt, p, mx)[1] for p, mx in reqs]
    wide = [i for i, m in enumerate(margins) if m > MARGIN]
    assert len(wide) >= 4, margins
    return pj, pt, reqs, oracle_j, oracle_t, wide


def _generate_all(client, reqs):
    return [client.generate(p, max_new_tokens=mx, model="decoder")
            ["tokens"] for p, mx in reqs]


@pytest.mark.parametrize("wire", WIRES)
def test_jax_client_generates_from_port_server(decoders, wire):
    _, pt, reqs, oracle_j, oracle_t, wide = decoders
    server = ModelServer(decode_engine=DecodeEngine(program=pt),
                         model_name="decoder", device="cpu").start()
    try:
        got = _generate_all(JClient(_url(server), wire=wire,
                                    breaker=None), reqs)
    finally:
        server.stop()
    assert got == oracle_t
    for i in wide:
        assert got[i] == oracle_j[i], i


@pytest.mark.parametrize("wire", WIRES)
def test_port_client_generates_from_jax_server(decoders, wire):
    pj, _, reqs, oracle_j, oracle_t, wide = decoders
    server = JServer(decode_engine=JDecodeEngine(program=pj),
                     model_name="decoder").start()
    try:
        got = _generate_all(ModelClient(_url(server), wire=wire,
                                        breaker=None), reqs)
    finally:
        server.stop()
    assert got == oracle_j
    for i in wide:
        assert got[i] == oracle_t[i], i
