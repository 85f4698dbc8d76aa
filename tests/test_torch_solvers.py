"""The port's line-search solvers (optimize/solvers.py) against the JAX
package's, on the CPU in f32: the problem of tests/test_solvers.py (a
tanh dense layer and a softmax head on a seeded separable batch), whose
line searches accept their probes with margins far above f32 rounding,
so both packages take the same steps. Bars: each iteration's loss at
rtol 1e-5, the params after the last at rtol 1e-4 / atol 1e-6 (f32
products summed in another order, carried through the solvers' history);
the JAX package's own convergence checks on the port alone."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import GraphBuilder as JGB
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    GraphBuilder,
)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.solvers import (
    BackTrackLineSearch,
    make_solver,
)
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax
from test_torch_train import _assert_trees_close

ALGOS = ["lbfgs", "conjugate_gradient", "line_gradient_descent"]
STEP_LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _conf(NNC, IT, Dense, Out, algo, seed=3, lr=0.1):
    return (NNC.Builder().seed(seed).updater("sgd").learning_rate(lr)
            .activation("tanh").weight_init("xavier")
            .optimization_algo(algo).list()
            .layer(Dense(n_out=8))
            .layer(Out(n_out=3, loss="mcxent"))
            .set_input_type(IT.feed_forward(5))
            .build())


def _net(algo, **kw):
    return MultiLayerNetwork(
        _conf(NeuralNetConfiguration, InputType, DenseLayer, OutputLayer,
              algo, **kw), device="cpu").init()


def _pair(algo):
    jnet = JMLN(_conf(JNNC, JInputType, JDense, JOut, algo)).init()
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jnet.conf.to_json()),
        device="cpu").init()
    net.params, net.states = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.states), device="cpu")
    return jnet, net


def _data(rng, n=64):
    x = rng.normal(size=(n, 5)).astype(np.float32)
    labels = (x[:, 0] + x[:, 1] > 0).astype(int) + (x[:, 2] > 0.5)
    return x, np.eye(3, dtype=np.float32)[labels]


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_steps_match_jax(algo, rng):
    """Eight iterations over two alternating batches: the accepted loss
    of each, then the params and the solvers' carried state."""
    jnet, net = _pair(algo)
    batches = [_data(rng), _data(rng)]
    for it in range(8):
        x, y = batches[it % 2]
        lj = float(jnet.fit_batch((x, y)))
        lt = float(net.fit_batch((x, y)))
        np.testing.assert_allclose(lt, lj, rtol=STEP_LOSS_RTOL,
                                   err_msg=f"iteration {it}")
    assert net.iteration == jnet.iteration == 8
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    if algo == "lbfgs":
        assert len(net._solver._hist) == len(jnet._solver._hist) > 0


def test_solver_on_a_graph_matches_jax(rng):
    x, y = _data(rng)

    def build(GB, NNC, IT, Dense, Out):
        return (GB(NNC.Builder().seed(1).updater("sgd").learning_rate(0.1)
                   .optimization_algo("lbfgs"))
                .add_inputs("in")
                .add_layer("h", Dense(n_out=8, activation="tanh"), "in")
                .add_layer("out", Out(n_out=3, loss="mcxent"), "h")
                .set_outputs("out")
                .set_input_types(**{"in": IT.feed_forward(5)}).build())

    jnet = JGraph(build(JGB, JNNC, JInputType, JDense, JOut)).init()
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    assert conf.to_json() == build(GraphBuilder, NeuralNetConfiguration,
                                   InputType, DenseLayer,
                                   OutputLayer).to_json()
    net = ComputationGraph(conf, device="cpu").init()
    net.params, net.states = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params), None, device="cpu")
    net.states = {k: {} for k in net.params}
    for it in range(5):
        jnet.fit([([x], [y])])
        net.fit([([x], [y])])
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=STEP_LOSS_RTOL,
                                   err_msg=f"iteration {it}")
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)


def test_backtrack_line_search_quadratic():
    f = lambda v: torch.sum((v - 2.0) ** 2)
    x0 = torch.zeros(3)
    g0 = 2 * (x0 - 2.0)
    alpha, f_new = BackTrackLineSearch().search(f, x0, float(f(x0)), g0, -g0,
                                                alpha0=1.0)
    assert alpha > 0 and f_new < float(f(x0))
    alpha, _ = BackTrackLineSearch().search(f, x0, float(f(x0)), g0, g0,
                                            alpha0=1.0)
    assert alpha == 0.0


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_decreases_loss(algo, rng):
    x, y = _data(rng)
    net = _net(algo)
    net.fit([(x, y)])
    l0 = net.score()
    net.fit([(x, y)] * 15)
    assert net.score() < l0 * 0.7
    assert net.iteration == 16


def test_lbfgs_converges_faster_than_sgd(rng):
    x, y = _data(rng, n=128)
    sgd, lb = _net("stochastic_gradient_descent"), _net("lbfgs")
    sgd.fit([(x, y)] * 25)
    lb.fit([(x, y)] * 25)
    assert lb.score() < sgd.score()


def test_unknown_algo_raises(rng):
    with pytest.raises(ValueError, match="Unknown optimization"):
        _net("newton").fit([_data(rng)])
    assert make_solver("sgd", _net("sgd")) is None


def test_restart_resets_solver_state(rng):
    """When the line search fails along the solver's direction and the
    steepest-descent fallback is taken, the stored state is the
    fallback's: CG keeps d = -grad, LBFGS clears its history."""
    x, y = _data(rng)
    batch = _net("sgd")._batch_tensors(x, y)
    calls = {"n": 0}
    orig = BackTrackLineSearch.search

    def failing_first(self, f, x0, f0, g0, direction, alpha0=1.0):
        calls["n"] += 1
        if calls["n"] == 1:
            return 0.0, f0
        return orig(self, f, x0, f0, g0, direction, alpha0)

    cg = make_solver("conjugate_gradient", _net("conjugate_gradient"))
    cg.step(*batch)
    cg.line_search.search = failing_first.__get__(cg.line_search)
    cg.step(*batch)
    assert calls["n"] >= 2
    g_stored, d_stored = cg._state
    torch.testing.assert_close(d_stored, -g_stored)
    lb = make_solver("lbfgs", _net("lbfgs"))
    lb.step(*batch)
    lb.step(*batch)
    assert lb._state[2]
    calls["n"] = 0
    lb.line_search.search = failing_first.__get__(lb.line_search)
    lb.step(*batch)
    assert lb._state[2] == []
