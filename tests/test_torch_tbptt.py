"""Truncated BPTT in the port's two containers against the JAX package,
on the CPU, and its engine entry points: MultiLayerNetwork and
ComputationGraph `fit_batch` on a TBPTT net (GravesLSTM -> RnnOutputLayer,
T=12: chunks of 4, and of 5 with a short last one), feature and label
masks sliced with the inputs, the bf16 policy, `bptt_remat`, StepProgram,
TrainingMaster and ParallelWrapper at steps_per_dispatch=1, and the zoo's
TextGenerationLSTM.

Tolerances: f32 losses at rtol 1e-5 and params and updater state at rtol
1e-4 (atol 1e-6 for elements near zero); `bptt_remat` against the plain
fit at 1e-6; the bf16 policy at BF16_LOSS_RTOL / BF16_PARAM_TOL, set from
the readings (see there)."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.zoo import models as jzoo
from deeplearning4j_tpu_torch.engine import StepProgram
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, TrainingMaster
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax
from deeplearning4j_tpu_torch.util.tree import leaves
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
from test_torch_engine import _assert_bitwise
from test_torch_train import _assert_trees_close

LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
REMAT_TOL = dict(rtol=1e-6, atol=1e-6)
# bf16 policy against JAX's, sgd (an update linear in the gradient): XLA
# keeps f32 inside fused elementwise chains where eager torch rounds every
# op of the cell to bf16. Readings of the 2-batch, 6-chunk fit (CPU): last
# chunk losses 1.0e-4 and 2.0e-4 apart (relative), params at most 3.9e-4
# apart (updates up to 2.5e-2) — limits 5x the readings. (Under rmsprop,
# which divides by the gradient's running RMS, the same rounding moved
# params by 7.7e-2 of updates up to 0.84.)
BF16_LOSS_RTOL = 1e-3
BF16_PARAM_TOL = dict(rtol=0.0, atol=2e-3)
B, T, D, C, H = 4, 12, 3, 2, 5


def _np(t):
    return t.detach().float().cpu().numpy()


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(seed, masks=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, T))]
    if not masks:
        return x, y
    lengths = rng.integers(T // 2, T + 1, B)
    fm = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    lm = fm.copy()
    lm[0, :3] = 0.0
    return x, y, fm, lm


def _jmln(L=4, updater="rmsprop", remat=False, kind="GravesLSTM"):
    rnn = (JL.GravesBidirectionalLSTM(n_out=H)
           if kind == "GravesBidirectionalLSTM"
           else getattr(JL, kind)(n_out=H, bptt_remat=remat))
    conf = (JNNC.Builder().seed(9).updater(updater).learning_rate(0.05)
            .activation("tanh").weight_init("xavier").list()
            .layer(rnn)
            .layer(JL.RnnOutputLayer(n_out=C, loss="mcxent"))
            .set_input_type(JInputType.recurrent(D, T))
            .backprop_type("truncated_bptt")
            .t_bptt_forward_length(L).t_bptt_backward_length(L)
            .build())
    return JMLN(conf).init()


def _port_mln(jnet, compute_dtype=None):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(conf, compute_dtype=compute_dtype,
                            device="cpu").init()
    net.params, net.states = params_from_jax(
        _tree_np(jnet.params), _tree_np(jnet.states), device="cpu")
    return net


def _jgraph(L=4, updater="rmsprop"):
    """The JAX package's test_graph_tbptt shape."""
    conf = (JNNC.Builder().seed(9).updater(updater).learning_rate(0.05)
            .activation("tanh").weight_init("xavier").graph_builder()
            .add_inputs("seq")
            .add_layer("lstm", JL.GravesLSTM(n_out=H), "seq")
            .add_layer("out", JL.RnnOutputLayer(n_out=C, loss="mcxent"),
                       "lstm")
            .set_outputs("out")
            .set_input_types(seq=JInputType.recurrent(D, T))
            .build())
    conf.backprop_type = "truncated_bptt"
    conf.tbptt_fwd_length = L
    return JGraph(conf).init()


def _port_graph(jg):
    conf = ComputationGraphConfiguration.from_json(jg.conf.to_json())
    g = ComputationGraph(conf, device="cpu").init()
    g.params, g.states = params_from_jax(_tree_np(jg.params),
                                         _tree_np(jg.states), device="cpu")
    return g


def _assert_matches_jax(jnet, net, **tol):
    _assert_trees_close(jnet.params, net.params, **tol)
    _assert_trees_close(jnet.updater_states, net.updater_states, **tol)
    assert net.iteration == jnet.iteration


class _Counter:
    def __init__(self):
        self.calls = []

    def iteration_done(self, net, iteration):
        self.calls.append(iteration)


# ------------------------------------------------------- parity with JAX


@pytest.mark.parametrize("L, chunks", [(4, 3), (5, 3)])
@pytest.mark.parametrize("masks", [False, True])
def test_mln_tbptt_fit_batch_matches_jax(L, chunks, masks):
    """Each batch is `chunks` train steps (5: two of 5 and a short 2):
    the iteration count, the last chunk's loss, params and rmsprop state
    after two batches; feature and label masks sliced with the input;
    the listeners fire once per batch."""
    jnet = _jmln(L)
    net = _port_mln(jnet)
    counter = _Counter()
    net.set_listeners(counter)
    for s in range(2):
        batch = _data(10 + s, masks)
        lj = float(jnet.fit_batch(batch))
        lt = float(net.fit_batch(batch))
        np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
        assert net.iteration == jnet.iteration == (s + 1) * chunks
    assert counter.calls == [chunks, 2 * chunks]
    _assert_matches_jax(jnet, net, **PARAM_TOL)


@pytest.mark.parametrize("L, chunks", [(4, 3), (5, 3)])
def test_graph_tbptt_fit_batch_matches_jax(L, chunks):
    """The JAX package's test_graph_tbptt graph (on the flat train carry
    in both packages): iterations, the last chunk's loss, params and
    updater state."""
    jg = _jgraph(L)
    g = _port_graph(jg)
    for s in range(2):
        x, y = _data(20 + s)
        jg.fit_batch(([x], [y]))
        lt = float(g.fit_batch(([x], [y])))
        np.testing.assert_allclose(lt, float(jg.score()), rtol=LOSS_RTOL)
        assert g.iteration == jg.iteration == (s + 1) * chunks
    assert g._flat_train is not None
    _assert_matches_jax(jg, g, **PARAM_TOL)


def test_graph_tbptt_with_feature_masks_matches_jax():
    jg = _jgraph(5, updater="adam")
    g = _port_graph(jg)
    x, y, fm, lm = _data(30, masks=True)
    jg.fit_batch(([x], [y], [fm], [lm]))
    g.fit_batch(([x], [y], [fm], [lm]))
    np.testing.assert_allclose(float(g.score()), float(jg.score()),
                               rtol=LOSS_RTOL)
    _assert_matches_jax(jg, g, **PARAM_TOL)


@pytest.mark.parametrize("kind", ["LSTM", "GravesBidirectionalLSTM"])
def test_other_recurrent_layers_tbptt_match_jax(kind):
    """LSTM without peepholes, and the bidirectional layer (only its
    forward direction's carry crosses chunks)."""
    jnet = _jmln(4, updater="nesterovs", kind=kind)
    net = _port_mln(jnet)
    for s in range(2):
        batch = _data(40 + s)
        np.testing.assert_allclose(float(net.fit_batch(batch)),
                                   float(jnet.fit_batch(batch)),
                                   rtol=LOSS_RTOL)
    _assert_matches_jax(jnet, net, **PARAM_TOL)


def test_bf16_policy_tbptt_matches_jax():
    """Carries enter each chunk cast to bf16 and leave cast to f32, as
    the JAX package casts them."""
    jconf = _jmln(4, updater="sgd").conf
    jnet = JMLN(jconf, compute_dtype="bfloat16").init()
    net = _port_mln(jnet, compute_dtype="bfloat16")
    for s in range(2):
        batch = _data(50 + s)
        np.testing.assert_allclose(float(net.fit_batch(batch)),
                                   float(jnet.fit_batch(batch)),
                                   rtol=BF16_LOSS_RTOL)
    _assert_trees_close(jnet.params, net.params, **BF16_PARAM_TOL)
    assert net.iteration == jnet.iteration == 6


def test_bptt_remat_trains_as_without_it():
    """bptt_remat recomputes each step's gates in the backward: after a
    TBPTT fit the params and updater state equal the plain fit's."""
    nets = []
    for remat in (False, True):
        net = _port_mln(_jmln(5, remat=remat))
        assert net.conf.layers[0].bptt_remat is remat
        for s in range(2):
            net.fit_batch(_data(60 + s, masks=True))
        nets.append(net)
    for a, b in zip(leaves(nets[0].params) + leaves(nets[0].updater_states),
                    leaves(nets[1].params) + leaves(nets[1].updater_states)):
        np.testing.assert_allclose(_np(b), _np(a), **REMAT_TOL)


def test_non_tbptt_net_trains_full_sequences_in_one_step():
    """backprop_type standard: one step over the whole sequence, as the
    JAX package's."""
    jnet = _jmln(4)
    jnet.conf.backprop_type = "standard"
    net = _port_mln(jnet)
    batch = _data(70)
    np.testing.assert_allclose(float(net.fit_batch(batch)),
                               float(jnet.fit_batch(batch)), rtol=LOSS_RTOL)
    assert net.iteration == jnet.iteration == 1
    _assert_matches_jax(jnet, net, **PARAM_TOL)


# ------------------------------------------------------------- the engine


def test_step_program_run_is_fit_batch_and_run_group_refuses():
    a, b = _port_mln(_jmln(5)), _port_mln(_jmln(5))
    prog = StepProgram(a)
    for s in range(2):
        x, y, fm, lm = _data(80 + s, masks=True)
        la = prog.run(x, y, fm, lm)
        lb = b.fit_batch((x, y, fm, lm))
        assert torch.equal(la, lb)
    for x, y in zip(leaves(a.params) + leaves(a.updater_states),
                    leaves(b.params) + leaves(b.updater_states)):
        assert torch.equal(x, y)
    assert a.iteration == b.iteration == 6
    xs, ys = (np.stack([d, d]) for d in _data(82))
    with pytest.raises(NotImplementedError, match="truncated BPTT"):
        prog.run_group(xs, ys)


def test_training_master_and_parallel_wrapper_train_tbptt_nets():
    """At steps_per_dispatch=1 both route each batch through
    StepProgram.run, so a TBPTT graph trains chunk by chunk, bit for bit
    as hand-driven run calls."""
    data = [_data(90 + s) for s in range(3)]
    jg = _jgraph(5)
    tm_net, pw_net, ref = _port_graph(jg), _port_graph(jg), _port_graph(jg)
    TrainingMaster(tm_net).fit(lambda s: data[s], 3)
    ParallelWrapper(pw_net).fit(data)
    prog = StepProgram(ref)
    for x, y in data:
        prog.run(x, y)
    assert ref.iteration == 9
    _assert_bitwise(tm_net, ref)
    _assert_bitwise(pw_net, ref)


# ------------------------------------------------------------------ zoo


def test_text_generation_lstm_json_matches_jax_zoo():
    for remat in (False, True):
        jz = jzoo.TextGenerationLSTM(num_classes=20, input_shape=(30, 20))
        tz = TextGenerationLSTM(num_classes=20, input_shape=(30, 20))
        jz.bptt_remat = tz.bptt_remat = remat
        assert tz.conf().to_json() == jz.conf().to_json()


def test_text_generation_lstm_trains_through_step_program():
    """The zoo model at its width (2x GravesLSTM(256), vocab 20, T=60:
    chunks of 50 and 10) on a learnable next-character sequence (each
    character's successor fixed by a seeded permutation): the loss of the
    first chunk falls."""
    V, TT = 20, 60
    net = TextGenerationLSTM(num_classes=V, input_shape=(TT, V)).init_model(
        device="cpu")
    rng = np.random.default_rng(7)
    perm = rng.permutation(V)
    ids = np.empty((2, TT + 1), np.int64)
    ids[:, 0] = rng.integers(0, V, 2)
    for t in range(TT):
        ids[:, t + 1] = perm[ids[:, t]]
    x = np.eye(V, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(V, dtype=np.float32)[ids[:, 1:]]
    prog = StepProgram(net)
    first = [float(net.score((x[:, :50], y[:, :50])))]
    for _ in range(8):
        prog.run(x, y)
        first.append(float(net.score((x[:, :50], y[:, :50]))))
    assert net.iteration == 16
    # rmsprop's first step at the zoo's lr overshoots (150 -> 344 in a
    # CPU reading), then the loss falls (95.5 after 8 steps)
    assert all(np.isfinite(first)) and first[-1] < 0.75 * first[0], first
