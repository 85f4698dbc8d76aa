"""The port's train step against the JAX package: losses, updaters and
schedules, the flat chain's order, train-mode BatchNorm, and
`ComputationGraph.fit_batch` on the `_mini_resnet` of tests/test_helpers.py
in every helper mode (f32, the JAX test's tolerances); resuming a
JAX-trained net in the port; ResNet-50 at a small size; determinism."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu.nn import updater as jupd
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import BatchNormalization as JBN
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.updater.flat_chain import FlatTrainChain as JChain
from deeplearning4j_tpu.util.model_serializer import write_model
from deeplearning4j_tpu_torch.nn import losses as tlosses
from deeplearning4j_tpu_torch.nn import updater as tupd
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import BatchNormalization as TBN
from deeplearning4j_tpu_torch.nn.layers import DenseLayer as TDense
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_jax,
    restore_computation_graph,
)
from deeplearning4j_tpu_torch.util.tree import leaves
from deeplearning4j_tpu_torch.zoo.models import ResNet50
from test_helpers import _data, _mini_resnet

MODES = ("none", "fused", "pallas")
# tests/test_helpers.py's none-vs-fused training tolerances
LOSS_RTOL = 5e-4
PARAM_TOL = dict(rtol=5e-3, atol=5e-5)


def _np(t):
    return np.asarray(t.detach().cpu()) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _assert_trees_close(jtree, ttree, **tol):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = leaves(ttree)
    assert len(jl) == len(tl)
    for (path, a), b in zip(jl, tl):
        np.testing.assert_allclose(_np(b), np.asarray(a), err_msg=str(path),
                                   **tol)


# ----------------------------------------------------------------- losses


def _loss_inputs(rng, name):
    B, C = 6, 5
    pre = rng.normal(size=(B, C)).astype(np.float32)
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        lab = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    elif name in ("xent", "reconstruction_crossentropy"):
        lab = (rng.random((B, C)) > 0.5).astype(np.float32)
    elif name in ("hinge", "squared_hinge"):
        lab = np.where(rng.random((B, C)) > 0.5, 1.0, -1.0).astype(np.float32)
    else:   # regression losses; positive for the logarithmic ones
        lab = rng.random((B, C)).astype(np.float32) + 0.5
        if name in ("msle", "mean_squared_logarithmic_error", "poisson"):
            pre = np.abs(pre) + 0.1
    return lab, pre


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(jlosses.LOSSES))
def test_every_loss_matches_jax(rng, name, masked):
    lab, pre = _loss_inputs(rng, name)
    mask = (rng.random(lab.shape[0]) > 0.3).astype(np.float32) \
        if masked else None
    jf, tf = jlosses.get_loss(name), tlosses.get_loss(name)
    act = {"mcxent": "softmax", "negativeloglikelihood": "softmax",
           "kl_divergence": "softmax", "xent": "sigmoid",
           "reconstruction_crossentropy": "sigmoid"}.get(name, "identity")
    ref = jf(jnp.asarray(lab), jnp.asarray(pre), act,
             None if mask is None else jnp.asarray(mask))
    tp = torch.from_numpy(pre).requires_grad_()
    got = tf(torch.from_numpy(lab), tp, act,
             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    jg = jax.grad(lambda p: jnp.sum(jf(jnp.asarray(lab), p, act)))(
        jnp.asarray(pre))
    got = tf(torch.from_numpy(lab), tp, act)
    got.sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


def test_loss_upcasts_bf16_and_keeps_f32_labels():
    lab = torch.eye(4)[torch.tensor([0, 2, 1])]
    pre = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    out = tlosses.get_loss("mcxent")(lab, pre.to(torch.bfloat16))
    assert out.dtype == torch.float32
    with pytest.raises(ValueError, match="Unknown loss"):
        tlosses.get_loss("nope")


# --------------------------------------------------------------- updaters


UPDATERS = ["sgd", "none", "nesterovs", "adagrad", "rmsprop", "adadelta",
            "adam", "adamax", "nadam"]


@pytest.mark.parametrize("name", UPDATERS)
def test_every_updater_matches_jax_over_3_steps(rng, name):
    conf = SimpleNamespace(momentum=0.8, epsilon=None, rho=0.9, beta1=0.85,
                           beta2=0.99, rmsprop_decay=0.9)
    params = {"W": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    ju, tu = jupd.get_updater(name, conf), tupd.get_updater(name, conf)
    assert ju.sig == tu.sig
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = ju.init(jp), tu.init(tp)
    for step, g in enumerate(grads):
        jd, js = ju.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                           0.05, step)
        td, ts = tu.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp, 0.05, step)
        jp = jax.tree_util.tree_map(lambda a, d: a + d, jp, jd)
        tp = {k: tp[k] + td[k] for k in tp}
    _assert_trees_close(jp, tp, rtol=1e-5, atol=1e-7)
    _assert_trees_close(js, ts, rtol=1e-5, atol=1e-7)


def test_updater_registry():
    with pytest.raises(ValueError, match="Unknown updater"):
        tupd.get_updater("nope")
    tupd.register_updater("half_sgd_test", lambda conf: tupd.sgd())
    try:
        assert tupd.get_updater("HALF_SGD_TEST").sig == ("sgd",)
    finally:
        tupd._CUSTOM_UPDATERS.pop("half_sgd_test")
    assert tupd.get_updater("nesterov").sig == ("nesterovs", 0.9)


POLICIES = ["none", "score", "exponential", "inverse", "poly", "sigmoid",
            "step", "torch_step", "schedule"]


@pytest.mark.parametrize("policy", POLICIES)
def test_every_schedule_policy_matches_jax(policy):
    conf = SimpleNamespace(learning_rate=0.1, lr_policy=policy,
                           lr_policy_decay_rate=0.7, lr_policy_steps=2.0,
                           lr_policy_power=1.5, lr_schedule={1: 0.05, 3: 0.01})
    for step in range(5):
        ref = float(jupd.schedule_lr(conf, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(tupd.schedule_lr(conf, step), ref,
                                   rtol=1e-6, err_msg=f"step {step}")


def test_fused_apply_matches_jax(rng):
    """Groups by (sig, lr factor), a frozen layer, a parameterless layer
    and a custom (sig-less) rule, against the JAX package's fused_apply."""
    shapes = [{"W": (3, 2), "b": (2,)}, {"W": (2, 2)}, {}, {"g": (4,)},
              {"W": (2, 3)}]
    ps = [{k: rng.normal(size=s).astype(np.float32) for k, s in d.items()}
          for d in shapes]
    gs = [{k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in p.items()} for p in ps]
    specs = [("nesterovs", 1.0, False), ("nesterovs", 1.0, False),
             ("nesterovs", 1.0, False), ("adam", 2.0, False),
             ("nesterovs", 1.0, True)]

    def run(mod, conv, custom):
        items = []
        for (name, lf, frozen), p, g in zip(specs, ps, gs):
            u = mod.get_updater(name)
            if custom and name == "adam":
                u = mod.Updater(u.init, u.update, None)
            pp = {k: conv(v) for k, v in p.items()}
            items.append((u, lf, frozen, pp, {k: conv(v) for k, v in
                                              g.items()}, u.init(pp)))
        return mod.fused_apply(items, 0.1, 0)

    for custom in (False, True):
        jp, js = run(jupd, jnp.asarray, custom)
        tp, ts = run(tupd, torch.from_numpy, custom)
        _assert_trees_close(jp, tp, rtol=1e-6, atol=1e-7)
        _assert_trees_close(js, ts, rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- flat chain


def _port_of(jnet, compute_dtype=None, with_updater=False):
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    net = ComputationGraph(conf, compute_dtype=compute_dtype, device="cpu")
    net.init()
    tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out = params_from_jax(tonp(jnet.params), tonp(jnet.states), device="cpu",
                          updater_states=(tonp(jnet.updater_states)
                                          if with_updater else None))
    net.params, net.states = out[0], out[1]
    if with_updater:
        net.updater_states = out[2]
    net.iteration = jnet.iteration
    return net


def _nesterov_mini_resnet(mode):
    conf = _mini_resnet(mode).conf
    conf.updater = "nesterovs"
    conf.momentum = 0.9
    return JGraph(conf).init()


def test_flat_chain_order_equals_ravel_pytree():
    jnet = _nesterov_mini_resnet("pallas")
    net = _port_of(jnet, with_updater=True)
    chain = net._flat_chain_obj()
    jchain = JChain.build(jnet)
    assert chain is not None and jchain is not None
    assert chain.fields == jchain.fields == ("v",)
    flat = chain.ravel(net.params)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(ravel_pytree(jnet.params)[0]))
    back = chain.unravel(flat)
    for a, b in zip(leaves(back), leaves(net.params)):
        assert torch.equal(a, b)
    rng = np.random.default_rng(5)
    v = {k: {p: rng.normal(size=t.shape).astype(np.float32)
             for p, t in d.items()} for k, d in net.params.items()}
    ju = jchain.ravel_upd({k: {"v": {p: jnp.asarray(a) for p, a in d.items()}}
                           for k, d in v.items()})
    tu = chain.ravel_upd({k: {"v": {p: torch.from_numpy(a)
                                    for p, a in d.items()}}
                          for k, d in v.items()})
    np.testing.assert_array_equal(tu["v"].numpy(), np.asarray(ju["v"]))


# -------------------------------------------------------------- batchnorm


@pytest.mark.parametrize("stat_sample", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_train_values_and_gradients_match_jax(rng, dtype, stat_sample):
    x = rng.normal(size=(4, 3, 3, 5)).astype(np.float32) * 2 + 0.5
    gamma = (rng.normal(size=5) * 0.2 + 1).astype(np.float32)
    beta = (rng.normal(size=5) * 0.1).astype(np.float32)
    wout = rng.normal(size=x.shape).astype(np.float32)
    st = {"mean": np.zeros(5, np.float32), "var": np.ones(5, np.float32)}
    jl, tl = JBN(stat_sample=stat_sample), TBN(stat_sample=stat_sample)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jf(x, g, b):
        y, ns = jl.apply({"gamma": g, "beta": b}, x.astype(jdt), train=True,
                         state={k: jnp.asarray(v) for k, v in st.items()})
        return jnp.sum(y.astype(jnp.float32) * wout), (y, ns)

    (_, (jy, jns)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    ty, tns = tl.apply({"gamma": tg, "beta": tb}, tx.to(tdt), train=True,
                       state={k: torch.from_numpy(v) for k, v in st.items()})
    (ty.float() * torch.from_numpy(wout)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=5e-2)
    np.testing.assert_allclose(_np(ty.float()),
                               np.asarray(jy.astype(jnp.float32)), **tol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(_np(tns[k]), np.asarray(jns[k]),
                                   rtol=1e-5, atol=1e-6)
        assert not tns[k].requires_grad
    gtol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=5e-2, atol=0.5)
    for t, j in zip((tx, tg, tb), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **gtol)


def test_bn_eval_batch_statistics_one_pass_for_bf16(rng):
    x = (rng.normal(size=(6, 4)) * 3 + 1).astype(np.float32)
    jy, _ = JBN().apply({"gamma": jnp.ones(4), "beta": jnp.zeros(4)},
                        jnp.asarray(x, jnp.bfloat16), state=None)
    ty, _ = TBN().apply({"gamma": torch.ones(4), "beta": torch.zeros(4)},
                        torch.from_numpy(x).to(torch.bfloat16), state=None)
    np.testing.assert_allclose(_np(ty.float()),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


# ------------------------------------------------- layers: reg, dropout


def test_regularization_loss_matches_jax_and_exempts_biases(rng):
    p = {"W": rng.normal(size=(3, 2)).astype(np.float32),
         "b": rng.normal(size=(2,)).astype(np.float32)}
    jl, tl = JDense(n_in=3, n_out=2, l1=0.01, l2=0.1), \
        TDense(n_in=3, n_out=2, l1=0.01, l2=0.1)
    ref = jl.regularization_loss({k: jnp.asarray(v) for k, v in p.items()})
    got = tl.regularization_loss({k: torch.from_numpy(v)
                                  for k, v in p.items()})
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    assert TDense(n_in=3, n_out=2).regularization_loss(p) == 0.0


def test_train_mode_dropout_raises_until_ported():
    layer = TDense(n_in=3, n_out=2, dropout=0.5, activation="relu")
    p = {"W": torch.zeros(3, 2), "b": torch.zeros(2)}
    layer.apply(p, torch.zeros(1, 3))          # inference: identity
    with pytest.raises(NotImplementedError, match="dropout"):
        layer.apply(p, torch.zeros(1, 3), train=True)


# -------------------------------------------------- the mini ResNet step


@pytest.mark.parametrize("mode", MODES)
def test_mini_resnet_training_matches_jax(mode):
    x, y = _data(np.random.default_rng(2024))
    jnet = _mini_resnet(mode)
    net = _port_of(jnet)
    for step in range(4):
        lj = float(jnet.fit_batch(([x], [y])))
        lt = float(net.fit_batch(([x], [y])))
        np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL,
                                   err_msg=f"step {step}")
    assert net.iteration == jnet.iteration == 4
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    _assert_trees_close(jnet.states, net.states, **PARAM_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_mini_resnet_ghost_batchnorm_training_matches_jax(mode):
    """stat_sample=2 on every BatchNorm: statistics of the leading half of
    the batch (the fused convs' sampled statistics and the composed
    backward's zero tail pad)."""
    x, y = _data(np.random.default_rng(77))
    conf = _mini_resnet(mode).conf
    for node in conf.nodes:
        if isinstance(node.obj, JBN):
            node.obj.stat_sample = 2
    jnet = JGraph(conf).init()
    net = _port_of(jnet)
    for _ in range(3):
        np.testing.assert_allclose(float(net.fit_batch(([x], [y]))),
                                   float(jnet.fit_batch(([x], [y]))),
                                   rtol=LOSS_RTOL)
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    _assert_trees_close(jnet.states, net.states, **PARAM_TOL)


@pytest.mark.parametrize("mode", ["none", "pallas"])
def test_mini_resnet_bf16_policy_step_matches_jax(mode):
    """Under the bf16 policy the packages round at different places; the
    first losses agree to the repo's bf16 tolerance."""
    x, y = _data(np.random.default_rng(7))
    jnet = _mini_resnet(mode)
    jb = JGraph(jnet.conf, compute_dtype=jnp.bfloat16).init()
    jb.params, jb.states = jnet.params, jnet.states
    net = _port_of(jnet, compute_dtype=torch.bfloat16)
    for _ in range(2):
        lj = float(jb.fit_batch(([x], [y])))
        lt = float(net.fit_batch(([x], [y])))
        np.testing.assert_allclose(lt, lj, rtol=2e-2)
    assert all(t.dtype == torch.float32 for t in leaves(net.params))


def test_per_layer_update_path_matches_jax_and_flat_path():
    """A frozen layer turns the flat chain off: the per-layer fused_apply
    path against the JAX package's, and (unfrozen) against the flat
    path in the port."""
    x, y = _data(np.random.default_rng(3))
    jnet = _nesterov_mini_resnet("fused")
    jnet.conf.node("b1b_conv").obj.frozen = True
    net = _port_of(jnet)
    assert net.conf.node("b1b_conv").obj.frozen
    for _ in range(2):
        np.testing.assert_allclose(float(net.fit_batch(([x], [y]))),
                                   float(jnet.fit_batch(([x], [y]))),
                                   rtol=LOSS_RTOL)
    assert net._flat_train is None
    _assert_trees_close(jnet.params, net.params, **PARAM_TOL)
    _assert_trees_close(jnet.updater_states, net.updater_states, **PARAM_TOL)

    a, b = _port_of(_nesterov_mini_resnet("fused")), None
    b = _port_of(_nesterov_mini_resnet("fused"))
    b._flat_chain = None                      # force the per-layer path
    for _ in range(2):
        a.fit_batch(([x], [y]))
        b.fit_batch(([x], [y]))
    assert a._flat_train is not None
    for p, q in zip(leaves(a.params), leaves(b.params)):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)


def test_jax_trained_net_resumes_in_port(tmp_path):
    """JAX 2 steps == JAX 1 step, saved, restored in the port (params,
    BN states, nesterov momentum, iteration) + 1 port step."""
    x, y = _data(np.random.default_rng(11))
    ref = _nesterov_mini_resnet("pallas")
    for _ in range(2):
        ref.fit_batch(([x], [y]))
    half = _nesterov_mini_resnet("pallas")
    half.fit_batch(([x], [y]))
    path = os.path.join(tmp_path, "half.zip")
    write_model(half, path)
    net = restore_computation_graph(path, device="cpu")
    assert net.iteration == 1
    assert float(np.abs(leaves(net.updater_states)[0].numpy()).max()) > 0
    net.fit_batch(([x], [y]))
    _assert_trees_close(ref.params, net.params, **PARAM_TOL)
    _assert_trees_close(ref.states, net.states, **PARAM_TOL)
    _assert_trees_close(ref.updater_states, net.updater_states, **PARAM_TOL)


def test_fit_epochs_and_score():
    x, y = _data(np.random.default_rng(4))
    jnet = _mini_resnet("fused")
    net = _port_of(jnet)
    batches = [([x[:4]], [y[:4]]), ([x[4:]], [y[4:]])]
    net.fit(batches, epochs=2)
    jnet.fit(batches, epochs=2)
    assert net.iteration == 4 and net.epoch == 2
    np.testing.assert_allclose(net.score(), jnet.score(), rtol=LOSS_RTOL)
    np.testing.assert_allclose(net.score(([x], [y])),
                               jnet.score(([x], [y])), rtol=LOSS_RTOL)


# --------------------------------------------------- ResNet-50, determinism


def test_resnet50_small_pallas_step_matches_none():
    """One step of ResNet-50 at batch 2 under "pallas" against "none", in
    float64, at 64x64. In f32 two paths differ by their relu mask flips
    (see the next test), so float64 is where the two algorithms must
    agree: to 1e-5 of each update's size, with a 1e-9 floor for the conv
    biases, whose gradient in front of a BatchNorm is zero up to
    rounding."""
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3))
    y = np.eye(7)[[3, 5]]
    runs = {}
    for mode in ("pallas", "none"):
        conf = ResNet50(num_classes=7, input_shape=(64, 64, 3)).conf()
        conf.helper_mode = mode
        net = ComputationGraph(conf, dtype=torch.float64, device="cpu").init()
        p0 = [t.clone() for t in leaves(net.params)]
        loss = float(net.fit_batch(([x], [y])))
        runs[mode] = (loss, [t - t0 for t, t0 in zip(leaves(net.params), p0)])
    np.testing.assert_allclose(runs["pallas"][0], runs["none"][0], rtol=1e-9)
    for dp, dn in zip(runs["pallas"][1], runs["none"][1]):
        assert float((dp - dn).abs().max()) <= \
            1e-5 * float(dn.abs().max()) + 1e-9


def test_resnet50_f32_step_matches_float64_given_its_relu_masks(monkeypatch):
    """Where an f32 train step departs from float64: at the few relu inputs
    that lie within f32 rounding of zero. Such an element changes sign
    (a mask flip), its gradient changes by its whole size, and the
    BatchNorm backward spreads that over its channel, so the whole update
    moves by some 1e-3 of its size. With the float64 step's relu masks
    imposed, the f32 step of ResNet-50 ("none", 64x64, batch 8) matches
    the float64 step within 1e-4 of the largest update."""
    from deeplearning4j_tpu_torch.nn import activations

    x = np.random.default_rng(2).normal(size=(8, 64, 64, 3))
    y = np.eye(10)[np.random.default_rng(3).integers(0, 10, 8)]
    conf = ResNet50(num_classes=10, input_shape=(64, 64, 3)).conf()
    conf.helper_mode = "none"
    p64 = ComputationGraph(conf, dtype=torch.float64, device="cpu").init()
    # the last BN of each residual branch with a small gamma, as in trained
    # ResNets (and chip_smoke.randomize_batchnorm): at gamma 1 the sixteen
    # blocks amplify ordinary f32 rounding to ~5e-5 even without flips
    for name, d in p64.params.items():
        if name.endswith("_c_bn"):
            d["gamma"] = d["gamma"] * 0.2
    masks, seen = [], {"i": 0, "flips": 0}

    def record(t):
        masks.append(t.detach() > 0)
        return torch.relu(t)

    def impose(t, own=False):
        m = masks[seen["i"]]
        seen["i"] += 1
        seen["flips"] += int((m != (t.detach() > 0)).sum())
        return torch.relu(t) if own else t * m.to(t.dtype)

    def step(relu, dtype):
        seen.update(i=0, flips=0)
        monkeypatch.setitem(activations.ACTIVATIONS, "relu", relu)
        net = ComputationGraph(conf, dtype=dtype, device="cpu")
        net.params = {k: {q: t.to(dtype) for q, t in d.items()}
                      for k, d in p64.params.items()}
        net.states = {k: {q: t.to(dtype) for q, t in d.items()}
                      for k, d in p64.states.items()}
        net._init_updaters()
        p0 = [t.double() for t in leaves(net.params)]
        net.fit_batch(([x], [y]))
        return [t.double() - t0 for t, t0 in zip(leaves(net.params), p0)]

    ref = step(record, torch.float64)
    big = max(float(b.abs().max()) for b in ref)
    err = lambda u: max(float((a - b).abs().max())
                        for a, b in zip(u, ref)) / big
    own = err(step(lambda t: impose(t, own=True), torch.float32))
    own_flips = seen["flips"]
    imposed = err(step(impose, torch.float32))
    assert seen["i"] == len(masks) == 49
    print(f"f32 step against float64 ({sum(int(m.numel()) for m in masks)} "
          f"relu inputs): with its own masks {own_flips} flips, update error "
          f"{own:.3e} of the largest update; with the float64 masks "
          f"{imposed:.3e}")
    assert imposed <= 1e-4


def test_two_port_runs_from_one_seed_are_bitwise_equal():
    x, y = _data(np.random.default_rng(9))
    runs = []
    for _ in range(2):
        conf = ComputationGraphConfiguration.from_json(
            _mini_resnet("pallas").conf.to_json())
        conf.updater = "nesterovs"
        net = ComputationGraph(conf, device="cpu").init()
        losses = [float(net.fit_batch(([x], [y]))) for _ in range(3)]
        runs.append((losses, leaves(net.params), leaves(net.states)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1] + runs[0][2], runs[1][1] + runs[1][2]):
        assert torch.equal(a, b)
