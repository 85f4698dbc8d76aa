"""The port's pretraining layers (AutoEncoder, RBM, VariationalAutoencoder)
and MultiLayerNetwork.pretrain against the JAX package, on the CPU, f32.

The layers' `apply` and every deterministic term of their
`pretrain_loss` are held against the JAX package's on the same weights
and inputs at rtol 1e-5 / atol 1e-6 (the forward bar of the port's other
layers); where a loss samples, the port's own draws are replayed in the
JAX formula (the RBM's Gibbs sample, the VAE's reparameterization noise).
torch's generator cannot give JAX's bits, so `pretrain` is pinned within
the port: one seed gives one result, bit for bit. Configurations cross
both ways through JSON and model zips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import RBM as JRBM
from deeplearning4j_tpu.nn.layers import AutoEncoder as JAE
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import VariationalAutoencoder as JVAE
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util.model_serializer import (
    ModelSerializer as JSerializer,
)
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.serde import layer_from_dict
from deeplearning4j_tpu_torch.nn.layers import (
    RBM,
    AutoEncoder,
    OutputLayer,
    VariationalAutoencoder,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import (
    params_from_jax,
    restore_multi_layer_network,
)
from deeplearning4j_tpu_torch.util.tree import leaves

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(t):
    return t.detach().float().cpu().numpy()


def _tonp(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer_pair(jlayer, tlayer, n_in, seed=0):
    """Both layers with n_in resolved, JAX's seeded params and the port's
    copy of them."""
    for layer in (jlayer, tlayer):
        layer.set_n_in(JInputType.feed_forward(n_in) if layer is jlayer
                       else InputType.feed_forward(n_in))
        if getattr(layer, "weight_init", None) is None:
            layer.weight_init = "xavier"
    jp = jlayer.init_params(jax.random.PRNGKey(seed),
                            JInputType.feed_forward(n_in))
    (tp,), _ = params_from_jax([_tonp(jp)], device="cpu")
    return jp, tp


def _x(rng, n=6, d=10, binary=False):
    x = rng.random((n, d)) if binary else rng.normal(size=(n, d))
    return (x > 0.5 if binary else x).astype(np.float32)


@pytest.mark.parametrize("loss", ["mse", "xent"])
def test_autoencoder_matches_jax(rng, loss):
    jl, tl = (JAE(n_out=4, loss=loss, corruption_level=0.3),
              AutoEncoder(n_out=4, loss=loss, corruption_level=0.3))
    jp, tp = _layer_pair(jl, tl, 10)
    x = _x(rng, binary=loss == "xent")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(_np(tl.apply(tp, xt)[0]),
                               np.asarray(jl.apply(jp, x)[0]), **TOL)
    np.testing.assert_allclose(_np(tl.decode(tp, tl.encode(tp, xt))),
                               np.asarray(jl.decode(jp, jl.encode(jp, x))),
                               **TOL)
    # without a generator there is no corruption: a deterministic loss
    np.testing.assert_allclose(float(tl.pretrain_loss(tp, xt, None)),
                               float(jl.pretrain_loss(jp, x, None)), **TOL)
    g = torch.Generator().manual_seed(3)
    noisy = float(tl.pretrain_loss(tp, xt, g))
    assert np.isfinite(noisy) and noisy != float(tl.pretrain_loss(tp, xt,
                                                                  None))


@pytest.mark.parametrize("hidden,visible", [("BINARY", "BINARY"),
                                            ("GAUSSIAN", "GAUSSIAN"),
                                            ("BINARY", "GAUSSIAN")])
def test_rbm_matches_jax(rng, hidden, visible):
    kw = dict(n_out=5, hidden_unit=hidden, visible_unit=visible, k=2,
              sparsity=0.1)
    jl, tl = JRBM(**kw), RBM(**kw)
    jp, tp = _layer_pair(jl, tl, 10)
    x = _x(rng, binary=visible == "BINARY")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(_np(tl.apply(tp, xt)[0]),
                               np.asarray(jl.apply(jp, x)[0]), **TOL)
    h = np.asarray(jl.prop_up(jp, x))
    np.testing.assert_allclose(_np(tl.prop_down(tp, torch.from_numpy(h))),
                               np.asarray(jl.prop_down(jp, h)), **TOL)
    np.testing.assert_allclose(float(tl.free_energy(tp, xt)),
                               float(jl.free_energy(jp, x)), **TOL)
    np.testing.assert_allclose(float(tl.reconstruction_error(tp, xt)),
                               float(jl.reconstruction_error(jp, x)), **TOL)
    # CD-k: the port's Gibbs sample replayed in the JAX formula
    g = torch.Generator().manual_seed(4)
    v = tl.gibbs_sample(tp, xt, torch.Generator().set_state(g.get_state()))
    got = float(tl.pretrain_loss(tp, xt, g))
    h_mean = jnp.mean(jl.prop_up(jp, x), axis=0)
    want = float(jl.free_energy(jp, x) - jl.free_energy(jp, _np(v))
                 + jnp.mean((h_mean - 0.1) ** 2))
    np.testing.assert_allclose(got, want, **TOL)


def test_rbm_rejects_hidden_units_without_free_energy(rng):
    tl = RBM(n_out=3, hidden_unit="RECTIFIED")
    _, tp = _layer_pair(JRBM(n_out=3, hidden_unit="RECTIFIED"), tl, 10)
    with pytest.raises(NotImplementedError, match="RECTIFIED"):
        tl.pretrain_loss(tp, torch.from_numpy(_x(rng)),
                         torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        RBM(n_out=4, hidden_unit="SOFTPLUS")


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_vae_matches_jax(rng, dist, monkeypatch):
    kw = dict(n_out=3, latent_size=3, encoder_layer_sizes=(8, 7),
              decoder_layer_sizes=(6,), reconstruction_distribution=dist,
              num_samples=2)
    jl, tl = JVAE(**kw), VariationalAutoencoder(**kw)
    jp, tp = _layer_pair(jl, tl, 10)
    x = _x(rng, binary=dist == "bernoulli")
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(_np(tl.apply(tp, xt)[0]),
                               np.asarray(jl.apply(jp, x)[0]), **TOL)
    np.testing.assert_allclose(_np(tl.reconstruct(tp, xt)),
                               np.asarray(jl.reconstruct(jp, x)), **TOL)
    # the port's reparameterization noise, replayed in the JAX formula
    g = torch.Generator().manual_seed(5)
    replay = torch.Generator().set_state(g.get_state())
    eps = [np.asarray(torch.randn((6, 3), generator=replay))
           for _ in range(2)]
    got = float(tl.pretrain_loss(tp, xt, g))
    draws = iter(eps)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            next(draws)))
    want = float(jl.pretrain_loss(jp, x, jax.random.PRNGKey(0)))
    np.testing.assert_allclose(got, want, **TOL)


# ----------------------------------------------- configurations, zips


def _stack(NNC, IT, rbm, ae, vae, out, n_in=20, seed=2):
    return (NNC.Builder().seed(seed).updater("adam").learning_rate(1e-2)
            .list()
            .layer(rbm(n_out=12))
            .layer(ae(n_out=8, corruption_level=0.2))
            .layer(vae(n_out=4, latent_size=4, encoder_layer_sizes=(6,),
                       decoder_layer_sizes=(6,)))
            .layer(out(n_out=3, loss="mcxent"))
            .set_input_type(IT.feed_forward(n_in)).build())


def _port_stack(seed=2):
    return MultiLayerNetwork(
        _stack(NeuralNetConfiguration, InputType, RBM, AutoEncoder,
               VariationalAutoencoder, OutputLayer, seed=seed),
        device="cpu").init()


def test_configuration_json_matches_jax_both_ways():
    ours = _stack(NeuralNetConfiguration, InputType, RBM, AutoEncoder,
                  VariationalAutoencoder, OutputLayer)
    theirs = _stack(JNNC, JInputType, JRBM, JAE, JVAE, JOut)
    assert ours.to_json() == theirs.to_json()
    assert MultiLayerConfiguration.from_json(theirs.to_json()).to_json() \
        == ours.to_json()
    back = layer_from_dict(RBM(n_in=16, n_out=8, visible_unit="GAUSSIAN",
                               k=3, sparsity=0.1).to_dict())
    assert isinstance(back, RBM) and back.k == 3
    assert back.visible_unit == "GAUSSIAN"


def test_jax_written_zip_of_the_stack_loads_in_the_port(tmp_path, rng):
    jnet = JMLN(_stack(JNNC, JInputType, JRBM, JAE, JVAE, JOut)).init()
    x = _x(rng, n=5, d=20)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
    jnet.fit_batch((x, y))
    path = str(tmp_path / "stack.zip")
    JSerializer.write_model(jnet, path)
    net = restore_multi_layer_network(path, device="cpu")
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(jnet.output(x)),
                               **TOL)
    assert net.iteration == 1 and set(net.updater_states[2]) == {"m", "v"}


def _batches(rng, n=4, rows=16, d=20):
    return [(_x(rng, n=rows, d=d, binary=True),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, rows)])
            for _ in range(n)]


def _record_losses(net):
    """Patch each pretrain layer's loss to record its values."""
    seen = {}
    for i, layer in enumerate(net.conf.layers[:-1]):
        orig = layer.pretrain_loss

        def rec(p, x, g, orig=orig, i=i):
            v = orig(p, x, g)
            seen.setdefault(i, []).append(float(v.detach()))
            return v

        layer.pretrain_loss = rec
    return seen


def test_pretrain_is_seeded_deterministic_and_lowers_each_loss(rng):
    data = _batches(rng)
    a, b, c = _port_stack(), _port_stack(), _port_stack(seed=3)
    seen = _record_losses(a)
    for net in (a, b, c):
        assert net.pretrain(data, epochs=3) is net
    for p, q in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(p, q)
    assert any(not torch.equal(p, q)
               for p, q in zip(leaves(a.params), leaves(c.params)))
    assert sorted(seen) == [0, 1, 2] and all(len(v) == 12
                                             for v in seen.values())
    for i, v in seen.items():
        assert np.mean(v[-4:]) < np.mean(v[:4]), (i, v)
    # the head is not pretrained; fit trains the stack afterwards
    assert np.isfinite(float(a.fit_batch(data[0])))


def test_pretrain_feeds_earlier_layers_and_skips_frozen_ones(rng):
    """Layer 1 pretrains on layer 0's output (inference mode); a frozen
    pretrain layer keeps its params bit for bit."""
    net = _port_stack()
    net.conf.layers[1].frozen = True
    frozen = [t.clone() for t in leaves(net.params[1])]
    inputs = {}
    layer2 = net.conf.layers[2]
    orig = layer2.pretrain_loss

    def rec(p, x, g):
        inputs.setdefault("x", x)
        return orig(p, x, g)

    layer2.pretrain_loss = rec
    data = _batches(rng, n=1)
    net.pretrain(data, epochs=1)
    assert all(torch.equal(a, b) for a, b in zip(frozen,
                                                 leaves(net.params[1])))
    with torch.no_grad():
        h0 = net.conf.layers[0].apply(net.params[0],
                                      torch.from_numpy(data[0][0]))[0]
        want = net.conf.layers[1].apply(net.params[1], h0)[0]
    torch.testing.assert_close(inputs["x"], want)
