"""Recurrent layers (counterpart of deeplearning4j_tpu/nn/layers/recurrent.py):
LSTM, GravesLSTM (peepholes) and GravesBidirectionalLSTM.

Same fields, params and arithmetic as the JAX package:
- the four gates are fused along 4H in the order [i, f, o, g]; params
  `W [nIn, 4H]`, `RW [H, 4H]`, `b [4H]` (the forget block `b[H:2H]` starts
  at `forget_gate_bias_init`), and for GravesLSTM `P [3, H]`, the
  peepholes: `i` and `f` see `c_prev`, `o` sees the new `c`;
- the input projection `x @ W + b` is hoisted out of the time loop as one
  product over every timestep, taken after going time-major when
  nIn <= 4H (the smaller tensor moves), and each step adds `h_prev @ RW`
  to it, in that order, so rounding follows the JAX package's scan;
- a [B, T] mask freezes `h` and `c` where it is 0: a masked step outputs
  the frozen `h`, not zero.

The time loop is a Python loop over T (the JAX package's `lax.scan`);
backward comes from autograd through it. `bptt_remat` wraps each
timestep's cell in `torch.utils.checkpoint` (non-reentrant), as
`jax.checkpoint(body)` does: the backward recomputes the gates instead of
keeping them, with the same gradients.

Streaming: `apply(..., state=carry)` starts from a carry and returns the
new one, which the containers thread through truncated BPTT chunks and
`rnn_time_step`; `step(params, x_t, carry)` is the single-step cell.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    InputType,
    InputTypeRecurrent,
)
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer
from deeplearning4j_tpu_torch.nn.weights import init_weights


def lstm_cell(gates, c_prev, gate_act, cell_act, peepholes=None):
    """One LSTM cell update from the pre-activation fused gates [B, 4H]:
    returns (h, c)."""
    i_g, f_g, o_g, g_g = torch.chunk(gates, 4, dim=-1)
    if peepholes is not None:
        p_i, p_f, p_o = peepholes
        i_g = i_g + c_prev * p_i
        f_g = f_g + c_prev * p_f
    i = gate_act(i_g)
    f = gate_act(f_g)
    g = cell_act(g_g)
    c = f * c_prev + i * g
    if peepholes is not None:
        o_g = o_g + c * p_o
    o = gate_act(o_g)
    return o * cell_act(c), c


def _scan_body(gates_t, h_prev, c_prev, RW, peep, keep, gate_act, cell_act):
    """One timestep of the hoisted scan: the recurrent product added to
    the projected input, the cell, and the mask's freeze."""
    gates = gates_t + h_prev @ RW
    h, c = lstm_cell(gates, c_prev, gate_act, cell_act, peep)
    if keep is not None:
        h = torch.where(keep, h, h_prev)
        c = torch.where(keep, c, c_prev)
    return h, c


@dataclass(kw_only=True)
class LSTM(BaseLayer):
    """Standard LSTM over [B, T, nIn] -> [B, T, nOut]."""

    activation: Optional[str] = "tanh"
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0
    # recompute each step's gates in the backward pass instead of keeping
    # them (the JAX package's jax.checkpoint around the scan body)
    bptt_remat: bool = False

    _peepholes: bool = False  # GravesLSTM flips this

    def set_n_in(self, input_type: InputType) -> None:
        if not isinstance(input_type, InputTypeRecurrent):
            raise ValueError(f"LSTM needs recurrent input, got {input_type}")
        self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(
            self.n_out, getattr(input_type, "timeseries_length", None))

    def init_params(self, gen, input_type, dtype=torch.float32):
        H = self.n_out
        W = init_weights(self.weight_init, gen, (self.n_in, 4 * H),
                         fan_in=self.n_in, fan_out=H, dtype=dtype)
        RW = init_weights(self.weight_init, gen, (H, 4 * H),
                          fan_in=H, fan_out=H, dtype=dtype)
        b = torch.zeros((4 * H,), dtype=dtype)
        b[H:2 * H] = self.forget_gate_bias_init   # [i, f, o, g]: f is 1
        params = {"W": W, "RW": RW, "b": b}
        if self._peepholes:
            params["P"] = init_weights(self.weight_init, gen, (3, H),
                                       fan_in=H, fan_out=H, dtype=dtype)
        return params

    def _acts(self):
        return (get_activation(self.gate_activation),
                get_activation(self.activation))

    def step(self, params, x_t, carry):
        """x_t [B, nIn], carry (h [B,H], c [B,H]) -> (y_t [B,H], new
        carry)."""
        h_prev, c_prev = carry
        gate_act, cell_act = self._acts()
        gates = x_t @ params["W"] + h_prev @ params["RW"] + params["b"]
        peep = tuple(params["P"]) if self._peepholes else None
        h, c = lstm_cell(gates, c_prev, gate_act, cell_act, peep)
        return h, (h, c)

    def initial_carry(self, batch_size, dtype=torch.float32, device=None):
        z = torch.zeros((batch_size, self.n_out), dtype=dtype, device=device)
        return (z, z)

    def _scan(self, params, x, mask, carry0, reverse=False):
        """The whole sequence: x [B, T, nIn] -> (outputs [B, T, H], final
        carry). `reverse` walks time backwards and keeps each output at
        its own timestep."""
        gate_act, cell_act = self._acts()
        peep = tuple(params["P"]) if self._peepholes else None
        W, RW, b = params["W"], params["RW"], params["b"]
        if x.shape[-1] <= 4 * self.n_out:
            xw = x.transpose(0, 1) @ W + b          # [T, B, 4H]
        else:
            xw = (x @ W + b).transpose(0, 1)
        # one unbind: its backward stacks the T step gradients once, where
        # T selects would each add a zero-filled [T, B, 4H] gradient
        xw = xw.unbind(0)
        keep = None if mask is None else (mask.transpose(0, 1) > 0)[..., None]
        remat = self.bptt_remat and torch.is_grad_enabled()
        T = len(xw)
        h, c = carry0
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            args = (xw[t], h, c, RW, peep,
                    None if keep is None else keep[t], gate_act, cell_act)
            if remat:
                h, c = checkpoint(_scan_body, *args, use_reentrant=False)
            else:
                h, c = _scan_body(*args)
            outs[t] = h
        return torch.stack(outs, dim=1), (h, c)

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        carry0 = state if state is not None else self.initial_carry(
            x.shape[0], x.dtype, x.device)
        return self._scan(params, x, mask, carry0)


@dataclass(kw_only=True)
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013)."""

    _peepholes: bool = True


@dataclass(kw_only=True)
class GravesBidirectionalLSTM(BaseLayer):
    """Bidirectional peephole LSTM; the forward and backward passes are
    concatenated on the feature axis -> [B, T, 2*nOut]. Params
    {"fwd": ..., "bwd": ...}, each a GravesLSTM's."""

    activation: Optional[str] = "tanh"
    gate_activation: str = "sigmoid"
    forget_gate_bias_init: float = 1.0

    def _directional(self) -> GravesLSTM:
        return GravesLSTM(
            n_in=self.n_in, n_out=self.n_out, activation=self.activation,
            gate_activation=self.gate_activation,
            forget_gate_bias_init=self.forget_gate_bias_init,
            weight_init=self.weight_init, bias_init=self.bias_init)

    def set_n_in(self, input_type: InputType) -> None:
        if not isinstance(input_type, InputTypeRecurrent):
            raise ValueError(f"BiLSTM needs recurrent input, got {input_type}")
        self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(
            2 * self.n_out, getattr(input_type, "timeseries_length", None))

    def init_params(self, gen, input_type, dtype=torch.float32):
        sub = self._directional()
        return {"fwd": sub.init_params(gen, input_type, dtype),
                "bwd": sub.init_params(gen, input_type, dtype)}

    def initial_carry(self, batch_size, dtype=torch.float32, device=None):
        c = self._directional().initial_carry(batch_size, dtype, device)
        return (c, c)

    def apply(self, params, x, *, train=False, rng=None, state=None,
              mask=None):
        x = self._maybe_dropout_input(x, train, rng)
        sub = self._directional()
        zero = sub.initial_carry(x.shape[0], x.dtype, x.device)
        # only the forward direction carries state across calls (TBPTT
        # chunks): the backward one is anti-causal and restarts from zero
        # in every window, or it would leak future state backwards
        fwd, cf = sub._scan(params["fwd"], x, mask,
                            state[0] if state is not None else zero)
        bwd, cb = sub._scan(params["bwd"], x, mask, zero, reverse=True)
        return torch.cat([fwd, bwd], dim=-1), (cf, cb)


# the layers whose apply takes and returns an RNN carry
RECURRENT_LAYERS = (LSTM, GravesBidirectionalLSTM)
