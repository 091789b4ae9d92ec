"""The reference's bf16 numerics, emulated in f32.

The JAX package builds its det and rec models with ``dtype=jnp.bfloat16``
and f32 parameters, and XLA runs each bf16 op as an f32 op whose result is
rounded to bf16. The port reproduces that: it computes in f32 on values
that are already bf16 (weights rounded once, activations rounded where the
reference rounds) and rounds with ``rb`` at the same points. The rules, read
from the compiled reference program:

- a conv / matmul takes bf16 operands and accumulates in f32;
- a result that feeds a bf16 op (a bias add, an activation, a residual add)
  is rounded first;
- a result that feeds an explicit cast to f32 is NOT rounded: BatchNorm
  (f32 statistics promote it), ``jnp.mean`` (sums in f32), the LSTM's f32
  cell state and the final ``astype(float32)`` of logits and det prob;
- BatchNorm is ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32;
- XLA contracts a multiply feeding an add into one fused multiply-add;
  ``fma`` reproduces it (BatchNorm, the normalizations, the box maths);
- a division by a constant is a multiplication by its f32 reciprocal, and a
  weakly typed constant in a bf16 op is a bf16 constant (``0.2`` is
  0.2001953125).

Only the accumulation order of the f32 sums differs from the reference, so
an output differs from it at most where a value lies within an f32 rounding
of a bf16 rounding boundary.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

SIXTH = float(torch.tensor(1.0) / torch.tensor(6.0))
POINT2_BF16 = float(torch.tensor(0.2).to(torch.bfloat16))


def rb(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to the nearest bf16 (ties to even), kept as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once: the product of two f32 values is
    exact in f64, so the f64 sum rounds to the fused result (up to a double
    rounding, which is rarer than one case in 2^29). A Python number is an
    f32 constant, as in the reference's program."""
    def f64(v):
        if isinstance(v, torch.Tensor):
            return v.double()
        return float(torch.tensor(v, dtype=torch.float32))
    return (f64(a) * f64(b) + f64(c)).float()


def emulate(model: nn.Module) -> nn.Module:
    """Switch a det or rec model with its weights loaded to the reference's
    bf16 numerics: round the weights and biases of every conv, linear and
    LSTM layer to bf16 in place (flax casts them to the compute dtype at each
    call; BatchNorm statistics and affine parameters stay f32) and make its
    forward take the emulating path."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.LSTM)):
                for p in m.parameters(recurse=False):
                    p.copy_(rb(p))
    model.bf16 = True
    return model


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=True)`` on NCHW ``x``, in f32
    and in the reference's order; the caller rounds."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return fma(x - bn.running_mean[:, None, None], mul[:, None, None], bn.bias[:, None, None])


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``clip(x / 6 + 0.5, 0, 1)`` on bf16 values, each op rounded."""
    return torch.clamp(rb(rb(x * SIXTH) + 0.5), 0.0, 1.0)


def act_raw(act, x: torch.Tensor) -> torch.Tensor:
    """The activation named ``act`` on bf16 ``x``, its result not yet
    rounded (an f32 consumer reads it as it is)."""
    if act == "hardswish":
        return x * hard_sigmoid(x)
    if act == "relu":
        return torch.relu(x)
    return x


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` over H, W of NCHW ``x``: an f32 sum times f32(1/n),
    rounded to bf16."""
    n = x.shape[2] * x.shape[3]
    inv = float(torch.tensor(1.0) / torch.tensor(float(n)))
    return rb(x.sum(dim=(2, 3), keepdim=True) * inv)


def conv(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The conv (or transposed conv) ``m`` on ``x`` without its bias, in
    f32 on bf16 operands; result not rounded."""
    if isinstance(m, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, m.weight, None, m.stride, m.padding)
    return F.conv2d(x, m.weight, None, m.stride, m.padding, m.dilation, m.groups)


def conv_bias(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A conv with bias whose sum feeds a bf16 op: ``rb(rb(conv) + b)``."""
    return rb(rb(conv(m, x)) + m.bias[:, None, None])


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """f32 ``1 / (1 + exp(-x))``, the reference's expansion."""
    return 1.0 / (torch.exp(-x) + 1.0)


def _sigmoid_gate(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` on bf16 ``x``: exp and the sum rounded, the
    quotient not yet rounded."""
    return 1.0 / rb(rb(torch.exp(-x)) + 1.0)


def bilstm(lstm: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """A bidirectional one-layer ``nn.LSTM`` (batch first, weights already
    bf16) as flax's ``OptimizedLSTMCell(dtype=bfloat16)`` pair computes it.

    Per step: the input and hidden products are rounded, the hidden bias is
    added and rounded, the gate sums are rounded; ``i`` and ``tanh(g)`` are
    rounded, ``f``, ``o`` and ``i * g`` are not; the cell state and ``h``
    stay f32 (``h`` is rounded when it enters the next product). Both
    directions run in one batched step. ``x`` [B, T, C] -> [B, T, 2H] f32."""
    B, T, _ = x.shape
    H = lstm.hidden_size
    w_ih = torch.stack([lstm.weight_ih_l0, lstm.weight_ih_l0_reverse])  # [2, 4H, C]
    w_hh = torch.stack([lstm.weight_hh_l0, lstm.weight_hh_l0_reverse])  # [2, 4H, H]
    b_hh = torch.stack([lstm.bias_hh_l0, lstm.bias_hh_l0_reverse])      # [2, 4H]
    xb = rb(x)
    # input products for every step at once: [2, T, B, 4H]
    gi = rb(torch.einsum("btc,dgc->dtbg", xb, w_ih))
    gi = torch.stack([gi[0], gi[1].flip(0)])  # the reverse cell walks t = T-1 .. 0
    h = x.new_zeros(2, B, H)
    c = x.new_zeros(2, B, H)
    out = x.new_empty(2, T, B, H)
    for t in range(T):
        gh = rb(rb(torch.bmm(rb(h), w_hh.transpose(1, 2))) + b_hh[:, None, :])
        pre = rb(gh + gi[:, t])
        sig = _sigmoid_gate(pre)  # all four gates at once; g's is unused
        i, f, _, o = sig.split(H, dim=-1)
        g = rb(torch.tanh(pre[..., 2 * H : 3 * H]))
        c = f * c + rb(i) * g
        h = o * torch.tanh(c)
        out[:, t] = h
    fwd = out[0].transpose(0, 1)
    bwd = out[1].flip(0).transpose(0, 1)
    return torch.cat([fwd, bwd], dim=-1)
