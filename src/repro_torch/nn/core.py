"""Functional NN building blocks on tensors (port of :mod:`repro.nn.core`):
the MLP and GRU pieces of the SDE models, and the norms and activations of
the transformer zoo (``rmsnorm``, ``layernorm``, ``gelu``, ``softplus``).

Parameters are nested dicts of tensors with the reference pytree's layout
(``{"layers": [{"w": (in, out), "b": (out,)}]}``), so weights carried over
from JAX (:func:`repro_torch.checkpoint.params_from_jax`) compute the same
``x @ w + b``.  Fresh weights come from an explicit ``torch.Generator``.

Row invariance.  Both cuBLAS and the CPU BLAS pick their GEMM kernel by
shape, and the kernels sum the inner dimension in different orders, so a
row's bits can change with the number of rows multiplied.  The serving
contract needs each output row to be a function of that row alone,
whatever the bucket size, so :func:`linear` always multiplies blocks of
exactly :data:`ROW_BLOCK` rows (zero-padded).  On the card a depth-1
LipSwish MLP with biases (every SDE field at its default depth) is one
launch of the ``fused_mlp`` kernel instead, which sums each row in one
fixed order; the CPU, the GRU and the other ``linear`` calls keep the
blocks.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ..kernels import ops

#: Rows of every matmul :func:`linear` issues (see the module docstring).
ROW_BLOCK = 1024


def sigmoid(x):
    """``1 / (1 + exp(-x))``, written out: torch.sigmoid's CPU kernel rounds
    the vectorised body and the scalar tail of a tensor differently, so a
    row's bits would depend on its position (padding invariance)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    return x * sigmoid(x)


def softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)``: no linear branch above a threshold, unlike
    ``torch.nn.functional.softplus``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def lipswish(x):
    """LipSwish: 0.909·x·sigmoid(x), Lipschitz constant 1."""
    return 0.909 * silu(x)


def tcat(t, z):
    """Concatenate a broadcast time channel onto ``z``: (..., d) -> (..., 1+d).

    ``t`` is a Python or numpy scalar (filled on ``z``'s device without a
    host-to-device copy) or a tensor broadcastable to ``z.shape[:-1]``."""
    shape = z.shape[:-1] + (1,)
    if isinstance(t, torch.Tensor):
        tt = t.to(device=z.device, dtype=z.dtype).reshape(t.shape + (1,)).expand(shape)
    else:
        tt = torch.full(shape, float(t), dtype=z.dtype, device=z.device)
    return torch.cat([tt, z], -1)


def _row_invariant_matmul(x, w):
    x2 = x.reshape(-1, x.shape[-1])
    m = x2.shape[0]
    pad = (-m) % ROW_BLOCK
    if pad:
        x2 = torch.cat([x2, x2.new_zeros(pad, x2.shape[1])])
    y = torch.cat([blk @ w for blk in x2.split(ROW_BLOCK)])
    return y[:m].reshape(x.shape[:-1] + (w.shape[-1],))


def linear(params, x):
    y = _row_invariant_matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                bias: bool = True, scale: Optional[float] = None,
                dtype=torch.float32, device=None):
    """``w ~ U(-s, s)`` with ``s = 1/sqrt(in_dim)``, ``b = 0``."""
    s = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.rand((in_dim, out_dim), generator=generator, dtype=dtype) * (2 * s) - s
    p = {"w": w.to(device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def mlp_init(generator: torch.Generator, sizes: Sequence[int], bias: bool = True,
             dtype=torch.float32, device=None):
    return {"layers": [linear_init(generator, a, b, bias, dtype=dtype, device=device)
                       for a, b in zip(sizes[:-1], sizes[1:])]}


def _fusable(layers, x, activation) -> bool:
    """Whether :func:`mlp` runs as one ``fused_mlp`` launch: on the card, for
    Linear → LipSwish → Linear with both biases.  By device only, never by
    ``use_pallas_kernels``: the fused and unfused steppers must evaluate the
    same fields."""
    return (x.is_cuda and len(layers) == 2 and activation is lipswish
            and all("b" in p for p in layers))


def _mlp_dispatch(layers, x):
    """The depth-1 LipSwish MLP on the card
    (:func:`repro_torch.kernels.ops.fused_mlp`)."""
    (l1, l2) = layers
    return ops.fused_mlp(x.contiguous(), l1["w"], l1["b"], l2["w"], l2["b"])


def _mlp_layers(layers, x, activation):
    for p in layers[:-1]:
        x = activation(linear(p, x))
    return linear(layers[-1], x)


def mlp(params, x, activation: Callable = lipswish,
        final_activation: Optional[Callable] = None):
    layers = params["layers"]
    if _fusable(layers, x, activation):
        x = _mlp_dispatch(layers, x)
    else:
        x = _mlp_layers(layers, x, activation)
    if final_activation is not None:
        x = final_activation(x)
    return x


def gru_init(generator: torch.Generator, in_dim: int, hidden: int,
             dtype=torch.float32, device=None):
    """GRU cell parameters in the reference's layout (the Latent-SDE encoder)."""
    return {
        "wi": linear_init(generator, in_dim, 3 * hidden, dtype=dtype, device=device),
        "wh": linear_init(generator, hidden, 3 * hidden, bias=False, dtype=dtype,
                          device=device),
        "h0": torch.zeros((hidden,), dtype=dtype, device=device),
    }


def gru_cell(params, h, x):
    """One GRU update ``h -> h'`` on input ``x`` (gates r, z, n)."""
    gi = linear(params["wi"], x)
    gh = linear(params["wh"], h)
    i_r, i_z, i_n = gi.chunk(3, -1)
    h_r, h_z, h_n = gh.chunk(3, -1)
    r = sigmoid(i_r + h_r)
    z = sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def gru_scan(params, xs, reverse: bool = False):
    """Run a GRU over time axis 0 of ``xs`` (T, ..., in_dim) -> (T, ..., H);
    ``reverse`` runs from the last step back, keeping outputs in time order."""
    h = params["h0"].expand(xs.shape[1:-1] + params["h0"].shape)
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    hs = [None] * xs.shape[0]
    for i in steps:
        h = gru_cell(params, h, xs[i])
        hs[i] = h
    return torch.stack(hs)


def gelu(x):
    """GELU in its tanh form: ``jax.nn.gelu``'s default is ``approximate=True``."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def layernorm_init(dim: int, dtype=torch.float32, device=None):
    return {"g": torch.ones((dim,), dtype=dtype, device=device),
            "b": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """``(x − mean)·rsqrt(var + eps)·g + b`` with the biased variance, in
    ``x``'s dtype."""
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, unbiased=False, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * params["g"] + params["b"]


def rmsnorm_init(dim: int, dtype=torch.float32, device=None):
    return {"g": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """The variance in float32 (bf16 stability), the normalised ``x`` cast
    back to its dtype, then ``× g``."""
    xf = x.float()
    v = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps)).to(x.dtype) * params["g"]
