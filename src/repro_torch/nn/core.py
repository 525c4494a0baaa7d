"""Functional NN building blocks on tensors (port of :mod:`repro.nn.core`).

Parameters are nested dicts of tensors with the reference pytree's layout
(``{"layers": [{"w": (in, out), "b": (out,)}]}``), so weights carried over
from JAX (:func:`repro_torch.checkpoint.params_from_jax`) compute the same
``x @ w + b``.  Fresh weights come from an explicit ``torch.Generator``.

Row invariance.  Both cuBLAS and the CPU BLAS pick their GEMM kernel by
shape, and the kernels sum the inner dimension in different orders, so a
row's bits can change with the number of rows multiplied.  The serving
contract needs each output row to be a function of that row alone,
whatever the bucket size, so :func:`linear` always multiplies blocks of
exactly :data:`ROW_BLOCK` rows (zero-padded).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

#: Rows of every matmul :func:`linear` issues (see the module docstring).
ROW_BLOCK = 1024


def sigmoid(x):
    """``1 / (1 + exp(-x))``, written out: torch.sigmoid's CPU kernel rounds
    the vectorised body and the scalar tail of a tensor differently, so a
    row's bits would depend on its position (padding invariance)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    return x * sigmoid(x)


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


def mlp(params, x, activation: Callable = lipswish,
        final_activation: Optional[Callable] = None):
    layers = params["layers"]
    for p in layers[:-1]:
        x = activation(linear(p, x))
    x = linear(layers[-1], x)
    if final_activation is not None:
        x = final_activation(x)
    return x


def gru_init(generator: torch.Generator, in_dim: int, hidden: int,
             dtype=torch.float32, device=None):
    """GRU cell parameters in the reference's layout (the Latent-SDE encoder;
    the cell itself is ported with the training slice)."""
    return {
        "wi": linear_init(generator, in_dim, 3 * hidden, dtype=dtype, device=device),
        "wh": linear_init(generator, hidden, 3 * hidden, bias=False, dtype=dtype,
                          device=device),
        "h0": torch.zeros((hidden,), dtype=dtype, device=device),
    }
