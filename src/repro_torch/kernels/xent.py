"""Launchers of the LM-loss cross-entropy CUDA kernels (port of
:mod:`repro.kernels.xent`).

:func:`fused_xent` replaces the Pallas kernel at src/repro/kernels/xent.py:56:
logits ``(..., V)`` in float32 or bfloat16 and int labels ``(...)`` ->
per-token losses ``(...)`` float32, ``lse − logit[label]``.  The forward
kernel also writes the row's log-sum-exp, which the backward kernel reads:
``dlogits = g·(exp(x − lse) − onehot(label))`` in the logits' dtype, one
read of the logits and one write, with no float32 ``(R, V)`` temporary.
The kernels are in ``csrc/fused_xent.cu``; their plain versions are
:func:`repro_torch.kernels.ref.fused_xent_fwd` and
:func:`~repro_torch.kernels.ref.fused_xent_bwd`.  The kernel sums each row
in one fixed order of its own, so it agrees with the plain versions to a
tolerance (loss f32 1e-5, bf16 3e-2; dlogits f32 1e-5, bf16 one ulp of the
output), and a row's bits never depend on how many rows share the launch.

Gradients: the two launches are one :class:`XentFunction` node, which
saves the logits, the labels and the log-sum-exp.  The JAX package has no
backward kernel (XLA differentiates ``softmax_xent``); the generic
:class:`~repro_torch.kernels.vjp.PlainVJP` would recompute the plain
version and materialise the float32 ``(R, V)`` temporary this kernel exists
to avoid.  The loss is the root of the graph, so no second derivative is
defined: a backward under ``create_graph=True`` raises
:class:`XentDoubleBackwardError`.
"""

from __future__ import annotations

import torch

from . import build

#: Kernel launches made by this module's wrappers (one per launch).
LAUNCHES = {"fused_xent": 0, "fused_xent_bwd": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class XentDoubleBackwardError(RuntimeError):
    """A second derivative through the cross-entropy kernels was asked for."""


def check_operands(logits: torch.Tensor, labels: torch.Tensor) -> None:
    """Raise unless logits and labels are what the kernels take (the device
    last, so shapes and types are checked on any device)."""
    if logits.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_xent: logits must be float32 or bfloat16, got {logits.dtype}")
    if logits.dim() < 1 or logits.shape[-1] == 0:
        raise ValueError(f"fused_xent: logits must be (..., V) with V >= 1, got "
                         f"{tuple(logits.shape)}")
    if labels.shape != logits.shape[:-1]:
        raise ValueError(f"fused_xent: labels {tuple(labels.shape)} must be the logits' "
                         f"leading shape {tuple(logits.shape[:-1])}")
    if labels.dtype.is_floating_point or labels.dtype.is_complex or labels.dtype == torch.bool:
        raise TypeError(f"fused_xent: labels must be integers, got {labels.dtype}")
    if not logits.is_contiguous():
        raise ValueError(f"fused_xent: logits must be contiguous (strides {logits.stride()})")
    if labels.device != logits.device:
        raise ValueError(f"fused_xent: labels on {labels.device}, logits on {logits.device}")
    if not logits.is_cuda:
        raise ValueError(f"fused_xent: operands must be CUDA tensors, got {logits.device}")


def _rows(logits, labels):
    """``(R, V)`` logits and ``(R,)`` int32 labels, views where they can be."""
    V = logits.shape[-1]
    return logits.reshape(-1, V), labels.reshape(-1).to(torch.int32).contiguous()


def launch_fwd(logits, labels):
    """One forward launch -> ``(loss, lse)``, both ``(...)`` float32."""
    x, lab = _rows(logits, labels)
    R, V = x.shape
    loss = torch.empty(R, dtype=torch.float32, device=x.device)
    lse = torch.empty(R, dtype=torch.float32, device=x.device)
    if R:
        lib = build.load()
        with build.device_guard(x.device):
            err = lib.rt_fused_xent_fwd(DTYPE_CODES[x.dtype], x.data_ptr(), lab.data_ptr(),
                                        loss.data_ptr(), lse.data_ptr(), R, V,
                                        torch.cuda.current_stream(x.device).cuda_stream)
        build.check("fused_xent", err)
        LAUNCHES["fused_xent"] += 1
    return loss.reshape(labels.shape), lse.reshape(labels.shape)


def launch_bwd(logits, labels, lse, g):
    """One backward launch -> ``dlogits`` in the logits' dtype and shape."""
    x, lab = _rows(logits, labels)
    R, V = x.shape
    dx = torch.empty_like(x)
    if R:
        lse_r = lse.reshape(-1).float().contiguous()
        g_r = g.reshape(-1).float().contiguous()
        lib = build.load()
        with build.device_guard(x.device):
            err = lib.rt_fused_xent_bwd(DTYPE_CODES[x.dtype], x.data_ptr(), lab.data_ptr(),
                                        lse_r.data_ptr(), g_r.data_ptr(), dx.data_ptr(), R, V,
                                        torch.cuda.current_stream(x.device).cuda_stream)
        build.check("fused_xent_bwd", err)
        LAUNCHES["fused_xent_bwd"] += 1
    return dx.reshape(logits.shape)


class XentFunction(torch.autograd.Function):
    """``XentFunction.apply(fwd, bwd, logits, labels)`` -> per-token losses.

    ``fwd(logits, labels) -> (loss, lse)`` and ``bwd(logits, labels, lse, g)
    -> dlogits`` are the two launches on the card; a CPU test builds the
    node with the plain versions in their place."""

    @staticmethod
    def forward(ctx, fwd, bwd, logits, labels):
        loss, lse = fwd(logits, labels)
        ctx.bwd = bwd
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise XentDoubleBackwardError(
                "fused_xent: no second derivative is defined (the loss is the root of "
                "the graph); differentiate ref.fused_xent for one")
        logits, labels, lse = ctx.saved_tensors
        if not ctx.needs_input_grad[2]:
            return None, None, None, None
        return None, None, ctx.bwd(logits, labels, lse, g), None


def fused_xent(logits, labels):
    """Per-token cross entropy in one launch, differentiable through the
    backward kernel."""
    check_operands(logits, labels)
    return XentFunction.apply(launch_fwd, launch_bwd, logits, labels)

