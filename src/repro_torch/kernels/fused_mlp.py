"""Launchers of the SDE field MLP CUDA kernels (port of
:mod:`repro.kernels.fused_mlp`).

:func:`fused_mlp` replaces the Pallas kernel at
src/repro/kernels/fused_mlp.py:43: Linear → LipSwish → Linear in one
launch, x ``(..., Din)``, w1 ``(Din, H)``, b1 ``(H,)``, w2 ``(H, Dout)``,
b2 ``(Dout,)`` in float32, float64 or bfloat16 -> ``(..., Dout)`` in x's
dtype.  Its backward is one launch of a second kernel, which writes dx,
dW1, db1, dW2 and db2 together.  Both are in ``csrc/fused_mlp.cu``; their
plain versions are :func:`repro_torch.kernels.ref.fused_mlp` and
:func:`~repro_torch.kernels.ref.fused_mlp_bwd`.  The kernels sum in fixed
orders of their own (a row's bits do not depend on how many rows share the
launch; dW and db depend on the row count alone), the plain versions in
the BLAS's, so the two agree to a tolerance (f32 2e-5, bf16 6e-2, f64
1e-12), not bitwise.

Gradients: a launch that can carry a gradient (grad mode on and an input
that requires one) is one :class:`MLPFunction` node, which saves the five
inputs and nothing else; any other launch makes no node.  The forward
launches the kernel whatever the grad mode (the exact adjoint re-evaluates
the fields under ``enable_grad`` and needs the forward's bits).  The
backward dispatches on the grad mode: outside ``create_graph`` it is one
launch of the backward kernel; with grad mode on it is the plain version's
VJP (:func:`repro_torch.kernels.vjp.plain_vjp`), so a second derivative
(the SDE-GAN's gradient penalty) is the plain version's, never zero.  On a
CUDA tensor neither path catches a failed build or launch.  The JAX
package has no backward kernel: XLA differentiates the plain definition.

The launchers keep their host cost low (the SDE paths are bound by it):
the stream is read as its raw handle and a launch that carries no gradient
makes no autograd node.  The backward runs as one thread-block cluster
whose blocks reduce their sums over rows through each other's shared
memory, so it needs no scratch; only widths whose sums do not fit in
shared memory (none of the SDE fields) get a buffer of global partials,
allocated with ``torch.empty`` at each launch and sized by the library's
plan (:func:`bwd_plan`).
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .vjp import plain_vjp

#: Kernel launches made by this module's wrappers (one per launch).
LAUNCHES = {"fused_mlp": 0, "fused_mlp_bwd": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
#: Shared memory a block may use for one row of x and of the hidden
#: activation (``kSmemBytes`` in csrc/fused_mlp.cu): Din + H is bounded by it.
ROW_BYTES = 48 * 1024


def check_operands(x, w1, b1, w2, b2) -> None:
    """Raise unless the operands are what the kernel takes (the device last,
    so shapes and layouts are checked on any device)."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_mlp: float32, float64 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"fused_mlp: want x (..., Din), w1 (Din, H), w2 (H, Dout), got "
                         f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    din, hidden = w1.shape
    dout = w2.shape[1]
    if (x.shape[-1] != din or w2.shape[0] != hidden or b1.shape != (hidden,)
            or b2.shape != (dout,) or 0 in (din, hidden, dout)):
        raise ValueError(f"fused_mlp: want x (..., Din), w1 (Din, H), b1 (H,), w2 (H, Dout), "
                         f"b2 (Dout,), got x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    acc = 8 if x.dtype == torch.float64 else 4
    if (din + hidden) * acc > ROW_BYTES:
        raise ValueError(f"fused_mlp: Din + H = {din + hidden} exceeds the "
                         f"{ROW_BYTES // acc} a row may take in shared memory")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"fused_mlp: {name} is {t.dtype} on {t.device}, x is "
                             f"{x.dtype} on {x.device}")
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if not t.is_contiguous():
            raise ValueError(f"fused_mlp: {name} must be contiguous (strides {t.stride()})")
    if not x.is_cuda:
        raise ValueError(f"fused_mlp: operands must be CUDA tensors, got {x.device}")


def _stream(index: int) -> int:
    """The raw handle of the current stream of device ``index``."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(x, w1, b1, w2, b2):
    """One forward launch -> ``(..., Dout)`` (operands already checked)."""
    din, hidden = w1.shape
    dout = w2.shape[1]
    out = x.new_empty(x.shape[:-1] + (dout,))
    rows = x.numel() // din
    if rows == 0:
        return out
    lib = build.load()
    index = x.get_device()
    with build.device_guard(index):
        err = lib.rt_fused_mlp(
            DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), rows, din, hidden, dout, _stream(index))
    build.check("fused_mlp", err)
    LAUNCHES["fused_mlp"] += 1
    return out


_PARTIALS: dict = {}  # (dtype code, Din, H, Dout) -> bytes of global partials


def bwd_plan(code: int, rows: int, din: int, hidden: int, dout: int):
    """The backward's launch plan as the library works it out
    (``rt_fused_mlp_bwd_plan``, ``plan_bwd`` in csrc/fused_mlp.cu), a
    function of (dtype code, R, widths) alone: ``{"blocks", "tile",
    "tiles_per_block", "smem", "smem_bytes", "partial_bytes"}``, or None
    where one tile of rows does not fit in a block's shared memory.
    ``partial_bytes`` (the global partials of widths whose sums do not fit
    in shared memory) depends on the dtype and the widths alone."""
    out = (ctypes.c_int64 * 6)()
    if build.load().rt_fused_mlp_bwd_plan(code, rows, din, hidden, dout, out) != 0:
        return None
    return dict(zip(("blocks", "tile", "tiles_per_block", "smem", "smem_bytes",
                     "partial_bytes"), (int(v) for v in out)), smem=bool(out[3]))


def _launch_bwd(x, w1, b1, w2, b2, g):
    """One backward launch -> ``(dx, dW1, db1, dW2, db2)`` in the inputs'
    shapes and dtype, from the inputs and the cotangent ``g`` (``(...,
    Dout)``, any strides a ``(R, Dout)`` view takes)."""
    din, hidden = w1.shape
    dout = w2.shape[1]
    grads = (torch.empty_like(x), torch.empty_like(w1), torch.empty_like(b1),
             torch.empty_like(w2), torch.empty_like(b2))
    rows = x.numel() // din
    if rows == 0:
        for t in grads[1:]:
            t.zero_()
        return grads
    code = DTYPE_CODES[x.dtype]
    key = (code, din, hidden, dout)
    nbytes = _PARTIALS.get(key)
    if nbytes is None:
        plan = bwd_plan(code, rows, din, hidden, dout)
        if plan is None:
            raise ValueError(f"fused_mlp_bwd: a tile of rows at Din {din}, H {hidden}, Dout "
                             f"{dout} exceeds the shared memory of a block")
        nbytes = _PARTIALS[key] = plan["partial_bytes"]
    lib = build.load()
    g2 = g.reshape(rows, dout)
    index = x.get_device()
    partials = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
    dx, dw1, db1, dw2, db2 = grads
    with build.device_guard(index):
        err = lib.rt_fused_mlp_bwd(
            code, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), g2.data_ptr(),
            g2.stride(0), g2.stride(1), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), partials.data_ptr() if nbytes else None, nbytes,
            rows, din, hidden, dout, _stream(index))
    build.check("fused_mlp_bwd", err)
    LAUNCHES["fused_mlp_bwd"] += 1
    return grads


class MLPFunction(torch.autograd.Function):
    """``MLPFunction.apply(fwd, bwd, x, w1, b1, w2, b2)`` -> ``fwd``'s output.

    ``fwd(x, w1, b1, w2, b2)`` and ``bwd(x, w1, b1, w2, b2, g) -> (dx, dW1,
    db1, dW2, db2)`` are the two launches on the card; a CPU test builds the
    node with the plain versions in their place.  The backward runs ``bwd``
    with grad mode off and the plain version's VJP with it on (see the
    module docstring); an input that needs no gradient gets None."""

    @staticmethod
    def forward(ctx, fwd, bwd, x, w1, b1, w2, b2):
        ctx.bwd = bwd
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        if torch.is_grad_enabled():  # create_graph: a differentiable VJP
            grads = plain_vjp(ref.fused_mlp, inputs, (g,), needs, {})
        elif any(needs):
            grads = [d if need else None for d, need in zip(ctx.bwd(*inputs, g), needs)]
        else:
            grads = [None] * 5
        return (None, None, *grads)


def fused_mlp(x, w1, b1, w2, b2):
    """``lipswish(x @ w1 + b1) @ w2 + b2`` in one launch; differentiable
    through the backward kernel when an input requires a gradient."""
    check_operands(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and (x.requires_grad or w1.requires_grad or b1.requires_grad
                                    or w2.requires_grad or b2.requires_grad):
        return MLPFunction.apply(_launch, _launch_bwd, x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)
