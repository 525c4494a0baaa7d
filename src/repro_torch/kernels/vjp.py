"""Gradients through the hand kernels: forward by the kernel, backward by
the plain version.

The JAX package has no backward kernel for ``flash_attention`` or
``ssd_chunk`` (XLA differentiates their plain definitions off the TPU), and
the launchers write through ctypes into fresh tensors that carry no
``grad_fn``.  :class:`PlainVJP` gives each launch one autograd node (the
field MLP has a backward kernel and a node of its own,
:class:`repro_torch.kernels.fused_mlp.MLPFunction`, which takes
:func:`plain_vjp` for second derivatives only):

* **forward** runs ``launch(*inputs, **kwargs)`` (the kernel) whatever the
  grad mode, so a field re-evaluated under ``enable_grad`` in the exact
  adjoint's backward gives the forward's bits;
* **saved** are the inputs themselves (views included: a head-broadcast,
  stride-0 ``b`` is saved as the view, never copied);
* **backward** is the VJP of ``plain`` (the function
  :mod:`repro_torch.kernels.ref` defines) at the saved inputs: ``plain`` is
  recomputed under ``enable_grad`` and differentiated with the incoming
  cotangents.  Gradients come back in the inputs' shapes, so autograd's
  ``expand`` backward sums a broadcast operand's.  For a loss linear in the
  outputs they are bitwise the plain path's gradients.

A second derivative is the plain version's, never silently zero: with grad
mode on in the backward (``create_graph=True`` upstream) the recomputation
runs on aliases of the saved inputs still attached to their graph and keeps
its own graph.  The aliases (``view_as``) make the VJP this node's partial
derivatives: differentiated by the saved tensors themselves, a weight
that also reaches an input through earlier nodes (an SDE field's weights
reach its state through every earlier step) would take its total
derivative, walking the whole history again from every node — wrong, and
exponential in the depth.  ``launch`` is an argument so that a CPU test can build the node with
the plain forward in the kernel's place.
"""

from __future__ import annotations

import torch


def plain_vjp(plain, inputs, cotangents, needs, kwargs):
    """``d plain(*inputs, **kwargs) · cotangents`` for each input in
    ``needs`` (None elsewhere); a None cotangent is an unused output."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        ins = [x.view_as(x) if create and x.requires_grad
               else x.detach().requires_grad_(need) for x, need in zip(inputs, needs)]
        outs = plain(*ins, **kwargs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, cotangents) if g is not None]
        wrt = [x for x, need in zip(ins, needs) if need]
        if not pairs or not wrt:
            return [None] * len(inputs)
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                         create_graph=create, allow_unused=True))
    return [next(grads) if need else None for need in needs]


class PlainVJP(torch.autograd.Function):
    """``PlainVJP.apply(launch, plain, kwargs, *inputs)`` -> ``launch``'s
    outputs, differentiated as ``plain`` (see the module docstring)."""

    @staticmethod
    def forward(ctx, launch, plain, kwargs, *inputs):
        ctx.set_materialize_grads(False)
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*inputs)
        return launch(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *cotangents):
        grads = plain_vjp(ctx.plain, ctx.saved_tensors, cotangents,
                          ctx.needs_input_grad[3:], ctx.kwargs)
        return (None, None, None, *grads)
