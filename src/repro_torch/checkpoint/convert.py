"""Carry weights across from the JAX package.

:func:`params_from_jax` is the one function that does it: a JAX parameter
pytree, as nested dicts/lists of numpy arrays (``jax.device_get`` of the
params), becomes the port's parameters.  The port keeps the reference's layout —
``{"layers": [{"w": (in, out), "b": (out,)}]}`` with ``y = x @ w + b`` — so
the conversion copies each leaf into a tensor and both packages compute the
same function.

bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16, which ``torch.from_numpy``
refuses) cross as their 16-bit words: viewed as int16, then as
``torch.bfloat16`` — the same bits.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device=None, dtype=None):
    """Nested dicts/lists/tuples of arrays -> the same nesting of tensors.

    ``dtype`` casts floating leaves (default: keep the stored dtype)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
