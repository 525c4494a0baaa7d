"""Carry weights across from the JAX package.

:func:`params_from_jax` is the one function that does it: a JAX parameter
pytree, as nested dicts/lists of numpy arrays (``jax.device_get`` of the
params, or :func:`repro_torch.checkpoint.load_serving_bundle`'s tree), becomes
the port's parameters.  The port keeps the reference's layout —
``{"layers": [{"w": (in, out), "b": (out,)}]}`` with ``y = x @ w + b`` — so
the conversion copies each leaf into a tensor and both packages compute the
same function.
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
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
