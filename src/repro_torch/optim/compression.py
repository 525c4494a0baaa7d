"""Error-feedback int8 gradient compression for a cross-pod all-reduce (port
of :mod:`repro.optim.compression`).

Per tensor, int8 with a float32 scale (about 4× less traffic), and the
quantisation residual kept in an error-feedback buffer that is added back
at the next step (Seide et al.-style EF-SGD).  :func:`ef_compress_update`
is pure; :func:`allreduce_compressed` means the dequantised payload over a
process group (the reference's ``pmean`` inside ``shard_map``).  Nothing in
the reference's training path calls it; both packages export it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from .. import tree


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``scale = max|x| / 127 + 1e-12`` in ``x``'s dtype (then
    float32), ``q = clip(round(x / scale), −127, 127)`` as int8."""
    one27 = torch.full((), 127.0, dtype=x.dtype, device=x.device)
    scale = torch.max(torch.abs(x)) / one27 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def ef_compress_update(grads, error_buf):
    """``(quantised tree, scales tree, new error buffer)`` with ``new_error =
    (g + e) − dequant(quant(g + e))``."""
    corrected = tree.map(torch.add, grads, error_buf)
    leaves, spec = tree.flatten(corrected)
    qs = [compress_int8(c) for c in leaves]
    q_tree = tree.unflatten(spec, [q for q, _ in qs])
    s_tree = tree.unflatten(spec, [s for _, s in qs])
    deq = [decompress_int8(q, s, c.dtype) for (q, s), c in zip(qs, leaves)]
    new_err = tree.unflatten(spec, [c - d for c, d in zip(leaves, deq)])
    return q_tree, s_tree, new_err


def allreduce_compressed(grads, error_buf, group=None):
    """Compressed mean all-reduce over ``group`` (the whole process group by
    default): each rank dequantises its own payload, and the mean of those
    is the result, with the new error buffer.  Reduce within a pod at full
    precision first."""
    q, s, new_err = ef_compress_update(grads, error_buf)
    g_leaves, spec = tree.flatten(grads)
    deq = [decompress_int8(qq, ss, g.dtype)
           for qq, ss, g in zip(tree.flatten(q)[0], tree.flatten(s)[0], g_leaves)]
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    out = []
    for d in deq:
        if n > 1:
            dist.all_reduce(d, op=dist.ReduceOp.SUM, group=group)
            d = d / torch.full((), n, dtype=d.dtype, device=d.device)
        out.append(d)
    return tree.unflatten(spec, out), new_err
