"""A Python mirror of the backward kernel's launch plan (``plan_bwd`` and
``bwd_dims`` in src/repro_torch/kernels/csrc/fused_mlp.cu), for the tests
that run without the library: the CPU emulation of the kernel's
arithmetic lays its rows out by it, the plan tests check its rules, and a
card test holds it equal to ``rt_fused_mlp_bwd_plan``.  The port itself
asks the library (``repro_torch.kernels.fused_mlp.bwd_plan``)."""

from __future__ import annotations

#: csrc/fused_mlp.cu's launch constants: one cluster of BWD_CLUSTER blocks,
#: tiles of at most BWD_TILE_MAX rows, at most BWD_SMEM_MAX bytes of shared
#: memory a block, of which BWD_BAR_BYTES hold the mbarrier the sums arrive on.
BWD_CLUSTER, BWD_TILE_MAX, BWD_SMEM_MAX, BWD_BAR_BYTES = 16, 128, 227 * 1024, 16
#: dtype code -> (M, K of the tensor-core product, accumulator bytes):
#: split-TF32 m16n8k8 for float32 and bfloat16, DMMA m8n8k4 for float64.
MMA = {0: (16, 8, 4), 1: (16, 8, 4), 2: (8, 4, 8)}


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _stride8(c: int) -> int:
    return c if c % 16 == 8 else c + 8


def _stride4(c: int) -> int:
    return c if c % 8 == 4 else c + 4


def bwd_plan(code: int, rows: int, din: int, hidden: int, dout: int):
    """``{"blocks", "tile", "tiles_per_block", "smem", "smem_bytes",
    "partial_bytes"}`` for (dtype code, R, widths), or None where one tile
    of M rows does not fit in a block's shared memory.  A tile is
    ceil(R / BWD_CLUSTER) rows rounded up to the product's M, at most
    BWD_TILE_MAX, shrunk until the tile's operands ([x | 1], g, [a | 1],
    dpre), the staged weights, the block's sums and the sums it receives
    fit; where even M rows do not fit with them, the sums go to global
    partials (``partial_bytes``) and only the tile must fit."""
    m, k, es = MMA[code]
    row = (_stride8(_up(din + 1, 8)) + _stride8(_up(dout, m)) + _stride8(_up(hidden + 1, 8))
           + _stride8(_up(hidden, m))) * es
    pe = din * hidden + hidden + hidden * dout + dout
    fixed = BWD_BAR_BYTES + (_up(din + 1, 8) * _stride8(_up(hidden, 8)) + _up(hidden, 8)
                             * _stride4(_up(dout, k)) + _up(hidden, 8) + pe
                             + BWD_CLUSTER * -(-pe // BWD_CLUSTER)) * es
    want = -(-rows // BWD_CLUSTER)
    tile = _up(want, m) if want < BWD_TILE_MAX else BWD_TILE_MAX
    smem = m * row + fixed <= BWD_SMEM_MAX
    extra = fixed if smem else 0
    while tile > m and tile * row + extra > BWD_SMEM_MAX:
        tile -= m
    if tile * row + extra > BWD_SMEM_MAX:
        return None
    tiles = -(-rows // tile)
    if tiles > 0x7FFFFFFF:
        return None
    return {"blocks": BWD_CLUSTER, "tile": tile, "tiles_per_block": -(-tiles // BWD_CLUSTER),
            "smem": smem, "smem_bytes": tile * row + extra,
            "partial_bytes": 0 if smem else BWD_CLUSTER * pe * es}
