"""Bucket sizes of the serving path (port of ``serve_buckets`` from
:mod:`repro.serving.scheduler`; the continuous-batching scheduler itself is
ROADMAP.md Queue 1, 'The rest of serving')."""

from __future__ import annotations


def serve_buckets(max_batch: int, shard_base: int = 1) -> list:
    """Bucket sizes: ``shard_base`` × powers of two, up to ``max_batch``.

    The largest bucket caps how many rows one coalesced batch may hold."""
    sizes = []
    b = max(shard_base, 1)
    while b <= max_batch:
        sizes.append(b)
        b *= 2
    if not sizes:
        raise ValueError(
            f"--max-batch {max_batch} is below the shard base {shard_base}; "
            f"the smallest servable bucket is one row per device")
    return sizes
