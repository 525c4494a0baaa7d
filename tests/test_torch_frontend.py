"""The asyncio front of the port's scheduler on the CPU: concurrent
submissions give bitwise the rows of a direct ``step`` loop over the same
requests, the JSON-lines TCP socket on localhost answers summaries (no
payloads) and error objects, the wire format's contract, the named errors,
and ``serve_sde(async_front=True)`` bitwise the direct drain.
"""

import asyncio
import json
import math

import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per xdist worker)
from repro_torch.core import sde
from repro_torch.serving import (AsyncFrontend, LoadedModel, ModelRegistry, Request,
                                 Scheduler, request_from_wire, result_summary, serve_sde)

GAN = dict(data_dim=1, hidden_dim=8, noise_dim=4, width=16, num_steps=8)


def _registry():
    reg = ModelRegistry()
    cfg = sde.NeuralSDEConfig(**GAN)
    reg.register(LoadedModel("default", "sde-gan", cfg,
                             sde.generator_init(torch.Generator().manual_seed(90), cfg)))
    return reg


def test_async_front_bitwise_equals_a_direct_step_loop():
    reg = _registry()
    reqs = [Request(rid=i, size=1 + i % 3, seed=100 + i) for i in range(5)]

    async def drive():
        front = AsyncFrontend(Scheduler(reg, max_batch=8, chunks=4, collect=True))
        await front.start()
        try:
            return await asyncio.gather(*(front.submit(r, arrival_s=0.0) for r in reqs)), \
                front.steps
        finally:
            await front.close()

    results, steps = asyncio.run(drive())
    direct = Scheduler(reg, max_batch=8, chunks=4, collect=True)
    for r in reqs:
        direct.submit(r, arrival_s=0.0)
    want = {r.rid: r.samples for r in direct.run()}
    assert sorted(r.rid for r in results) == sorted(want) and steps >= 4
    for res in results:
        assert torch.equal(res.samples, want[res.rid])


def test_async_front_named_errors():
    reg = _registry()

    async def unstarted():
        await AsyncFrontend(Scheduler(reg)).submit(Request(rid=0, size=1, seed=0))

    with pytest.raises(RuntimeError, match="start"):
        asyncio.run(unstarted())

    async def duplicate_and_oversized():
        front = AsyncFrontend(Scheduler(reg, max_batch=2, chunks=4))
        await front.start()
        try:
            task = asyncio.ensure_future(front.submit(Request(rid=7, size=1, seed=0)))
            await asyncio.sleep(0)
            with pytest.raises(ValueError, match="rid 7"):
                await front.submit(Request(rid=7, size=1, seed=1))
            await task
            with pytest.raises(ValueError, match="exceeds the largest"):
                await front.submit(Request(rid=8, size=64, seed=0))
        finally:
            await front.close()

    asyncio.run(duplicate_and_oversized())


def test_tcp_roundtrip_on_localhost():
    reg = _registry()

    async def drive():
        front = AsyncFrontend(Scheduler(reg, max_batch=4, chunks=4, atol=1e-2, max_steps=64))
        host, port = await front.serve_tcp()
        reader, writer = await asyncio.open_connection(host, port)
        lines = [{"rid": 0, "size": 2, "seed": 11, "deadline_ms": None},
                 {"rid": 1, "size": 1, "seed": 12, "kind": "terminal", "deadline_ms": 250.0},
                 {"rid": 2, "size": 1, "seed": 13, "bogus_field": 1}]
        for obj in lines:
            writer.write(json.dumps(obj).encode() + b"\n")
        await writer.drain()
        replies = [json.loads(await reader.readline()) for _ in lines]
        writer.close()
        await writer.wait_closed()
        await front.close()
        return host, replies

    host, replies = asyncio.run(drive())
    assert host == "127.0.0.1"
    by_rid = {r["rid"]: r for r in replies}
    assert by_rid[0]["size"] == 2 and by_rid[0]["deadline_met"] is True
    assert by_rid[0]["num_converged"] == 2 and by_rid[0]["model_id"] == "default"
    assert "samples" not in by_rid[0] and by_rid[0]["deadline_ms"] is None
    assert by_rid[1]["rtol"] == 3e-3  # the interactive class's tolerance
    assert "bogus_field" in by_rid[2]["error"]


def test_request_from_wire_contract():
    req = request_from_wire({"rid": 3, "size": 2, "seed": 5, "deadline_ms": None,
                             "model_id": "m"})
    assert req.deadline_ms == math.inf and req.model_id == "m"
    with pytest.raises(ValueError, match="unknown request fields"):
        request_from_wire({"rid": 0, "size": 1, "seed": 0, "sizee": 1})
    with pytest.raises(ValueError, match="JSON object"):
        request_from_wire([1, 2, 3])
    from repro_torch.serving import ServeResult

    s = result_summary(ServeResult(rid=1, model_id="m", size=2, converged=[True, False],
                                   latency_s=0.5, deadline_ms=100.0, rtol=1e-3))
    assert s == {"rid": 1, "model_id": "m", "size": 2, "num_converged": 1, "latency_s": 0.5,
                 "deadline_ms": 100.0, "deadline_met": False, "rtol": 1e-3}


def test_serve_sde_async_front_equals_the_direct_drain():
    kw = dict(max_batch=4, requests=5, request_max=3, seed=2, device="cpu", sde_steps=8,
              collect=True, scheduler="continuous")
    direct = serve_sde("sde-gan", **kw)
    front = serve_sde("sde-gan", async_front=True, preempt=True, pool_budget_mb=64, **kw)
    assert front["frontend"] == "asyncio" and direct["frontend"] == "direct"
    assert front["pool_budget_bytes"] == 64 * 2 ** 20 and front["requests"] == 5
    assert sorted(front["samples"]) == sorted(direct["samples"])
    for rid, ys in direct["samples"].items():
        assert ys.shape[0] == 9 and torch.equal(ys, front["samples"][rid])
    with pytest.raises(ValueError, match="require the continuous-batching path"):
        serve_sde("sde-gan", async_front=True, device="cpu")
    with pytest.raises(ValueError, match="must be positive"):
        serve_sde("sde-gan", scheduler="fifo", pool_budget_mb=0, device="cpu")
    with pytest.raises(ValueError, match="--scheduler drives"):
        serve_sde("latent-sde", scheduler="fifo", device="cpu")
