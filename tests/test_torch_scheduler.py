"""The continuous-batching scheduler on the CPU: its rollouts against the
JAX package's ``Scheduler`` over the same requests (rows of two or more, so
no solo batch runs the reference's bucket-1 program, whose rounding
differs from its larger buckets: ROADMAP Queue 3), then inside the port,
bitwise: mid-flight admission ≡ solo, preempted ≡ unpreempted, fifo ≡
continuous, evict-then-rebuild ≡ uncached; quotas wait in arrival order;
terminal batches routed by deadline class; the named errors.

Tolerance against the reference: trajectories rtol=2e-5, atol=2e-6
(float32; XLA's FMAs, tests/test_torch_serving.py).
"""

import math

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_config
from repro.core import sde as jax_sde
from repro.serving import (LoadedModel as JaxLoadedModel, ModelRegistry as JaxRegistry,
                           Request as JaxRequest, Scheduler as JaxScheduler)
from repro_torch import checkpoint as ckpt
from repro_torch.core import sde
from repro_torch.serving import (DEADLINE_CLASSES, LoadedModel,
                                 ModelRegistry, Request, Scheduler, class_latency_summary,
                                 latency_summary, route_rtol, run_open_loop)
from repro_torch.serving import registry as registry_mod

GAN = dict(data_dim=1, hidden_dim=8, noise_dim=4, width=16, num_steps=8)
TERMINAL = dict(atol=1e-2, max_steps=64)  # a few dozen controller steps on the CPU


def _registry(ids=("default",), budget=None, seed=30):
    reg = ModelRegistry(pool_budget_bytes=budget)
    cfg = sde.NeuralSDEConfig(**GAN)
    for i, mid in enumerate(ids):
        params = sde.generator_init(torch.Generator().manual_seed(seed + i), cfg)
        reg.register(LoadedModel(mid, "sde-gan", cfg, params))
    return reg


def _solo(reg, req, **kw):
    sched = Scheduler(reg, max_batch=8, chunks=4, collect=True, **kw)
    sched.submit(req)
    (res,) = sched.run()
    return res.samples


def test_scheduler_rollouts_match_the_reference_scheduler():
    sizes = [2, 3, 2, 4, 3]
    with jax_config():
        jcfg = jax_sde.NeuralSDEConfig(**GAN)
        jparams = jax_sde.generator_init(jax.random.PRNGKey(31), jcfg)
        jreg = JaxRegistry()
        jreg.register(JaxLoadedModel("default", "sde-gan", jcfg, jparams))
        jsched = JaxScheduler(jreg, max_batch=8, chunks=4, collect=True)
        for i, n in enumerate(sizes):
            jsched.submit(JaxRequest(rid=i, size=n, seed=500 + i))
        want = {r.rid: np.asarray(r.samples) for r in jsched.run()}
        params = ckpt.params_from_jax(jax.device_get(jparams))
    reg = ModelRegistry()
    reg.register(LoadedModel("default", "sde-gan", sde.NeuralSDEConfig(**GAN), params))
    sched = Scheduler(reg, max_batch=8, chunks=4, collect=True)
    for i, n in enumerate(sizes):
        sched.submit(Request(rid=i, size=n, seed=500 + i))
    got = {r.rid: r for r in sched.run()}
    assert sorted(got) == sorted(want)
    for rid, res in got.items():
        assert res.samples.shape == (GAN["num_steps"] + 1, sizes[rid], 1)
        assert res.num_converged == sizes[rid] and res.model_id == "default"
        torch.testing.assert_close(res.samples, torch.from_numpy(want[rid]),
                                   rtol=2e-5, atol=2e-6)


def test_mid_flight_admission_bitwise_equals_solo():
    reg = _registry()
    first, late = Request(rid=0, size=3, seed=7), Request(rid=1, size=2, seed=123)
    sched = Scheduler(reg, max_batch=8, chunks=4, collect=True)
    sched.submit(first)
    assert sched.step() == [] and sched.busy  # `first` is one chunk deep
    sched.submit(late)  # joins at the next chunk boundary
    by_rid = {r.rid: r for r in sched.run()}
    assert by_rid[1].samples.shape == (GAN["num_steps"] + 1, 2, 1)
    assert torch.equal(by_rid[0].samples, _solo(reg, first))
    assert torch.equal(by_rid[1].samples, _solo(reg, late))


def test_preemption_pauses_and_resumes_bitwise():
    reg = _registry(("bulk", "rt"))
    sched = Scheduler(reg, max_batch=8, chunks=4, collect=True, preempt=True, **TERMINAL)
    bulk = Request(rid=0, size=3, seed=21, model_id="bulk")  # relaxed class
    sched.submit(bulk)
    assert sched.step() == []
    sched.submit(Request(rid=1, size=1, seed=22, model_id="rt", kind="terminal",
                         deadline_ms=40.0))
    results = sched.step()
    assert [r.rid for r in results] == [1] and results[0].rtol == 1e-2
    assert sched.counters["preempted_rows"] == 3
    lane = sched._lanes["bulk"]
    assert len(lane.paused) == 3 and not lane.active
    results += sched.run()
    assert sched.counters["resumed_rows"] == 3
    by_rid = {r.rid: r for r in results}
    assert torch.equal(by_rid[0].samples,
                       _solo(reg, Request(rid=9, size=3, seed=21, model_id="bulk")))


def test_preemption_defers_relaxed_terminal_batches_only_when_asked():
    reg = _registry(("bulk", "rt"))
    for preempt in (True, False):
        sched = Scheduler(reg, max_batch=4, chunks=4, preempt=preempt, **TERMINAL)
        sched.submit(Request(rid=0, size=1, seed=1, model_id="bulk", kind="terminal"))
        sched.submit(Request(rid=1, size=1, seed=2, model_id="rt", kind="terminal",
                             deadline_ms=40.0))
        first = [r.rid for r in sched.step()]
        assert first == ([1] if preempt else [0, 1])
        rest = sched.run()
        assert sorted(first + [r.rid for r in rest]) == [0, 1]


def test_fifo_rows_bitwise_equal_continuous_rows():
    """Same rows either way; only the iteration a request completes in moves
    (fifo admits the late requests once the first has drained)."""
    reg = _registry()
    reqs = [Request(rid=0, size=2, seed=40), Request(rid=1, size=1, seed=41),
            Request(rid=2, size=1, seed=42), Request(rid=3, size=2, seed=43)]
    out = {}
    for mode in ("continuous", "fifo"):
        sched = Scheduler(reg, max_batch=4, chunks=4, collect=True, mode=mode)
        sched.submit(reqs[0])
        sched.step()
        for r in reqs[1:]:
            sched.submit(r)
        samples, done, k = {}, {}, 1
        while sched.busy:
            k += 1
            for r in sched.step():
                samples[r.rid], done[r.rid] = r.samples, k
        out[mode] = samples, done
    assert sorted(out["fifo"][0]) == [r.rid for r in reqs]
    for rid, ys in out["continuous"][0].items():
        assert torch.equal(ys, out["fifo"][0][rid])
    assert out["continuous"][1][1] == 5 and out["fifo"][1][1] == 8


def test_evict_then_rebuild_bitwise_equals_uncached(monkeypatch):
    """Every entry is charged 100 B against a 150 B budget, so each build
    evicts the entry before it and buckets rebuild as rows come and go."""
    reqs = [Request(rid=i, size=1 + (5 * i) % 4, seed=60 + i) for i in range(6)]

    def serve(reg):
        sched = Scheduler(reg, max_batch=4, chunks=4, collect=True)
        for r in reqs[:3]:
            sched.submit(r)
        sched.step()
        for r in reqs[3:]:
            sched.submit(r)
        return {r.rid: r.samples for r in sched.run()}

    uncached = serve(_registry())
    monkeypatch.setattr(registry_mod, "_program_bytes", lambda program: 100)
    tight = _registry(budget=150)
    evicted = serve(tight)
    assert tight.evictions > 0 and tight.compiles > len(tight.pool_keys())
    assert tight.pool_bytes() <= 200
    for rid, ys in uncached.items():
        assert torch.equal(ys, evicted[rid])


def test_quota_waits_in_arrival_order():
    reg = _registry()
    sched = Scheduler(reg, max_batch=8, chunks=4, quota=2)
    reqs = [Request(rid=0, size=2, seed=1), Request(rid=1, size=1, seed=2),
            Request(rid=2, size=1, seed=3), Request(rid=3, size=2, seed=4)]
    for r in reqs:
        sched.submit(r)
    lane, done, peak = sched._lanes["default"], [], 0
    while sched.busy:
        done += [r.rid for r in sched.step()]
        peak = max(peak, len(lane.active) + len(lane.paused))
    assert peak <= 2 and done == [0, 1, 2, 3]
    assert Scheduler(reg, quota={"default": 1})._quota_for(reg.get("default")) == 1
    hinted = LoadedModel("h", "sde-gan", reg.get("default").cfg, reg.get("default").params,
                         hints={"quota": 3})
    assert Scheduler(reg)._quota_for(hinted) == 3


def test_terminal_batches_route_by_deadline_class():
    reg = _registry()
    sched = Scheduler(reg, max_batch=4, chunks=4, collect=True, **TERMINAL)
    reqs = [Request(rid=i, size=1 + i % 2, seed=70 + i, kind="terminal", deadline_ms=dl)
            for i, dl in enumerate([300.0, 40.0, math.inf, 40.0])]
    for r in reqs:
        sched.submit(r)
    first = sched.step()
    assert sorted(r.rid for r in first) == [1, 3]  # the tightest class first
    results = first + sched.run()
    assert sched.counters["terminal_batches"] == 3
    for res in results:
        req = reqs[res.rid]
        assert res.rtol == route_rtol([req]) and res.samples.shape == (req.size, 1)
        assert res.converged.shape == (req.size,) and res.num_converged == req.size
    summary = class_latency_summary(results)
    assert set(summary) == {"realtime", "standard", "relaxed"}
    assert summary["realtime"]["rows"] == 4


def test_latency_summary_and_open_loop_on_an_injected_clock():
    reg = _registry()
    now = [0.0]

    def clock():
        now[0] += 0.001
        return now[0]

    sched = Scheduler(reg, max_batch=4, chunks=2, clock=clock)
    reqs = [Request(rid=i, size=1, seed=80 + i, deadline_ms=1e-3 if i == 0 else math.inf)
            for i in range(3)]
    results = run_open_loop(sched, reqs, [0.0, 0.0, 0.01])
    assert sorted(r.rid for r in results) == [0, 1, 2]
    s = latency_summary(results)
    assert s["requests"] == 3 and s["rows"] == 3 and s["p50_s"] <= s["p99_s"]
    assert s["deadline_misses"] == 1


def test_scheduler_named_errors():
    reg = _registry()
    with pytest.raises(ValueError, match="'continuous' or 'fifo'"):
        Scheduler(reg, mode="lifo")
    with pytest.raises(ValueError, match="chunks must be >= 1"):
        Scheduler(reg, chunks=0)
    with pytest.raises(TypeError, match="quota must be"):
        Scheduler(reg, quota=1.5)
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        Scheduler(reg, max_batch=2).submit(Request(rid=0, size=3, seed=0))
    with pytest.raises(ValueError, match="must divide"):
        Scheduler(reg, chunks=3).submit(Request(rid=0, size=1, seed=0))
    with pytest.raises(ValueError, match="admission quota must be >= 1"):
        Scheduler(reg, quota=0).submit(Request(rid=0, size=1, seed=0))
    with pytest.raises(ValueError, match="no model 'other'"):
        Scheduler(reg).submit(Request(rid=0, size=1, seed=0, model_id="other"))
    lat = sde.LatentSDEConfig(data_dim=2, hidden_dim=4, context_dim=4, width=8, num_steps=8)
    reg.register(LoadedModel("lat", "latent-sde", lat,
                             sde.latent_sde_init(torch.Generator(), lat)))
    with pytest.raises(ValueError, match="serves the SDE-GAN"):
        Scheduler(reg).submit(Request(rid=0, size=1, seed=0, model_id="lat"))
    assert DEADLINE_CLASSES[0].name == "realtime"
