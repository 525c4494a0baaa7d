"""Rank functions of tests/test_torch_distributed.py and
tests/test_torch_compression.py: module-level (the spawned ranks unpickle
them by name) and free of JAX, so a rank imports only torch and the port.

Each runs on every rank of :func:`repro_torch.distributed.compat.launch`
and returns plain tensors on the CPU; called without a process group it is
the one-rank run of the same code.
"""

import contextlib
import math
import time

import torch

from repro_torch import tree
from repro_torch.core import sde
from repro_torch.distributed import compat, sharding
from repro_torch.kernels import prng
from repro_torch.launch import steps

DTYPES = {"float32": torch.float32, "float64": torch.float64}
GAN = dict(num_steps=8)  # the reference trainer's widths, 8 solver steps
GAN_BATCH, GAN_SEQ = 16, 9
LATENT = dict(data_dim=2, hidden_dim=4, context_dim=4, initial_noise_dim=3, width=8, depth=1,
              num_steps=23, kl_weight=0.1)
LATENT_BATCH, LATENT_SEQ = 8, 24


def _mesh_ctx(batch):
    mesh = sharding.data_parallel_mesh(batch)
    return compat.set_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def _cpu(x):
    return tree.map(lambda t: t.detach().cpu().clone() if isinstance(t, torch.Tensor) else t, x)


def gan_case(dtype: str, constraint: str, params=None, steps_n: int = 2, key_seed: int = 91):
    """``steps_n`` SDE-GAN steps from ``params`` (default: a seeded fresh
    model) -> ``[(metrics, params)]`` after each step."""
    cfg = sde.NeuralSDEConfig(**GAN, dtype=DTYPES[dtype])
    if params is None:
        gen = torch.Generator().manual_seed(90)
        params = {"gen": sde.generator_init(gen, cfg), "disc": sde.discriminator_init(gen, cfg)}
    (gi, gu), (di, du) = steps.make_gan_optimizers(1.0, constraint)
    step = steps.make_sde_gan_step(cfg, gu, du, GAN_BATCH, GAN_SEQ, constraint=constraint,
                                   device="cpu")
    state = (params, gi(params["gen"]), di(params["disc"]))
    out = []
    with _mesh_ctx(GAN_BATCH):
        for s in range(steps_n):
            p, g, d, metrics = step(*state, prng.fold_in_key(prng.PRNGKey(key_seed), s))
            state = (p, g, d)
            out.append((_cpu(metrics), _cpu(p)))
    return out


def latent_case(dtype: str, params=None, steps_n: int = 2, key_seed: int = 66,
                fused: bool = True):
    """``steps_n`` ELBO steps (the fused path by default: its ΔW drawn in
    ``rev_heun_phase1_gen``, windowed under the mesh) -> ``[(metrics,
    params)]`` after each step."""
    cfg = sde.LatentSDEConfig(**LATENT, use_pallas_kernels=fused, dtype=DTYPES[dtype])
    if params is None:
        params = sde.latent_sde_init(torch.Generator().manual_seed(63), cfg)
    init, update = steps.make_latent_sde_optimizer(1e-2)
    step = steps.make_latent_sde_step(cfg, update, LATENT_BATCH, LATENT_SEQ, device="cpu")
    state = (params, init(params))
    out = []
    with _mesh_ctx(LATENT_BATCH):
        for s in range(steps_n):
            p, o, metrics = step(*state, prng.fold_in_key(prng.PRNGKey(key_seed), s))
            state = (p, o)
            out.append((_cpu(metrics), _cpu(p)))
    return out


def training_cases(cases):
    """Every ``(kind, dtype)`` case of the W = 2 against W = 1 comparison."""
    out = {}
    for kind, dtype in cases:
        if kind == "elbo":
            out[kind, dtype] = latent_case(dtype)
        else:
            out[kind, dtype] = gan_case(dtype, kind)
    return out


def one_step(kind, params, key):
    """One float64 step (``kind`` "clip" or "elbo") from ``params`` at ``key``
    under the mesh -> ``(metrics, params)``."""
    if kind == "clip":
        cfg = sde.NeuralSDEConfig(**GAN, dtype=torch.float64)
        (gi, gu), (di, du) = steps.make_gan_optimizers(1.0, "clip")
        step = steps.make_sde_gan_step(cfg, gu, du, GAN_BATCH, GAN_SEQ, device="cpu")
        with _mesh_ctx(GAN_BATCH):
            p, _, _, metrics = step(params, gi(params["gen"]), di(params["disc"]), key)
        return _cpu(metrics), _cpu(p)
    cfg = sde.LatentSDEConfig(**LATENT, use_pallas_kernels=True, dtype=torch.float64)
    init, update = steps.make_latent_sde_optimizer(1e-2)
    step = steps.make_latent_sde_step(cfg, update, LATENT_BATCH, LATENT_SEQ, device="cpu")
    with _mesh_ctx(LATENT_BATCH):
        p, _, metrics = step(params, init(params), key)
    return _cpu(metrics), _cpu(p)


def collectives():
    """The data-parallel helpers on this rank: the mesh's place, the row
    windows, the gather, the mean, the broadcast."""
    out = {"none_for_odd": sharding.data_parallel_mesh(5) is None,
           "rank": compat.rank()}
    mesh = sharding.data_parallel_mesh(8)
    out["mesh"] = (mesh.axis_shapes, mesh.axis_names, mesh.coordinate)
    x = torch.arange(3 * 8 * 2, dtype=torch.float64).reshape(3, 8, 2) / 7
    with compat.set_mesh(mesh):
        out["dp_world"] = sharding.dp_world()
        out["row_window"] = sharding.row_window(8)
        out["time_major"] = sharding.shard_time_major(x)
        local = sharding.shard_time_major(x)
        out["gathered"] = sharding.gather_rows(local, 1)
        rank = compat.rank()
        out["gather_kinds"] = [
            sharding.gather_rows(t, 0) for t in (
                torch.full((2, 3), float("nan") if rank else -0.0, dtype=torch.float32),
                torch.tensor([[rank, -rank - 1]], dtype=torch.int64),
                torch.tensor([rank == 0, rank == 1]))]
        vals = [torch.full((3,), 0.1 * (rank + 1), dtype=torch.float64),
                torch.full((2, 2), 1.0 + rank, dtype=torch.float32),
                torch.tensor(0.3 * (rank + 1), dtype=torch.float64)]
        out["mean"] = sharding.allreduce_mean(vals)
        b = torch.full((4,), float(rank), dtype=torch.float64)
        out["broadcast"] = sharding.broadcast(b).clone()
        out["global_max"] = sharding.global_max(3 + 5 * rank)
    return out


def serve_samples(kw):
    """``serve_sde("sde-gan", collect=True, **kw)``'s samples by request id (None on
    a scheduler's follower ranks)."""
    from repro_torch.serving import serve_sde

    return serve_sde("sde-gan", device="cpu", collect=True, **kw).get("samples")


def scheduler_drain(shard_base: int, n: int = 8):
    """An ``n``-request drain of a ``Scheduler(shard_base=...)``: rank 0's
    samples by request id (the followers return None)."""
    from repro_torch.serving import LoadedModel, ModelRegistry, Request, Scheduler

    cfg = sde.NeuralSDEConfig(data_dim=1, hidden_dim=8, noise_dim=4, width=16, num_steps=8)
    reg = ModelRegistry()
    reg.register(LoadedModel("default", "sde-gan", cfg,
                             sde.generator_init(torch.Generator().manual_seed(30), cfg)))
    sched = Scheduler(reg, max_batch=8, chunks=4, collect=True, shard_base=shard_base,
                      atol=1e-2, max_steps=64)
    sched.warm("default")
    if compat.rank() != 0:
        sched.follow()
        return None
    for i in range(n):
        sched.submit(Request(rid=i, size=1 + i % 3, seed=100 + i,
                             deadline_ms=math.inf if i % 4 else 50.0,
                             kind="terminal" if i % 5 == 4 else "rollout"))
    results = sched.run()
    sched.close()
    return {r.rid: (r.samples, torch.as_tensor(r.converged)) for r in results}


def sleep_forever():
    time.sleep(600)


def compressed_mean(seed: int):
    """``allreduce_compressed`` of this rank's gradients -> (mean, new error,
    the rank's dequantised payload)."""
    from repro_torch.optim import compression

    g = torch.Generator().manual_seed(seed + compat.rank())
    grads = {"w": torch.randn(5, 3, generator=g), "b": torch.randn(3, generator=g)}
    err = {"w": torch.randn(5, 3, generator=g) * 1e-3, "b": torch.zeros(3)}
    q, s, _ = compression.ef_compress_update(grads, err)
    deq = {k: compression.decompress_int8(q[k], s[k]) for k in q}
    mean, new_err = compression.allreduce_compressed(grads, err)
    return mean, new_err, deq
