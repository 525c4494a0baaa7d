"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

What it does, in order (any failed check raises, so the exit code is
non-zero and the final result line is never printed):

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Holds each of the six kernels — ``rev_heun_phase1`` (sign ±1),
   ``rev_heun_phase2``, ``rev_heun_bwd_phase1``, ``rev_heun_bwd_phase2``,
   ``rev_heun_phase1_gen``, ``brownian_increment`` — against its plain
   PyTorch version on the card, in float32 and float64, at d in {16, 17}
   and B in {1, 64, 1024}, plus the training path's one-key draws
   (1 row of B·17): bitwise (max |Δ| must be 0).  Times each with CUDA
   events beside the plain version at the shapes the main paths give it:
   the training state (B in {64, 1024}, d = 17) and the serving bucket
   (B = 1024, d = 16).
4. Checks the in-port identities bitwise: ΔW from ``rev_heun_phase1_gen``
   = ΔW from ``brownian_increment`` = the plain ``BrownianPath.increment``,
   and the fused decode = the unfused decode.
5. Adjoint identities on the card, float64, at the training widths:
   the fused exact adjoint's ELBO gradients = the unfused ones (bitwise),
   and the exact adjoint = ``discretise`` (≤1e-12 relative).
6. Training, the slice's main path: ``train_latent_sde`` (the train CLI's
   entry point) runs 3 ELBO steps at batch 64, fused, with the launch
   counts zeroed just before and read just after — every kernel of the
   path must launch exactly 184 times per step (46 forward, 138
   backward) — then the same 3 steps unfused: finite losses, parameters
   bitwise equal.  The fused run writes a serving bundle, which
   ``serve_sde`` restores and serves (train -> serve handshake).  Then
   the fused and the unfused step's steps/s at batch 64 and 1024, timed in
   turns, and the device idle share of one step of each under
   ``torch.profiler``.
7. Memory: peak allocated bytes of one training step (the trajectory-form
   ELBO) and of one gradient of the terminal-form ELBO, at 23 and 230
   solver steps (24 observations, stride 1 and 10), exact adjoint vs
   ``discretise``: the exact adjoint's peak stays flat, discretise's grows.
8. Serves the Latent-SDE prior decode through ``serve_sde`` at the widths
   of examples/latent_sde_air_quality.py:75 (data 2, hidden 16, context 16,
   noise 8, width 32, depth 1; 23 steps on [0, 1]), fused and unfused:
   32 requests of up to 64 rows, buckets up to 1024, random weights from a
   seeded ``torch.Generator``.  The kernels' launch counts are zeroed just
   before and read just after; every serving kernel must have launched.
   Checks that the two variants agree bitwise, that a request served alone
   gets the same rows as served coalesced (padding invariance, bitwise),
   and that one bucket on the card matches the port on the CPU (float32
   tolerance below).
9. Prints a ``{"kernels": [...]}`` JSON line (``launches``: the training
   path's counts; ``serve_launches``: the serving path's) and, last, the
   result line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet):
# HBM 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s.  Integer ops
# are counted at the float32 rate; float64 outside the tensor cores 34 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
# Operation counts the bound assumes (minimal work, see bound()).
HASH_OPS = 120          # one Threefry-2x32 hash: 20 rounds of add/rotate/xor + keys
NORMAL_OPS = {torch.float32: 50, torch.float64: 75}  # bits->uniform->erf_inv->scale

# GPU clock cycles per millisecond at the H100 SXM's 1.98 GHz boost clock
# (sizes the hold in time_ms; a lower clock only lengthens the hold).
CYCLES_PER_MS = 1_980_000

# Trajectories on the card vs the port on the CPU, float32: the GEMMs sum in
# another order (cuBLAS vs the CPU BLAS) and sigmoid/tanh/log1p differ by an
# ulp or so; the same bound as the port against the JAX package.
CPU_RTOL, CPU_ATOL = 2e-5, 2e-6

# Exact adjoint vs discretise, float64 (the paper's "to floating-point error").
ADJOINT_RTOL = 1e-12

CSRC = "src/repro_torch/kernels/csrc/rev_heun.cu"
KERNEL_SOURCES = {
    "rev_heun_phase1": (CSRC, "src/repro/kernels/reversible_heun_step.py:152"),
    "rev_heun_phase2": (CSRC, "src/repro/kernels/reversible_heun_step.py:161"),
    "rev_heun_bwd_phase1": (CSRC, "src/repro/kernels/reversible_heun_step.py:170"),
    "rev_heun_bwd_phase2": (CSRC, "src/repro/kernels/reversible_heun_step.py:180"),
    "brownian_increment": (CSRC, "src/repro/kernels/brownian.py:71"),
    "rev_heun_phase1_gen": (CSRC, "src/repro/kernels/brownian.py:132"),
}
SERVE_KERNELS = ("rev_heun_phase1_gen", "rev_heun_phase2", "brownian_increment")
# Launches of one fused ELBO step at 23 solver steps: forward 23 x (phase1_gen,
# phase2); backward 23 x (brownian_increment, phase1 x2, phase2, bwd_phase1,
# bwd_phase2) — 46 + 138 = 184.
STEP_LAUNCHES = {"rev_heun_phase1_gen": 23, "rev_heun_phase2": 46,
                 "brownian_increment": 23, "rev_heun_phase1": 46,
                 "rev_heun_bwd_phase1": 23, "rev_heun_bwd_phase2": 23}
# The Latent SDE at the widths the repo trains it at (examples/
# latent_sde_air_quality.py:75, src/repro/launch/train.py:318).
WIDTHS = dict(data_dim=2, hidden_dim=16, context_dim=16, initial_noise_dim=8,
              width=32, depth=1, num_steps=23, t1=1.0)
SEQ_LEN = 24


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def time_ms(fn, reps: int = 20, trials: int = 7) -> tuple:
    """``(device_ms, host_ms)`` per call, medians over trials, by CUDA events.

    host: ``reps`` calls issued back to back, i.e. what a caller pays per
    call when the host is the limit.  device: the stream is first held busy
    (``torch.cuda._sleep``, for twice the host time of the ``reps`` calls)
    while the host enqueues them, so the events bracket the card's own time
    for the calls, back to back."""
    fn()
    torch.cuda.synchronize()

    def run(hold_cycles: int) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    host = statistics.median(run(0) for _ in range(trials))
    hold = int(2 * host * reps * CYCLES_PER_MS) + 1_000_000
    device = statistics.median(run(hold) for _ in range(trials))
    return device, host


def bound(name: str, B: int, d: int, dtype) -> tuple:
    """Least time for the work: bytes each read and written once over HBM
    bandwidth vs operations over the peak rate; -> (ms, 'bytes'|'operations').

    Minimal work: one fold_in hash per row, one hash per counter pair (two
    float32 draws share a pair; a float64 draw uses a whole pair)."""
    s = torch.finfo(dtype).bits // 8
    n = B * d
    hashes = B + (-(-d // 2) * B if dtype == torch.float32 else n)
    draw_ops = hashes * HASH_OPS + n * (NORMAL_OPS[dtype] + 1)
    if name == "rev_heun_phase2":  # 6 in, 1 out
        nbytes, ops = 7 * n * s, 7 * n
    elif name == "rev_heun_phase1":  # z, zh, mu, sigma, dw in; zh1 out
        nbytes, ops = 6 * n * s, 6 * n
    elif name == "rev_heun_bwd_phase1":  # g_z1, g_mu1, g_sig1, dw in; 2 out
        nbytes, ops = 6 * n * s, 6 * n
    elif name == "rev_heun_bwd_phase2":  # g_z1, ghat, dw in; 4 out
        nbytes, ops = 7 * n * s, 10 * n
    elif name == "brownian_increment":
        nbytes, ops = B * 16 + n * s, draw_ops
    else:  # rev_heun_phase1_gen: z, zh, mu, sigma, keys in; zh1, dw out
        nbytes, ops = B * 16 + 6 * n * s, draw_ops + 6 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_calls(ops, keys, st, d, dtype):
    """name -> call(use_kernel) of every kernel on one set of operands."""
    z, zh, mu, sg, mu1, sg1, dw = st
    dt = 1.0 / 23
    return {
        "rev_heun_phase1": lambda uk: (ops.rev_heun_phase1(z, zh, mu, sg, dw, dt, 1.0,
                                                           use_kernel=uk),
                                       ops.rev_heun_phase1(z, zh, mu, sg, dw, dt, -1.0,
                                                           use_kernel=uk)),
        "rev_heun_phase2": lambda uk: ops.rev_heun_phase2(
            z, mu, mu1, sg, sg1, dw, dt, use_kernel=uk),
        "rev_heun_bwd_phase1": lambda uk: ops.rev_heun_bwd_phase1(
            z, mu, sg, dw, dt, use_kernel=uk),
        "rev_heun_bwd_phase2": lambda uk: ops.rev_heun_bwd_phase2(
            z, zh, dw, dt, use_kernel=uk),
        "brownian_increment": lambda uk: ops.brownian_increment(
            keys, 5, (d,), dtype, dt, use_kernel=uk),
        "rev_heun_phase1_gen": lambda uk: ops.rev_heun_phase1_gen(
            z, zh, mu, sg, keys, 5, dt, dt, use_kernel=uk),
    }


def _operands(g, dev, dtype, rows, d):
    keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g, dtype=torch.int64).to(dev)
    st = [torch.randn(rows, d, generator=g, dtype=dtype).to(dev) for _ in range(7)]
    return keys, st


def kernel_checks(ops, dev) -> tuple:
    """Phase 3: every kernel bitwise against its plain version; timed at the
    main paths' shapes.  Returns ``{(name, dtype, B, d): row}`` timings and
    ``{name: max |Δ|}``."""
    g = torch.Generator().manual_seed(1234)
    errs = {name: 0.0 for name in KERNEL_SOURCES}
    # (rows, d): small and serving shapes, the training state, and the
    # training path's one-key draws (one row of B*17: a BrownianPath with a
    # single key over the (B, 17) state).
    shapes = [(1, 16), (1, 17), (64, 17), (1024, 16), (1024, 17), (1, 64 * 17),
              (1, 1024 * 17)]
    for dtype in (torch.float32, torch.float64):
        for rows, d in shapes:
            keys, st = _operands(g, dev, dtype, rows, d)
            for name, call in _kernel_calls(ops, keys, st, d, dtype).items():
                got, want = call(True), call(False)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                check(same and err == 0.0,
                      f"{name} {dtype} rows={rows} d={d}: kernel != plain (max |Δ| {err})")
                errs[name] = max(errs[name], err)
    print("bitwise: 6 kernels x {float32, float64} x (rows, d) in "
          f"{shapes}: kernel == plain", flush=True)

    rows = {}
    print("kernel                dtype    B     d   kernel_ms (host)     "
          "plain_ms (host)      bound_ms (by)", flush=True)
    timed = [(dt, B, 17) for dt in (torch.float32, torch.float64) for B in (64, 1024)]
    timed.append((torch.float32, 1024, 16))  # the serving bucket
    for dtype, B, d in timed:
        for name in KERNEL_SOURCES:
            if d == 16 and name not in SERVE_KERNELS:
                continue
            # training draws come from one key over the whole (B, 17) state
            one_key = name in ("brownian_increment", "rev_heun_phase1_gen") and d == 17
            r, dd = (1, B * d) if one_key else (B, d)
            keys, st = _operands(g, dev, dtype, r, dd)
            call = _kernel_calls(ops, keys, st, dd, dtype)[name]
            per = 2 if name == "rev_heun_phase1" else 1  # the call runs sign +1 and -1
            k_ms, k_host = (x / per for x in time_ms(lambda: call(True)))
            p_ms, p_host = (x / per for x in time_ms(lambda: call(False)))
            b_ms, b_by = bound(name, r, dd, dtype)
            print(f"{name:21s} {str(dtype)[6:]:8s} {B:<5d} {d:<3d} "
                  f"{k_ms:.5f} ({k_host:.5f})  {p_ms:.5f} ({p_host:.5f})  "
                  f"{b_ms:.6f} ({b_by})", flush=True)
            rows[(name, dtype, B, d)] = dict(ms=k_ms, plain_ms=p_ms, host_ms=k_host,
                                             plain_host_ms=p_host, bound_ms=b_ms,
                                             bound_by=b_by)
    return rows, errs


def identity_checks(ops, dev) -> None:
    """Phase 4: ΔW and fused/unfused identities inside the port, bitwise."""
    from repro_torch.core.brownian import BrownianPath
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init, latent_sde_sample_paths
    from repro_torch.kernels import prng

    g = torch.Generator().manual_seed(99)
    for dtype in (torch.float32, torch.float64):
        keys = torch.randint(0, 2 ** 32, (1024, 2), generator=g, dtype=torch.int64).to(dev)
        z = torch.randn(1024, 16, generator=g, dtype=dtype).to(dev)
        bm = BrownianPath(keys, 0.0, 1.0, (16,), dtype)
        for n in (0, 7, 22):
            _, w_gen = ops.rev_heun_phase1_gen(z, z, z, z, keys, n, 1.0 / 23, 1.0 / 23)
            w_inc = bm.increment(n, 23)
            w_plain = bm.increment(n, 23, use_kernel=False)
            check(torch.equal(w_gen, w_inc) and torch.equal(w_inc, w_plain),
                  f"ΔW identity broken ({dtype}, n={n})")
        base = dict(data_dim=2, hidden_dim=16, context_dim=16, initial_noise_dim=8,
                    width=32, depth=1, num_steps=23, t1=1.0, dtype=dtype)
        params = latent_sde_init(torch.Generator().manual_seed(5),
                                 LatentSDEConfig(**base), device=dev)
        k = torch.stack(prng.fold_in(7, 11, torch.arange(1024)), -1).to(dev)
        fused = latent_sde_sample_paths(params, LatentSDEConfig(**base, use_pallas_kernels=True), k)
        unfused = latent_sde_sample_paths(params, LatentSDEConfig(**base), k)
        check(torch.equal(fused, unfused), f"fused decode != unfused decode ({dtype})")
    print("identities: ΔW(phase1_gen) == ΔW(brownian_increment) == plain "
          "BrownianPath.increment; fused decode == unfused decode "
          "(float32, float64, bitwise)", flush=True)


def _grads(loss_fn, params, cfg, key, ys):
    """ELBO gradients w.r.t. every parameter leaf."""
    from repro_torch import tree

    leaves, spec = tree.flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    loss, _ = loss_fn(tree.unflatten(spec, leaves), cfg, key, ys)
    return torch.autograd.grad(loss, leaves)


def adjoint_checks(dev) -> None:
    """Phase 5: fused exact adjoint == unfused (bitwise) and exact adjoint ==
    discretise (<= ADJOINT_RTOL relative), float64, training widths, B = 64."""
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init, latent_sde_loss
    from repro_torch.data import air_quality_like
    from repro_torch.kernels import prng

    cfg = LatentSDEConfig(**WIDTHS, kl_weight=0.1, dtype=torch.float64)
    params = latent_sde_init(torch.Generator().manual_seed(7), cfg, device=dev)
    key = prng.PRNGKey(8, device=dev)
    ys, _ = air_quality_like(prng.fold_in_key(key, 0), 64, SEQ_LEN, dtype=torch.float64)
    k = prng.fold_in_key(key, 1)
    unfused = _grads(latent_sde_loss, params, cfg, k, ys)
    fused = _grads(latent_sde_loss, params,
                   dataclasses.replace(cfg, use_pallas_kernels=True), k, ys)
    dto = _grads(latent_sde_loss, params,
                 dataclasses.replace(cfg, gradient_mode="discretise"), k, ys)
    torch.cuda.synchronize()
    diff = max((a - b).abs().max().item() for a, b in zip(fused, unfused))
    check(all(torch.equal(a, b) for a, b in zip(fused, unfused)),
          f"fused exact adjoint != unfused (max |Δ| {diff})")
    rel = (sum((a - b).abs().sum().item() for a, b in zip(unfused, dto))
           / sum(b.abs().sum().item() for b in dto))
    check(rel <= ADJOINT_RTOL, f"exact adjoint vs discretise: relative error {rel}")
    print(f"adjoint (float64, B=64, 23 steps): fused == unfused bitwise; exact vs "
          f"discretise relative error {rel:.3g} (<= {ADJOINT_RTOL})", flush=True)


def train_checks(ops, dev, label: str) -> dict:
    """Phase 6: the training main path through train_latent_sde, fused and
    unfused; the train -> serve handshake; steps/s and the device profile.
    Returns the fused run's launch counts."""
    from repro_torch import tree
    from repro_torch.launch.train import train_latent_sde
    from repro_torch.serving import serve_sde

    runs, launches = {}, None
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        for variant, fused in (("fused", True), ("unfused", False)):
            if fused:
                ops.reset_launch_counts()
            params, losses = train_latent_sde(3, 64, tmp if fused else None, seed=11,
                                              log_every=1, use_pallas=fused)
            torch.cuda.synchronize()
            if fused:
                launches = ops.launch_counts()
            runs[variant] = (params, losses)
            print(f"[{label}] train {variant}: -ELBO {losses}", flush=True)
        served = serve_sde("latent-sde", tmp, max_batch=64, requests=4, request_max=16,
                           seed=12, collect=True)
    print(f"[{label}] training-path launches (3 fused steps): {launches}", flush=True)
    for name, per_step in STEP_LAUNCHES.items():
        check(launches[name] == 3 * per_step,
              f"{name}: {launches[name]} launches in 3 fused steps, expected {3 * per_step}")
    for variant, (_, losses) in runs.items():
        check(all(map(math.isfinite, losses)), f"train {variant}: non-finite -ELBO {losses}")
    check(runs["fused"][1] == runs["unfused"][1], "fused and unfused -ELBO differ")
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(runs["fused"][0]),
                                                   tree.leaves(runs["unfused"][0])))
    check(same, "fused and unfused parameters differ after 3 steps")
    for rid, ys in served["samples"].items():
        check(ys.shape[0] == 24 and ys.shape[2] == 2 and torch.isfinite(ys).all().item(),
              f"trained bundle, request {rid}: bad trajectory {tuple(ys.shape)}")
    print(f"train -> serve: the fused run's bundle served {served['trajectories']} "
          f"trajectories (finite, (24, n, 2)); fused == unfused parameters bitwise",
          flush=True)
    for batch in (64, 1024):
        step_rate(dev, batch, label)
    return launches


def _train_step(dev, batch: int, fused: bool = True, num_steps: int = 23,
                gradient_mode=None):
    """``run()`` takes one ELBO step at the training widths (float32) from
    fresh parameters."""
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init
    from repro_torch.kernels import prng
    from repro_torch.launch.steps import make_latent_sde_optimizer, make_latent_sde_step

    cfg = LatentSDEConfig(**{**WIDTHS, "num_steps": num_steps}, kl_weight=0.1,
                          use_pallas_kernels=fused, gradient_mode=gradient_mode)
    params = latent_sde_init(torch.Generator().manual_seed(13), cfg, device=dev)
    init, update = make_latent_sde_optimizer()
    step = make_latent_sde_step(cfg, update, batch, SEQ_LEN, device=dev)
    key = prng.PRNGKey(14, device=dev)
    state = init(params)
    return lambda: step(params, state, key)


def step_rate(dev, batch: int, label: str) -> None:
    """Steps/s of the fused and the unfused step, taken in turns (fused,
    unfused, unfused, fused, ...; host clock around synchronised steps), and
    one step of each under the profiler."""
    runs = {"fused": _train_step(dev, batch), "unfused": _train_step(dev, batch, fused=False)}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    walls = {variant: [] for variant in runs}
    for i in range(6):
        for variant in (("fused", "unfused") if i % 2 == 0 else ("unfused", "fused")):
            t0 = time.perf_counter()
            runs[variant]()
            torch.cuda.synchronize()
            walls[variant].append(time.perf_counter() - t0)
    for variant, w in walls.items():
        wall = statistics.median(w)
        print(f"[{label}] train step B={batch} ({variant}, float32, 23 steps): "
              f"{1 / wall:.2f} steps/s (median of 6 in turns: {wall * 1e3:.1f} ms; "
              f"all {', '.join(f'{x * 1e3:.1f}' for x in w)} ms)", flush=True)
    for variant, run in runs.items():
        profile_call(run, f"{label}] [train {variant} B={batch}")


def _terminal_grad(dev, num_steps: int, gradient_mode: str):
    """``run()`` takes the gradient of the terminal-form ELBO (the exact
    adjoint's terminal solve) at the training widths, float32, batch 64."""
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init, latent_sde_loss_terminal
    from repro_torch.data import air_quality_like
    from repro_torch.kernels import prng

    cfg = LatentSDEConfig(**{**WIDTHS, "num_steps": num_steps}, kl_weight=0.1,
                          use_pallas_kernels=gradient_mode == "reversible_adjoint",
                          gradient_mode=gradient_mode)
    params = latent_sde_init(torch.Generator().manual_seed(13), cfg, device=dev)
    key = prng.PRNGKey(14, device=dev)
    ys, _ = air_quality_like(prng.fold_in_key(key, 0), 64, SEQ_LEN)
    return lambda: _grads(latent_sde_loss_terminal, params, cfg, prng.fold_in_key(key, 1), ys)


def memory_checks(dev, label: str) -> None:
    """Phase 7: peak allocated memory of one training step (trajectory form)
    and of one terminal-form gradient, exact adjoint vs discretise, at 23 and
    230 solver steps (24 observations)."""
    forms = {"step": lambda mode, n: _train_step(dev, 64, fused=mode == "reversible_adjoint",
                                                 num_steps=n, gradient_mode=mode),
             "terminal": lambda mode, n: _terminal_grad(dev, n, mode)}
    for form, make in forms.items():
        peaks = {}
        for mode in ("reversible_adjoint", "discretise"):
            for n in (23, 230):
                run = make(mode, n)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                run()
                torch.cuda.synchronize()
                peaks[(mode, n)] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
                print(f"[{label}] memory ({form}): {mode} N={n}: peak "
                      f"{peaks[(mode, n)]:.2f} MiB above the {base / 2 ** 20:.2f} MiB "
                      f"held before", flush=True)
        exact, dto = [peaks[("reversible_adjoint", n)] for n in (23, 230)], \
            [peaks[("discretise", n)] for n in (23, 230)]
        check(exact[1] <= 1.5 * exact[0], f"{form}: exact adjoint's peak grew with N: "
                                           f"{exact} MiB")
        check(dto[1] >= 3 * dto[0], f"{form}: discretise's peak did not grow with N: "
                                    f"{dto} MiB")


def serve_checks(ops, dev, label: str) -> dict:
    """Phase 5: the main path through serve_sde, fused and unfused."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init
    from repro_torch.launch.steps import make_sample_step
    from repro_torch.serving import restore_for_serving, serve_buckets, serve_sde
    from repro_torch.serving.service import _request_keys
    from repro_torch.serving.types import synthetic_requests

    widths = WIDTHS
    params = latent_sde_init(torch.Generator().manual_seed(0), LatentSDEConfig(**widths))
    serve = dict(max_batch=1024, requests=32, request_max=64, seed=3, collect=True)
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        for variant, fused in (("fused", True), ("unfused", False)):
            cfg = LatentSDEConfig(**widths, use_pallas_kernels=fused)
            ckpt.save_serving_bundle(os.path.join(tmp, variant), 0, params,
                                     "latent-sde", cfg)
        ops.reset_launch_counts()
        for variant in ("fused", "unfused", "unfused", "fused"):  # in turns
            stats = serve_sde("latent-sde", os.path.join(tmp, variant),
                              latent_mode="prior", **serve)
            results.setdefault(variant, stats)
            print(f"[{label}] serve {variant}: {stats['traj_per_s']:.1f} traj/s, "
                  f"p50 {stats['p50_s'] * 1e3:.2f} ms, p99 {stats['p99_s'] * 1e3:.2f} ms "
                  f"({stats['trajectories']} trajectories, {stats['batches']} batches)",
                  flush=True)
        launches = ops.launch_counts()
        print(f"[{label}] serving-path launches: {launches}", flush=True)
        restored, cfg_f, _ = restore_for_serving("latent-sde", os.path.join(tmp, "fused"), dev)
    for name in SERVE_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the serving path")

    fused, unfused = results["fused"]["samples"], results["unfused"]["samples"]
    check(sorted(fused) == sorted(unfused) and len(fused) == serve["requests"],
          "variants answered different requests")
    for rid in fused:
        ys = fused[rid]
        check(ys.shape == (24, ys.shape[1], 2) and torch.isfinite(ys).all().item(),
              f"request {rid}: bad trajectory shape {tuple(ys.shape)} or non-finite")
        check(torch.equal(ys, unfused[rid]), f"request {rid}: fused != unfused")

    sampler = make_sample_step("latent-sde", cfg_f)
    buckets = serve_buckets(serve["max_batch"])
    reqs = list(synthetic_requests(serve["requests"], serve["request_max"], serve["seed"]))
    for r in reqs[:6]:
        bucket = next(b for b in buckets if b >= r.size)
        solo = sampler(restored, _request_keys([r], bucket, dev))[:, :r.size].cpu()
        check(torch.equal(solo, fused[r.rid]),
              f"request {r.rid} (size {r.size}): solo rows != coalesced rows")
    print("padding invariance: 6 requests served solo == coalesced (bitwise)", flush=True)

    keys = _request_keys(reqs[:3], 64, dev)
    on_card = sampler(restored, keys).cpu()
    cpu_params = _to_device(restored, "cpu")
    on_cpu = make_sample_step("latent-sde", cfg_f, device="cpu")(cpu_params, keys.cpu())
    err = (on_card - on_cpu).abs().max().item()
    check(torch.allclose(on_card, on_cpu, rtol=CPU_RTOL, atol=CPU_ATOL),
          f"card vs CPU: max |Δ| {err} beyond rtol={CPU_RTOL}, atol={CPU_ATOL}")
    print(f"card vs CPU (bucket 64, float32): max |Δ| {err:.3g} within rtol={CPU_RTOL}, "
          f"atol={CPU_ATOL}", flush=True)
    decodes = {v: 2 * (len(buckets) + results[v]["batches"]) for v in results}
    keys = _request_keys(reqs, 1024, dev)
    for variant, fuse in (("fused", True), ("unfused", False)):
        profile_decode(make_sample_step("latent-sde", dataclasses.replace(
            cfg_f, use_pallas_kernels=fuse)), restored, keys, f"{label}] [{variant}")
    return dict(launches=launches, results=results, decodes=decodes)


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", None) or getattr(
        evt, "self_cuda_time_total", 0.0)


def profile_decode(sampler, params, keys, label: str) -> None:
    profile_call(lambda: sampler(params, keys), f"{label}] [decode B={keys.shape[0]}")


def profile_call(fn, label: str) -> None:
    """Where one call's time goes: wall time (unprofiled, host clock around a
    synchronised call) against the card's busy time (the summed time of the
    device-side events — kernels, copies — under torch.profiler; the host
    ops that launched them carry the same time and are left out, or it
    would count twice); the rest is idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if not events:
        print(f"[{label}: wall {wall_ms:.3f} ms; device busy time not measured (the "
              f"profiler recorded no device events)", flush=True)
        return
    top = sorted(events, key=_device_us, reverse=True)[:6]
    print(f"[{label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({sum(e.count for e in events)} device kernels and copies), idle share "
          f"{1 - busy_ms / wall_ms:.3f}", flush=True)
    for e in top:
        print(f"    {_device_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}", flush=True)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs the GPU",
              file=sys.stderr)
        return 2
    label = gpu_label()
    print(f"card: {label}", flush=True)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ops

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    print(f"built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    rows, errs = kernel_checks(ops, dev)
    identity_checks(ops, dev)
    adjoint_checks(dev)
    train_launches = train_checks(ops, dev, label)
    memory_checks(dev, label)
    serve = serve_checks(ops, dev, label)

    print(f"kernels: {', '.join(KERNEL_SOURCES)} (route cuda, bitwise = plain; "
          f"decodes: {serve['decodes']})", flush=True)
    entries = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        r = rows[(name, torch.float32, 1024, 17)]  # the training timing batch
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": train_launches[name], "max_abs_err": errs[name],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "host_ms": r["host_ms"], "plain_host_ms": r["plain_host_ms"],
                        "serve_launches": serve["launches"][name]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"card: {label}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
