"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

What it does, in order (any failed check raises, so the exit code is
non-zero and the final result line is never printed):

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. Holds each kernel — ``rev_heun_phase1_gen``, ``rev_heun_phase2``,
   ``brownian_increment`` — against its plain PyTorch version on the card,
   in float32 and float64, at d in {16, 17} (the odd counter pad) and
   B in {1, 1024} (the smallest and largest serving bucket): bitwise
   (max |Δ| must be 0).  Times each with CUDA events beside the plain
   version.
4. Checks the in-port identities bitwise: ΔW from ``rev_heun_phase1_gen``
   = ΔW from ``brownian_increment`` = the plain ``BrownianPath.increment``,
   and the fused decode = the unfused decode.
5. Serves the Latent-SDE prior decode through ``serve_sde`` at the widths
   of examples/latent_sde_air_quality.py:75 (data 2, hidden 16, context 16,
   noise 8, width 32, depth 1; 23 steps on [0, 1]), fused and unfused:
   32 requests of up to 64 rows, buckets up to 1024, random weights from a
   seeded ``torch.Generator``.  The kernels' launch counts are zeroed just
   before and read just after; every kernel must have launched.  Checks
   that the two variants agree bitwise, that a request served alone gets
   the same rows as served coalesced (padding invariance, bitwise), and
   that one bucket on the card matches the port on the CPU (float32
   tolerance below).
6. Prints a ``{"kernels": [...]}`` JSON line and, last, the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
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

KERNEL_SOURCES = {
    "rev_heun_phase1_gen": ("src/repro_torch/kernels/csrc/rev_heun.cu",
                            "src/repro/kernels/brownian.py:132"),
    "rev_heun_phase2": ("src/repro_torch/kernels/csrc/rev_heun.cu",
                        "src/repro/kernels/reversible_heun_step.py:161"),
    "brownian_increment": ("src/repro_torch/kernels/csrc/rev_heun.cu",
                           "src/repro/kernels/brownian.py:71"),
}


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
    if name == "rev_heun_phase2":
        nbytes, ops = 7 * n * s, 7 * n
    elif name == "brownian_increment":
        nbytes, ops = B * 16 + n * s, draw_ops
    else:  # rev_heun_phase1_gen: z, zh, mu, sigma, keys in; zh1, dw out
        nbytes, ops = B * 16 + 6 * n * s, draw_ops + 6 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks(ops, dev) -> dict:
    """Phase 3: every kernel bitwise against its plain version, timed."""
    g = torch.Generator().manual_seed(1234)
    rows = {}
    print("kernel                dtype    B     d   max|Δ|  kernel_ms (host)     "
          "plain_ms (host)      bound_ms (by)", flush=True)
    for dtype in (torch.float32, torch.float64):
        for B in (1, 1024):
            for d in (16, 17):
                keys = torch.randint(0, 2 ** 32, (B, 2), generator=g,
                                     dtype=torch.int64).to(dev)
                st = [torch.randn(B, d, generator=g, dtype=dtype).to(dev)
                      for _ in range(7)]
                z, zh, mu, sg, mu1, sg1, dw = st
                dt = 1.0 / 23
                calls = {
                    "rev_heun_phase1_gen": lambda uk: ops.rev_heun_phase1_gen(
                        z, zh, mu, sg, keys, 5, dt, dt, use_kernel=uk),
                    "rev_heun_phase2": lambda uk: ops.rev_heun_phase2(
                        z, mu, mu1, sg, sg1, dw, dt, use_kernel=uk),
                    "brownian_increment": lambda uk: ops.brownian_increment(
                        keys, 5, (d,), dtype, dt, use_kernel=uk),
                }
                for name, call in calls.items():
                    got, want = call(True), call(False)
                    torch.cuda.synchronize()
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    err = max((a - b).abs().max().item() for a, b in zip(got, want))
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    check(same and err == 0.0,
                          f"{name} {dtype} B={B} d={d}: kernel != plain (max |Δ| {err})")
                    k_ms, k_host = time_ms(lambda: call(True))
                    p_ms, p_host = time_ms(lambda: call(False))
                    b_ms, b_by = bound(name, B, d, dtype)
                    print(f"{name:21s} {str(dtype)[6:]:8s} {B:<5d} {d:<3d} {err:<7g} "
                          f"{k_ms:.5f} ({k_host:.5f})  {p_ms:.5f} ({p_host:.5f})  "
                          f"{b_ms:.6f} ({b_by})", flush=True)
                    rows[(name, dtype, B, d)] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                                     host_ms=k_host, plain_host_ms=p_host,
                                                     bound_ms=b_ms, bound_by=b_by)
    return rows


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


def serve_checks(ops, dev, label: str) -> dict:
    """Phase 5: the main path through serve_sde, fused and unfused."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.core.sde import LatentSDEConfig, latent_sde_init
    from repro_torch.launch.steps import make_sample_step
    from repro_torch.serving import restore_for_serving, serve_buckets, serve_sde
    from repro_torch.serving.service import _request_keys
    from repro_torch.serving.types import synthetic_requests

    widths = dict(data_dim=2, hidden_dim=16, context_dim=16, initial_noise_dim=8,
                  width=32, depth=1, num_steps=23, t1=1.0)
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
        print(f"[{label}] main-path launches: {launches}", flush=True)
        restored, cfg_f, _ = restore_for_serving("latent-sde", os.path.join(tmp, "fused"), dev)
    for name in KERNEL_SOURCES:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")

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
    """Where one decode batch's time goes: wall time (unprofiled, host
    clock around a synchronised call) against the card's busy time (sum of
    kernel self time under torch.profiler); the rest is idle."""
    from torch.profiler import ProfilerActivity, profile

    sampler(params, keys)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        sampler(params, keys)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler(params, keys)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if not events:
        print(f"[{label}] decode B={keys.shape[0]}: wall {wall_ms:.3f} ms; device busy "
              f"time not measured (the profiler recorded no device events)", flush=True)
        return
    top = sorted(events, key=_device_us, reverse=True)[:6]
    print(f"[{label}] decode B={keys.shape[0]}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({sum(e.count for e in events)} device ops), idle share "
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

    rows = kernel_checks(ops, dev)
    identity_checks(ops, dev)
    serve = serve_checks(ops, dev, label)

    print(f"kernels: {', '.join(KERNEL_SOURCES)} (route cuda, bitwise = plain; "
          f"decodes: {serve['decodes']})", flush=True)
    entries = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        r = rows[(name, torch.float32, 1024, 16)]  # the main path's largest bucket
        err = max(v["err"] for (n, *_), v in rows.items() if n == name)
        entries.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": serve["launches"][name], "max_abs_err": err,
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None,
                        "host_ms": r["host_ms"], "plain_host_ms": r["plain_host_ms"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"card: {label}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
