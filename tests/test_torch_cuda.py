"""The port's CUDA kernels on the card: bitwise against their plain PyTorch
versions, launch counting, operand checks, fused = unfused decode, the
fused exact adjoint = the unfused one on a whole ELBO training step, and
the adaptive paths: the ``brownian_value`` kernel, the fused adaptive
exact adjoint = the unfused one, and the adaptive SDE-GAN sampler's
padding invariance; the GQA attention kernel against its plain version
(float32 2e-5, bfloat16 6e-2: the two sum in different orders), two
launches bitwise equal, (B, S, H, D) views bitwise the contiguous
operands' result (every chip_smoke.py attention shape in float32), and a
two-layer smoke LM's prefill routed through it; the ``brownian_value``
redesign's edges (rows, sizes, depths; the grid) bitwise; the SSD chunk-scan kernel
against its plain version (y: float32 2e-4, bfloat16 6e-2; the state 2e-4
of its largest magnitude) at its edges (the four (N, P) pairs, S around
the chunk, batch 1, a strong decay, rows off 16-byte boundaries), two
launches, contiguous copies and every slice count bitwise equal, and a
two-layer smoke mamba2 prefill through it; the MoE and hybrid smoke
prefills through both kernels, two of them bitwise equal, and the MoE
combine bitwise the CPU's; the SDE field MLP kernel against its plain version (float32 2e-5, bfloat16
6e-2, float64 1e-12), row-invariant bitwise, and the depth-1 fields routed
through it; its backward kernel against ``ref.fused_mlp_bwd`` (the same
tolerances) at rows up to 4096, two launches bitwise, dx rows invariant,
its plan the Python mirror's and its cluster schedulable, one launch a
backward and none under create_graph; one SDE-GAN clip step's gradients
against the plain fields, its launches, one pull = two; gradients through the attention and
SSD kernels bitwise the plain path's for a loss linear in the outputs
(the MLP's within its tolerances); the cross-entropy
kernels against their plain versions (loss float32 1e-5, bfloat16 3e-2;
dlogits float32 1e-5, bfloat16 one ulp), rows invariant bitwise, and a
smoke LM training step's loss through them; the paper's baselines: the
backsolve and checkpoint ELBO gradients against the CPU's, and a
bf16_compute training step; the srk solver's space-time kernels
(``space_time_increment``, ``space_time_value``, the latter also at depths
100 and 512, past its ring of levels) bitwise against their plain
versions, counted and checked, and the srk checkpoint ELBO gradient
against the CPU's; the MLP kernel's two launches alike and rows invariant
at every width chip_smoke.py checks; the serving registry's CUDA graphs:
a replayed chunk bitwise the eager chunk at buckets 1, 64 and 1024, its
recorded launches, and an eviction that frees the graph's bytes and a
rebuild that gives its bits; ``brownian_increment``,
``rev_heun_phase2``, ``rev_heun_phase1_gen``, ``rev_heun_phase1``,
``rev_heun_bwd_phase1`` and ``rev_heun_bwd_phase2`` (programmatic dependent
launches) bitwise their plain versions at REDESIGN_SHAPES and from launch
to launch, the four one-pass kernels on views off 16-byte boundaries, the
six replayed in a captured graph behind ``fused_mlp``, and the increment's
index helper on its 32- and 64-bit paths; the row-windowed one-key draws
of ``brownian_increment``, ``rev_heun_phase1_gen`` and
``space_time_increment`` bitwise their plain versions and, concatenated,
the whole launch.

These need an NVIDIA GPU with nvcc (the kernels have no CPU mode); each test
skips without one.  On the GPU machine::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per xdist worker)

from repro_torch import nn, tree
from repro_torch.core import BrownianPath, solve
from repro_torch.core.sde import (LatentSDEConfig, NeuralSDEConfig, generator_init,
                                  latent_sde_init, latent_sde_sample_paths)
from repro_torch.kernels import flash_attention as fa_kernel, ops, prng
from repro_torch.launch.steps import (make_adaptive_terminal_step, make_latent_sde_optimizer,
                                      make_latent_sde_step)

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, dtype, B, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, 2 ** 32, (B, 2), generator=g, dtype=torch.int64).to(cuda)
    st = [torch.randn(B, d, generator=g, dtype=dtype).to(cuda) for _ in range(7)]
    return keys, st


# the six dependent launches (rev_heun_phase1 and rev_heun_bwd_phase2 in
# test_training_kernels_bitwise_equal_plain_versions) at one element, odd
# sizes (the last counter pair's zero pad), the training state, the serving
# bucket and the training path's one-key draws (one row of B·17)
REDESIGN_SHAPES = [(1, 1), (1, 3), (1, 17), (64, 17), (1024, 16), (1024, 17), (1, 1088),
                   (1, 17408)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,d", [(1, 16), (3, 17), (64, 16)] + REDESIGN_SHAPES)
def test_kernels_bitwise_equal_plain_versions(cuda, dtype, B, d):
    """Bitwise the plain versions; the pair-a-thread draws and the 16-byte
    passes (all dependent launches) also alike from launch to launch."""
    keys, (z, zh, mu, sg, mu1, sg1, dw) = _inputs(cuda, dtype, B, d)
    for sign in (1.0, -1.0):
        a = ops.rev_heun_phase2(z, mu, mu1, sg, sg1, dw, 0.05, sign)
        b = ops.rev_heun_phase2(z, mu, mu1, sg, sg1, dw, 0.05, sign, use_kernel=False)
        assert torch.equal(a, b)
        assert torch.equal(a, ops.rev_heun_phase2(z, mu, mu1, sg, sg1, dw, 0.05, sign))
        zh1, w = ops.rev_heun_phase1_gen(z, zh, mu, sg, keys, 4, 0.05, 0.05, sign)
        zh1_r, w_r = ops.rev_heun_phase1_gen(z, zh, mu, sg, keys, 4, 0.05, 0.05, sign,
                                             use_kernel=False)
        assert torch.equal(zh1, zh1_r) and torch.equal(w, w_r)
        again = ops.rev_heun_phase1_gen(z, zh, mu, sg, keys, 4, 0.05, 0.05, sign)
        assert torch.equal(zh1, again[0]) and torch.equal(w, again[1])
    seeds = ops.rev_heun_bwd_phase1(z, mu1, sg1, dw, 0.05)
    for got, want, again in zip(seeds,
                                ops.rev_heun_bwd_phase1(z, mu1, sg1, dw, 0.05, use_kernel=False),
                                ops.rev_heun_bwd_phase1(z, mu1, sg1, dw, 0.05)):
        assert torch.equal(got, want) and torch.equal(got, again)
    inc = ops.brownian_increment(keys, 4, (d,), dtype, 0.05)
    assert torch.equal(inc, ops.brownian_increment(keys, 4, (d,), dtype, 0.05,
                                                   use_kernel=False))
    assert torch.equal(inc, w)
    assert torch.equal(inc, ops.brownian_increment(keys, 4, (d,), dtype, 0.05))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,d", [(1, 16)] + REDESIGN_SHAPES)
def test_training_kernels_bitwise_equal_plain_versions(cuda, dtype, B, d):
    """The backward's kernels bitwise their plain versions; the dependent
    launches of ``rev_heun_phase1`` (both signs) and ``rev_heun_bwd_phase2``
    also alike from launch to launch."""
    _, (z, zh, mu, sg, mu1, sg1, dw) = _inputs(cuda, dtype, B, d, seed=1)
    for sign in (1.0, -1.0):
        got = ops.rev_heun_phase1(z, zh, mu, sg, dw, 1 / 23, sign)
        assert torch.equal(got, ops.rev_heun_phase1(z, zh, mu, sg, dw, 1 / 23, sign,
                                                    use_kernel=False))
        assert torch.equal(got, ops.rev_heun_phase1(z, zh, mu, sg, dw, 1 / 23, sign))
    for got, want in zip(ops.rev_heun_bwd_phase1(z, zh, mu, dw, 1 / 23),
                         ops.rev_heun_bwd_phase1(z, zh, mu, dw, 1 / 23, use_kernel=False)):
        assert torch.equal(got, want)
    for got, want, again in zip(ops.rev_heun_bwd_phase2(z, zh, dw, 1 / 23),
                                ops.rev_heun_bwd_phase2(z, zh, dw, 1 / 23, use_kernel=False),
                                ops.rev_heun_bwd_phase2(z, zh, dw, 1 / 23)):
        assert torch.equal(got, want) and torch.equal(got, again)


# the one-pass kernels: (operands, call(use_kernel, *operands) -> outputs)
VIEW_KERNELS = {
    "rev_heun_phase1": (5, lambda uk, *v: tuple(ops.rev_heun_phase1(*v, 1 / 23, sign,
                                                                    use_kernel=uk)
                                                for sign in (1.0, -1.0))),
    "rev_heun_phase2": (6, lambda uk, *v: (ops.rev_heun_phase2(*v, 1 / 23, -1.0,
                                                               use_kernel=uk),)),
    "rev_heun_bwd_phase1": (4, lambda uk, *v: ops.rev_heun_bwd_phase1(*v, 1 / 23,
                                                                      use_kernel=uk)),
    "rev_heun_bwd_phase2": (3, lambda uk, *v: ops.rev_heun_bwd_phase2(*v, 1 / 23,
                                                                      use_kernel=uk)),
}


@pytest.mark.parametrize("kernel", list(VIEW_KERNELS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_rev_heun_phase2_reads_views_off_16_byte_boundaries(cuda, dtype, offset, kernel):
    """Contiguous views ``offset`` elements into flat buffers (off a 16-byte
    boundary, as the backward's first ``g_out[N]`` is: the element-a-thread
    path of ``rev_heun_phase2`` and ``rev_heun_bwd_phase1``, the only path of
    the other two) give the bits of contiguous copies and of the plain
    version."""
    n, call = VIEW_KERNELS[kernel]
    g = torch.Generator().manual_seed(offset)
    rows, d = 64, 17
    flat = [torch.randn(rows * d + offset, generator=g, dtype=dtype).to(cuda) for _ in range(n)]
    views = [f[offset:].view(rows, d) for f in flat]
    got = call(None, *views)
    for a, b, c in zip(got, call(None, *(v.clone() for v in views)), call(False, *views)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_dependent_launches_replay_in_a_captured_graph(cuda):
    """fused_mlp -> rev_heun_phase2 -> brownian_increment ->
    space_time_increment -> rev_heun_phase1_gen -> rev_heun_phase1 (sign -1)
    -> rev_heun_bwd_phase1 -> rev_heun_bwd_phase2, each reading an earlier
    stage's output, captured as one CUDA graph replays the eager calls'
    bits."""
    g = torch.Generator().manual_seed(28)
    x = torch.randn(1024, 17, generator=g).to(cuda)
    w1, b1 = torch.randn(17, 32, generator=g).to(cuda), torch.randn(32, generator=g).to(cuda)
    w2, b2 = torch.randn(32, 16, generator=g).to(cuda), torch.randn(16, generator=g).to(cuda)
    keys, (z, mu, mu1, sg, dw, zh, _) = _inputs(cuda, torch.float32, 1024, 16, seed=28)

    def chain():
        sg1 = ops.fused_mlp(x, w1, b1, w2, b2)
        z1 = ops.rev_heun_phase2(z, mu, mu1, sg, sg1, dw, 1 / 32)
        inc = ops.brownian_increment(keys, 3, (16,), torch.float32, 1 / 32)
        w_st, h_st = ops.space_time_increment(keys, 3, (16,), torch.float32, 1 / 32)
        zh1, dw1 = ops.rev_heun_phase1_gen(z1, zh, w_st, inc, keys, 4, 1 / 32, 1 / 32)
        zr = ops.rev_heun_phase1(z1, zh1, mu, sg, dw1, 1 / 32, -1.0)
        seeds = ops.rev_heun_bwd_phase1(zr, mu1, sg1, dw1, 1 / 32)
        return (sg1, z1, inc, w_st, h_st, zh1, dw1, zr, *seeds,
                *ops.rev_heun_bwd_phase2(zr, seeds[0], dw1, 1 / 32))

    want = chain()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = chain()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            assert torch.equal(got, w)


def test_brownian_increment_index_helper_on_both_paths(cuda):
    """The launcher's 32-bit path below rows·d = 2^31 and its 64-bit path at
    and above it split a draw unit into (row, unit) as divmod does, past
    2^31 too (a unit is a counter pair in float32, an element in float64)."""
    from repro_torch.kernels import brownian as bk

    cases = [(torch.float32, 1024, 17, False), (torch.float64, 1024, 17, False),
             (torch.float32, 1, 2 ** 31 - 1, False), (torch.float32, 1, 2 ** 31 + 3, True),
             (torch.float64, 3, 2 ** 30 + 1, True), (torch.float64, 5, 2 ** 31 + 7, True)]
    for dtype, rows, d, wide in cases:
        units = (d + 1) // 2 if dtype == torch.float32 else d
        for u in {0, 1, units - 1, units, rows * units // 2, rows * units - 1}:
            if u >= rows * units:
                continue
            assert bk.increment_unit(dtype, rows, d, u) == (wide, *divmod(u, units))


def test_each_launch_is_counted_once(cuda):
    keys, (z, zh, mu, sg, mu1, sg1, dw) = _inputs(cuda, torch.float32, 4, 16)
    ops.reset_launch_counts()
    ops.rev_heun_phase2(z, mu, mu1, sg, sg1, dw, 0.1)
    ops.rev_heun_phase1_gen(z, zh, mu, sg, keys, 0, 0.1, 0.1)
    ops.brownian_increment(keys, 0, (16,), torch.float32, 0.1)
    ops.brownian_increment(keys, 0, (16,), torch.float32, 0.1, use_kernel=False)
    ops.rev_heun_phase1(z, zh, mu, sg, dw, 0.1, -1.0)
    ops.rev_heun_bwd_phase1(z, zh, mu, dw, 0.1)
    ops.rev_heun_bwd_phase2(z, zh, dw, 0.1)
    ops.rev_heun_bwd_phase2(z, zh, dw, 0.1, use_kernel=False)
    t = torch.rand(4, device=cuda)
    ops.brownian_value(keys, t, 0.0, 1.0, (16,), torch.float32)
    ops.brownian_value(keys, t, 0.0, 1.0, (16,), torch.float32, use_kernel=False)
    ops.space_time_increment(keys, 0, (16,), torch.float32, 0.1)
    ops.space_time_increment(keys, 0, (16,), torch.float32, 0.1, use_kernel=False)
    ops.space_time_value(keys, t, 0.0, 1.0, (16,), torch.float32)
    ops.space_time_value(keys, t, 0.0, 1.0, (16,), torch.float32, use_kernel=False)
    q = torch.rand(1, 2, 5, 16, device=cuda)
    ops.flash_attention(q, q, q)
    ops.flash_attention(q, q, q, use_kernel=False)
    ops.ssd_chunk(q, -q[..., 0], q, q)
    ops.ssd_chunk(q, -q[..., 0], q, q, use_kernel=False)
    w1, b1 = torch.rand(16, 8, device=cuda), torch.rand(8, device=cuda)
    ops.fused_mlp(z, w1, b1, w1.t().contiguous(), z[0])
    ops.fused_mlp(z, w1, b1, w1.t().contiguous(), z[0], use_kernel=False)
    logits = torch.rand(4, 16, device=cuda, requires_grad=True)
    labels = torch.arange(4, device=cuda)
    ops.fused_xent(logits, labels).sum().backward()
    ops.fused_xent(logits, labels, use_kernel=False).sum().backward()
    assert ops.launch_counts() == {"rev_heun_phase1": 1, "rev_heun_phase2": 1,
                                   "rev_heun_bwd_phase1": 1, "rev_heun_bwd_phase2": 1,
                                   "rev_heun_phase1_gen": 1, "brownian_increment": 1,
                                   "brownian_value": 1, "space_time_increment": 1,
                                   "space_time_value": 1, "flash_attention": 1, "ssd_chunk": 1,
                                   "fused_mlp": 1, "fused_mlp_bwd": 0, "fused_xent": 1,
                                   "fused_xent_bwd": 1}


def test_operands_are_checked(cuda):
    keys, (z, zh, mu, sg, mu1, sg1, dw) = _inputs(cuda, torch.float32, 4, 16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rev_heun_phase2(z.t(), mu.t(), mu1.t(), sg.t(), sg1.t(), dw.t(), 0.1)
    with pytest.raises(ValueError, match="does not match"):
        ops.rev_heun_phase2(z, mu.double(), mu1, sg, sg1, dw, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rev_heun_phase2(z, mu.cpu(), mu1, sg, sg1, dw, 0.1)
    with pytest.raises(ValueError, match="does not match"):
        ops.rev_heun_phase1(z, zh, mu, sg, dw[:2], 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rev_heun_bwd_phase1(z.t(), mu.t(), sg.t(), dw.t(), 0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rev_heun_bwd_phase2(z, zh.cpu(), dw, 0.1)
    t = torch.rand(4, device=cuda)
    with pytest.raises(ValueError, match="t must be a contiguous"):
        ops.brownian_value(keys, t.double(), 0.0, 1.0, (16,), torch.float32)
    with pytest.raises(ValueError, match="t must be a contiguous"):
        ops.brownian_value(keys, t[:2], 0.0, 1.0, (16,), torch.float32)
    with pytest.raises(ValueError, match="int64"):
        ops.brownian_value(keys.int(), t, 0.0, 1.0, (16,), torch.float32)


# The redesign's edges: 1000, 1001 and 1024 rows take 4 rows a block (1001
# leaves a last block of one row), fewer rows one row a block and a slice of
# its units; d 1, 5 and 17 leave an odd pair, 8192 = (256, 32) spreads one
# row over 256 blocks; depth 0 draws the root alone, 40 runs two chunks of
# levels (four in float64).
VALUE_CASES = [(1, (64, 17)), (3, (5,))] + [
    (rows, shape) for rows in (1, 3, 64, 1000, 1001, 1024)
    for shape in ((1,), (4,), (17,), (256, 32))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,shape", VALUE_CASES)
@pytest.mark.parametrize("depth", [0, 1, 10, 24, 40])
def test_brownian_value_bitwise_equals_plain_version(cuda, dtype, rows, shape, depth):
    g = torch.Generator().manual_seed(rows + depth)
    keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g, dtype=torch.int64).to(cuda)
    for t in (torch.zeros(rows), torch.ones(rows), torch.full((rows,), 0.375),
              torch.rand(rows, generator=g, dtype=torch.float64)):
        t = t.to(dtype=dtype, device=cuda)
        got = ops.brownian_value(keys, t, 0.0, 1.0, shape, dtype, depth)
        want = ops.brownian_value(keys, t, 0.0, 1.0, shape, dtype, depth, use_kernel=False)
        assert got.shape == (rows, *shape) and torch.equal(got, want)


def test_brownian_value_grid_fills_the_card(cuda):
    """At the serving shape (1024 rows of 4) and the adaptive gradient's
    (one key over (256, 32)) the launch puts blocks on >= 128 SMs; small
    work gets a block per draw unit."""
    from repro_torch.kernels.brownian import brownian_value_blocks

    assert brownian_value_blocks(torch.float32, 1024, 4) >= 128
    assert brownian_value_blocks(torch.float32, 1, 256 * 32) >= 128
    assert brownian_value_blocks(torch.float32, 1, 4) == 2  # two counter pairs
    assert brownian_value_blocks(torch.float64, 3, 5) == 15


def _burst_grad(cuda, dtype, fused):
    x = 32
    params = {"f": nn.mlp_init(torch.Generator().manual_seed(9), [x, 64, x], dtype=dtype,
                               device=cuda)}

    def drift(p, t, y):
        t = torch.as_tensor(t, dtype=y.dtype, device=y.device)
        theta = 0.5 + 30.0 * torch.exp(-(((t - 0.5) / 0.05) ** 2))
        return theta * (1.0 - y) + 0.05 * nn.mlp(p["f"], y, nn.lipswish, torch.tanh)

    bm = BrownianPath(prng.PRNGKey(5, device=cuda), 0.0, 1.0, (64, x), dtype)
    leaves, spec = tree.flatten(params)
    leaves = [v.requires_grad_() for v in leaves]
    z0 = torch.zeros(64, x, dtype=dtype, device=cuda, requires_grad=True)
    zT = solve(drift, lambda p, t, y: 0.05 * torch.ones_like(y), tree.unflatten(spec, leaves),
               z0, bm, 0.0, 1.0, 16, gradient_mode="reversible_adjoint",
               save_trajectory=False, adaptive=True, rtol=2e-3, atol=1e-5, max_steps=2048,
               bridge_depth=10, use_pallas_kernels=fused)
    return zT.detach(), torch.autograd.grad(torch.mean(zT ** 2), [z0, *leaves])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_adaptive_adjoint_equals_unfused_on_the_card(cuda, dtype):
    ops.reset_launch_counts()
    z_f, g_f = _burst_grad(cuda, dtype, True)
    counts = ops.launch_counts()
    z_u, g_u = _burst_grad(cuda, dtype, False)
    assert counts["brownian_value"] > 0 and counts["rev_heun_bwd_phase2"] > 0
    assert torch.isfinite(z_f).all() and torch.equal(z_f, z_u)
    assert all(torch.equal(a, b) for a, b in zip(g_f, g_u))


def test_adaptive_sde_gan_rows_are_padding_invariant_on_the_card(cuda):
    cfg = NeuralSDEConfig(data_dim=1, hidden_dim=16, noise_dim=4, initial_noise_dim=4,
                          width=32, depth=1, num_steps=16)
    params = generator_init(torch.Generator().manual_seed(3), cfg, device=cuda)
    keys = torch.stack(prng.fold_in(5, 6, torch.arange(1024)), -1).to(cuda)
    sampler = make_adaptive_terminal_step(cfg)
    y, conv, st = sampler(params, keys, 1e-2)
    for r in (0, 511, 1023):
        y1, c1, s1 = sampler(params, keys[r:r + 1], 1e-2)
        assert torch.equal(y1[0], y[r]) and bool(c1[0] == conv[r])
        assert int(s1.num_accepted[0]) == int(st.num_accepted[r])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_decode_equals_unfused_on_the_card(cuda, dtype):
    widths = dict(data_dim=2, hidden_dim=16, context_dim=16, width=32, num_steps=6,
                  dtype=dtype)
    params = latent_sde_init(torch.Generator().manual_seed(1), LatentSDEConfig(**widths),
                             device=cuda)
    keys = torch.stack(prng.fold_in(3, 4, torch.arange(37)), -1).to(cuda)
    fused = latent_sde_sample_paths(params, LatentSDEConfig(**widths, use_pallas_kernels=True),
                                    keys)
    unfused = latent_sde_sample_paths(params, LatentSDEConfig(**widths), keys)
    assert fused.shape == (7, 37, 2) and torch.isfinite(fused).all()
    assert torch.equal(fused, unfused)


def test_fused_training_step_equals_unfused_on_the_card(cuda):
    """float64, full widths, batch 64: the fused exact adjoint (five
    kernels) gives the unfused step's parameters bit for bit; one fused step
    launches 46 forward and 115 backward kernels (the reconstruction draws
    its ΔW inside ``rev_heun_phase1_gen``, so ``brownian_increment`` never
    runs), and its fields 286 ``fused_mlp`` launches (98 forward, 188
    backward) and 98 ``fused_mlp_bwd`` (qz0 and zeta, 4 in each of the 23
    local VJPs and 4 in the initial VJP)."""
    widths = dict(data_dim=2, hidden_dim=16, context_dim=16, width=32, num_steps=23,
                  kl_weight=0.1, dtype=torch.float64)
    init, update = make_latent_sde_optimizer(1e-2)
    params = latent_sde_init(torch.Generator().manual_seed(2), LatentSDEConfig(**widths),
                             device=cuda)
    runs = []
    for fused in (False, True):
        step = make_latent_sde_step(LatentSDEConfig(**widths, use_pallas_kernels=fused),
                                    update, 64, 24)
        ops.reset_launch_counts()
        runs.append(step(params, init(params), prng.PRNGKey(3)))
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["rev_heun_phase1_gen"] == 46 and counts["brownian_increment"] == 0
    assert counts["rev_heun_phase1"] == 23 and counts["rev_heun_phase2"] == 46
    assert counts["rev_heun_bwd_phase1"] == 23 and counts["rev_heun_bwd_phase2"] == 23
    assert counts["fused_mlp"] == 286 and counts["fused_mlp_bwd"] == 98
    assert torch.isfinite(runs[1][2]["loss"])
    for a, b in zip(tree.leaves(runs[0][0]), tree.leaves(runs[1][0])):
        assert torch.equal(a, b)


def _terminal_grads(dev, adjoint_mode, solver):
    """float64 terminal-form ELBO gradients at the training widths, batch 16,
    the same parameters and data on either device."""
    from repro_torch.core.sde import latent_sde_loss_terminal
    from repro_torch.data import air_quality_like

    cfg = LatentSDEConfig(data_dim=2, hidden_dim=16, context_dim=16, width=32, num_steps=23,
                          kl_weight=0.1, solver=solver, exact_adjoint=False,
                          dtype=torch.float64)
    params = latent_sde_init(torch.Generator().manual_seed(4), cfg, device=dev)
    key = prng.PRNGKey(5, device=dev)
    ys, _ = air_quality_like(prng.fold_in_key(key, 0), 16, 24, dtype=torch.float64)
    leaves, spec = tree.flatten(params)
    leaves = [x.requires_grad_() for x in leaves]
    loss, _ = latent_sde_loss_terminal(tree.unflatten(spec, leaves), cfg,
                                       prng.fold_in_key(key, 1), ys,
                                       gradient_mode=adjoint_mode)
    return [g.cpu() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("mode,solver", [("continuous_adjoint", "midpoint"),
                                         ("checkpoint", "midpoint"),
                                         ("checkpoint", "reversible_heun")])
def test_baseline_gradients_on_the_card_match_the_cpu(cuda, mode, solver):
    """The backsolve and checkpoint ELBO gradients with the fields through
    ``fused_mlp`` / ``fused_mlp_bwd`` and the draws through
    ``brownian_increment``, against the port's CPU result (plain versions):
    ≤ 1e-9 relative L1 in float64."""
    got, want = _terminal_grads(cuda, mode, solver), _terminal_grads("cpu", mode, solver)
    num = sum((a - b).abs().sum().item() for a, b in zip(got, want))
    assert num / sum(b.abs().sum().item() for b in want) <= 1e-9


def test_bf16_compute_training_step_is_finite_on_the_card(cuda):
    """float32 state, the fields in bfloat16 through the kernels: one fused
    exact-adjoint step launches what the float32 step does and comes out
    finite, its parameters float32."""
    widths = dict(data_dim=2, hidden_dim=16, context_dim=16, width=32, num_steps=23,
                  kl_weight=0.1)
    cfg = LatentSDEConfig(**widths, use_pallas_kernels=True, precision="bf16_compute")
    init, update = make_latent_sde_optimizer(1e-2)
    params = latent_sde_init(torch.Generator().manual_seed(6), cfg, device=cuda)
    ops.reset_launch_counts()
    new, _, metrics = make_latent_sde_step(cfg, update, 64, 24)(params, init(params),
                                                                 prng.PRNGKey(7))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["fused_mlp"] == 286 and counts["fused_mlp_bwd"] == 98
    assert torch.isfinite(metrics["loss"])
    assert all(x.dtype == torch.float32 and torch.isfinite(x).all() for x in tree.leaves(new))


ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
            torch.bfloat16: dict(rtol=6e-2, atol=6e-2)}
# bf16: the largest ‖Δ‖ / ‖want‖ over the (b, h) slices, as chip_smoke.py's
# ATTN_REL_TOL (6e-2 alone exceeds a typical |o| at long S).
ATTN_REL_TOL = 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 10, 2, 200, 128), (1, 8, 1, 65, 64),
                                          (1, 40, 8, 129, 128), (2, 8, 4, 300, 16),
                                          (4, 32, 4, 2048, 64)])
def test_flash_attention_kernel_matches_plain_version(cuda, dtype, B, Hq, Hkv, S, D):
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(B, h, S, D, generator=g).to(cuda, dtype) for h in (Hq, Hkv, Hkv))
    for causal in (True, False):
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal)
        assert ops.launch_counts()["flash_attention"] == 1
        want = ops.flash_attention(q, k, v, causal=causal, scale=1 / math.sqrt(D),
                                   use_kernel=False)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
        if dtype == torch.bfloat16:
            delta = (got.float() - want.float()).flatten(2).norm(dim=-1)
            assert (delta / want.float().flatten(2).norm(dim=-1)).max() <= ATTN_REL_TOL


# chip_smoke.py's ATTN_SHAPES: qwen2.5-14b's prefill and a short prompt, a
# ragged S, tinyllama's group 8 at D 64, S 1 with MQA, a ragged S just past
# one tile, D 16, dbrx-132b's and jamba-v0.1-52b's prefills, tinyllama's
# training shape.
ATTN_SHAPES = [(4, 40, 8, 2048, 128), (4, 40, 8, 32, 128), (1, 40, 8, 1000, 128),
               (2, 32, 4, 777, 64), (1, 4, 1, 1, 128), (1, 40, 8, 129, 128),
               (2, 8, 4, 300, 16), (4, 48, 8, 2048, 128), (4, 32, 8, 2048, 128),
               (4, 32, 4, 2048, 64)]


@pytest.mark.parametrize("B,Hq,Hkv,S,D", ATTN_SHAPES)
def test_f32_flash_attention_at_every_attn_shape(cuda, B, Hq, Hkv, S, D):
    """The split-TF32 float32 kernel, causal and full: within 2e-5 of the
    plain version, two launches bitwise equal, (B, S, H, D) views bitwise
    the contiguous operands' result."""
    q, k, v = _bshd_views(torch.Generator().manual_seed(S + D), cuda, torch.float32, B, Hq,
                          Hkv, S, D)
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))
        assert torch.equal(got, ops.flash_attention(q.contiguous(), k.contiguous(),
                                                    v.contiguous(), causal=causal))
        want = ops.flash_attention(q, k, v, causal=causal, scale=1 / math.sqrt(D),
                                   use_kernel=False)
        torch.testing.assert_close(got, want, **ATTN_TOL[torch.float32])
        del got, want
    torch.cuda.empty_cache()


def _bshd_views(g, cuda, dtype, B, Hq, Hkv, S, D):
    """q, k, v as (B, H, S, D) views of (B, S, H, D) buffers."""
    return tuple(torch.randn(B, S, h, D, generator=g).to(cuda, dtype).transpose(1, 2)
                 for h in (Hq, Hkv, Hkv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 10, 2, 200, 128), (1, 40, 8, 129, 128),
                                          (2, 8, 4, 300, 16)])
def test_flash_attention_two_launches_give_the_same_bits(cuda, dtype, B, Hq, Hkv, S, D):
    q, k, v = _bshd_views(torch.Generator().manual_seed(S), cuda, dtype, B, Hq, Hkv, S, D)
    for causal in (True, False):
        first = ops.flash_attention(q, k, v, causal=causal)
        assert torch.equal(first, ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(2, 10, 2, 200, 128), (1, 40, 8, 129, 128),
                                          (2, 32, 4, 64, 64), (2, 8, 4, 300, 16)])
def test_flash_attention_reads_strided_views_bitwise(cuda, dtype, B, Hq, Hkv, S, D):
    """(B, S, H, D) views give the contiguous operands' bits, the output is
    the (B, Hq, S, D) view of a (B, S, Hq, D) buffer, and a contiguous
    buffer given as ``out`` gets the same bits."""
    q, k, v = _bshd_views(torch.Generator().manual_seed(S), cuda, dtype, B, Hq, Hkv, S, D)
    assert not q.is_contiguous()
    for causal in (True, False):
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal)
        assert torch.equal(got, want)
        assert got.shape == (B, Hq, S, D) and got.transpose(1, 2).is_contiguous()
        out = torch.empty(q.shape, dtype=dtype, device=cuda)
        assert fa_kernel._launch(q, k, v, causal, 1 / math.sqrt(D), out=out) is out
        assert torch.equal(out, got)


# chip_smoke.py's ATTN_ZOO_SHAPES, (B, Hq, Hkv, S, Sk, D, causal): MLA's
# head dim 96 (causal, ragged, full) and a key length of its own (the
# encoder-decoder's cross-attention, full).
ATTN_ZOO_SHAPES = [(2, 40, 40, 512, 512, 96, True), (1, 40, 40, 1000, 1000, 96, True),
                   (2, 40, 40, 300, 300, 96, False), (4, 16, 16, 2048, 1024, 64, False),
                   (2, 16, 16, 300, 1000, 64, False), (2, 40, 40, 300, 1000, 96, False),
                   (2, 4, 4, 12, 10, 16, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,D,causal", ATTN_ZOO_SHAPES)
def test_flash_attention_at_head_dim_96_and_a_key_length(cuda, dtype, B, Hq, Hkv, S, Sk, D,
                                                         causal):
    """Within ATTN_TOL of the plain version (bf16 also by ATTN_REL_TOL a
    (b, h) slice), two launches bitwise equal, (B, S, H, D) views bitwise
    the contiguous operands'."""
    g = torch.Generator().manual_seed(S + Sk + D)
    q = torch.randn(B, S, Hq, D, generator=g).to(cuda, dtype).transpose(1, 2)
    k, v = (torch.randn(B, Sk, Hkv, D, generator=g).to(cuda, dtype).transpose(1, 2)
            for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=causal))
    assert torch.equal(got, ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                                causal=causal))
    want = ops.flash_attention(q, k, v, causal=causal, scale=1 / math.sqrt(D), use_kernel=False)
    torch.cuda.synchronize()
    assert got.shape == (B, Hq, S, D)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        delta = (got.float() - want.float()).flatten(2).norm(dim=-1)
        assert (delta / want.float().flatten(2).norm(dim=-1)).max() <= ATTN_REL_TOL


def test_flash_attention_refuses_causal_with_a_key_length_on_the_card(cuda):
    q = torch.randn(1, 4, 8, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(1, 4, 16, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="key length equal to the query length"):
        fa_kernel._launch(q, k, k, True, 0.125)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "pixtral-12b", "seamless-m4t-medium"])
def test_smoke_zoo_prefills_run_through_the_kernel(cuda, arch):
    """The smoke MLA, VLM and encoder-decoder prefills launch the kernel once
    per attention (the encoder-decoder: each encoder layer once, each decoder
    layer twice), never in decode, and their logits are within 1e-4 of the
    largest of the plain attention's (f32)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import greedy_sample, make_prefill_step, make_serve_step
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = smoke_config(arch)
    params = T.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g, device=cuda)}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.randn(2, 10, cfg.d_model, generator=g, device=cuda)
    elif cfg.frontend:
        batch["embeds"] = torch.randn(2, cfg.frontend_len, cfg.d_model, generator=g, device=cuda)
    pos = 12 + (cfg.frontend_len if "embeds" in batch else 0)
    prefill = make_prefill_step(cfg, max_len=pos + 2)
    ops.reset_launch_counts()
    logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    want = cfg.encoder_layers + 2 * cfg.num_layers if cfg.encoder_layers else cfg.num_layers
    assert ops.launch_counts()["flash_attention"] == want
    make_serve_step(cfg)(params, caches, greedy_sample(logits), pos)
    assert ops.launch_counts()["flash_attention"] == want
    dispatch = L._attend_dispatch
    L._attend_dispatch = lambda cfg_, q, k, v, causal, scale=None: ops.flash_attention(
        q, k, v, causal=causal, scale=scale, use_kernel=False)
    try:
        plain, _ = prefill(params, batch)
    finally:
        L._attend_dispatch = dispatch
    assert (logits - plain).abs().max() <= 1e-4 * plain.abs().max()


def test_smoke_lm_prefill_runs_through_the_kernel(cuda, monkeypatch):
    """Two layers at head dim 16: one launch per layer, and the logits of the
    plain-attention prefill and of the CPU within float32 tolerance."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import layers, transformer

    cfg = smoke_config("qwen2.5-14b")
    params = transformer.init_lm(torch.Generator().manual_seed(0), cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(1))
    prefill = make_prefill_step(cfg, max_len=80)
    ops.reset_launch_counts()
    logits, caches = prefill(params, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers == 2
    cpu_logits, _ = prefill(tree.map(lambda a: a.cpu(), params), {"tokens": tokens})
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=2e-5, atol=2e-5)
    monkeypatch.setattr(layers, "_attend_dispatch", lambda cfg, q, k, v, causal:
                        ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                            causal=causal, use_kernel=False))
    plain, _ = prefill(params, {"tokens": tokens.to(cuda)})
    torch.testing.assert_close(logits, plain, rtol=2e-5, atol=2e-5)
    assert caches[0]["k"].shape == (2, 2, 80, cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b", "jamba-v0.1-52b"])
def test_smoke_moe_and_hybrid_prefills_run_through_the_kernels(cuda, arch):
    """The MoE and hybrid smoke models: flash_attention once per attention
    layer and ssd_chunk once per Mamba2 layer, two prefills bitwise equal
    (the combine has no atomics), the logits of the CPU within 2e-4 (the
    SSD scan's float32 tolerance)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer

    cfg = smoke_config(arch)
    params = transformer.init_lm(torch.Generator().manual_seed(0), cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(1))
    prefill = make_prefill_step(cfg, max_len=80)
    ops.reset_launch_counts()
    logits, caches = prefill(params, {"tokens": tokens.to(cuda)})
    again, caches2 = prefill(params, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    mixers = [m for m, _ in transformer.unit_pattern(cfg)] * transformer.num_units(cfg)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * mixers.count("attn")
    assert counts["ssd_chunk"] == 2 * mixers.count("mamba")
    assert torch.equal(logits, again)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(caches), tree.leaves(caches2)))
    cpu_logits, _ = prefill(tree.map(lambda a: a.cpu(), params), {"tokens": tokens})
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_on_the_card_is_the_cpus_bitwise(cuda, dtype):
    """The combine's gathers, products and fixed-order sums round alike on
    both devices: dbrx's top-4 of 16 experts at B 2 × 300, some slots
    dropped."""
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(7)
    B, S, E, K, D = 2, 300, 16, 4, 64
    C = max(1, int(1.0 * S * K / E))
    w, idx = layers.moe_topk(torch.randn(B, S, E, generator=g), K)
    pos, keep, _ = layers.moe_slots(idx, E, C)
    assert not keep.all()
    ye = torch.randn(E, B * C, D, generator=g).to(dtype)
    want = layers.moe_combine(ye, w.to(dtype), idx, pos, keep, C)
    got = layers.moe_combine(*(t.to(cuda) for t in (ye, w.to(dtype), idx, pos, keep)), C)
    assert torch.equal(got.cpu(), want)


# (B, H, S, P, N, a's scale): the four (N, P) pairs; S ragged, = 1, < the
# chunk (64), = the chunk, one past it; batch 1 at mamba2-1.3b's heads and
# widths (the launcher cuts P into slices); a strong decay (a = −5|N(0, 1)|)
SSD_CASES = [(2, 8, 100, 16, 16, 0.1), (1, 4, 300, 64, 128, 0.1), (2, 3, 1, 64, 16, 0.1),
             (1, 2, 64, 16, 128, 0.1), (2, 3, 33, 16, 128, 0.1), (1, 2, 65, 64, 16, 0.1),
             (1, 64, 200, 64, 128, 0.1), (1, 8, 500, 64, 128, 5.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,P,N,scale", SSD_CASES)
def test_ssd_chunk_kernel_matches_plain_version(cuda, dtype, B, H, S, P, N, scale):
    """x and a as the mixer's transposed views, b expanded over the heads
    (stride 0): y within 2e-4 (f32) / 6e-2 (bf16) of the plain recurrence,
    the state within 2e-4 of its largest, both finite; two launches, the
    contiguous operands and every slice count the launcher takes give the
    same bits."""
    from repro_torch.kernels import ssd_chunk as ssd_kernel

    g = torch.Generator().manual_seed(S)
    x = torch.randn(B, S, H, P, generator=g).to(cuda, dtype).transpose(1, 2)
    a = (-scale * torch.randn(B, S, H, generator=g).abs()).to(cuda).transpose(1, 2)
    b = (0.5 * torch.randn(B, 1, S, N, generator=g)).to(cuda, dtype).expand(B, H, S, N)
    c = (0.5 * torch.randn(B, H, S, N, generator=g)).to(cuda, dtype)
    ops.reset_launch_counts()
    y, h = ops.ssd_chunk(x, a, b, c)
    assert ops.launch_counts()["ssd_chunk"] == 1
    y_ref, h_ref = ops.ssd_chunk(x, a, b, c, use_kernel=False)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape and h.shape == (B, H, N, P)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    tol = 2e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    assert (h - h_ref).abs().max() <= 2e-4 * h_ref.abs().max()
    again = ops.ssd_chunk(x, a, b, c)
    contiguous = ops.ssd_chunk(*(t.contiguous() for t in (x, a, b, c)))
    widest = 32 if dtype == torch.float32 and N == 128 else P
    by_slices = [ssd_kernel._launch(x, a, b, c, slices=n) for n in (1, 2, 4)
                 if 16 <= P // n <= widest]
    for y2, h2 in (again, contiguous, *by_slices):
        assert torch.equal(y2, y) and torch.equal(h2, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_reads_rows_off_16_byte_boundaries(cuda, dtype):
    """x, b and c whose rows start one element past a 16-byte boundary
    (views into wider buffers) take the kernel's plain-load path and give
    the bits of 16-byte-aligned copies."""
    B, H, S, P, N = 1, 4, 150, 64, 128
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, H, S, P + 1, generator=g).to(cuda, dtype)[..., 1:]
    a = -0.1 * torch.randn(B, H, S, generator=g).abs().to(cuda)
    b, c = ((0.5 * torch.randn(B, H, S, N + 1, generator=g)).to(cuda, dtype)[..., 1:]
            for _ in range(2))
    assert x.data_ptr() % 16 and x.stride(-1) == 1
    y, h = ops.ssd_chunk(x, a, b, c)
    y2, h2 = ops.ssd_chunk(x.contiguous(), a, b.contiguous(), c.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    y_ref, _ = ops.ssd_chunk(x, a, b, c, use_kernel=False)
    tol = 2e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)


def test_ssd_chunk_grid_fills_the_card_at_batch_1(cuda):
    """mamba2-1.3b's 64 heads at batch 1 give at least 128 blocks (one
    (batch, head, P slice) each); at batch 4 the 256 (batch, head) blocks are
    not cut."""
    from repro_torch.kernels import ssd_chunk as ssd_kernel

    assert 64 * ssd_kernel.slices(torch.bfloat16, 128, 64, 64) >= 128
    assert ssd_kernel.slices(torch.bfloat16, 128, 64, 256) == 1


def test_smoke_mamba2_prefill_runs_through_the_kernel(cuda, monkeypatch):
    """Two Mamba2 layers (H 8, P 16, N 16): one launch per layer, none per
    decode step, and the logits of the plain-scan prefill and of the CPU
    within float32 tolerance."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import greedy_sample, make_prefill_step, make_serve_step
    from repro_torch.models import layers, transformer

    cfg = smoke_config("mamba2-1.3b")
    params = transformer.init_lm(torch.Generator().manual_seed(0), cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 77), generator=torch.Generator().manual_seed(1))
    prefill = make_prefill_step(cfg, max_len=80)
    ops.reset_launch_counts()
    logits, caches = prefill(params, {"tokens": tokens.to(cuda)})
    make_serve_step(cfg)(params, caches, greedy_sample(logits), 77)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_chunk"] == cfg.num_layers == 2
    cpu_logits, _ = prefill(tree.map(lambda a: a.cpu(), params), {"tokens": tokens})
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=2e-4, atol=2e-4)
    monkeypatch.setattr(layers, "_ssd_dispatch", lambda x, a, b, c:
                        ops.ssd_chunk(x, a, b, c, use_kernel=False))
    plain, _ = prefill(params, {"tokens": tokens.to(cuda)})
    torch.testing.assert_close(logits, plain, rtol=2e-4, atol=2e-4)


MLP_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
           torch.bfloat16: dict(rtol=6e-2, atol=6e-2),
           torch.float64: dict(rtol=1e-12, atol=1e-12)}
# (Din, H, Dout): the SDE fields (ELBO, SDE-GAN sigma, the burst, the
# discriminator's xi and g), the JAX suite's 96 -> 48 -> 24, and a 512-wide
# MLP (weights read through L2).
MLP_WIDTHS = [(17, 32, 16), (33, 32, 16), (8, 32, 16), (17, 32, 64), (32, 64, 32),
              (2, 32, 16), (17, 32, 32), (96, 48, 24), (512, 512, 512)]


def _mlp_operands(cuda, dtype, rows, din, h, dout, seed=0):
    """x ~ N(0, 1), W ~ N(0, 1/fan_in) (nn.mlp_init's scale: a 512-wide
    layer's sums stay O(1)), b ~ 0.1·N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, din, generator=g, dtype=torch.float64)
    ws = [torch.randn(*s, generator=g, dtype=torch.float64) * f
          for s, f in (((din, h), din ** -0.5), ((h,), 0.1), ((h, dout), h ** -0.5),
                       ((dout,), 0.1))]
    return [t.to(cuda, dtype) for t in (x, *ws)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("din,h,dout", MLP_WIDTHS)
def test_fused_mlp_kernel_matches_plain_version(cuda, dtype, din, h, dout):
    ops.reset_launch_counts()
    x, *w = _mlp_operands(cuda, dtype, 300, din, h, dout)
    got = ops.fused_mlp(x, *w)
    assert ops.launch_counts()["fused_mlp"] == 1
    want = ops.fused_mlp(x, *w, use_kernel=False)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (300, dout)
    torch.testing.assert_close(got, want, **MLP_TOL[dtype])


# every width chip_smoke.py checks (its MLP_SHAPES): the fixed-width
# instantiations of csrc/fused_mlp.cu and the runtime-width kernel
MLP_ALL_WIDTHS = MLP_WIDTHS + [(16, 32, 16), (4, 32, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("din,h,dout", MLP_ALL_WIDTHS)
def test_fused_mlp_rows_are_invariant(cuda, dtype, din, h, dout):
    """A row's bits whatever the rows launched with it: 1 vs 1000 vs 1024."""
    x, *w = _mlp_operands(cuda, dtype, 1024, din, h, dout, seed=1)
    full = ops.fused_mlp(x, *w)
    part = ops.fused_mlp(x[:1000].contiguous(), *w)
    assert torch.equal(part, full[:1000])
    for r in (0, 517, 999, 1023):
        assert torch.equal(ops.fused_mlp(x[r:r + 1].contiguous(), *w)[0], full[r])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("din,h,dout", MLP_ALL_WIDTHS)
def test_fused_mlp_two_launches_give_the_same_bits(cuda, dtype, din, h, dout):
    """Two launches alike, and a row whose x starts off a 16-byte boundary
    (the kernel's element copies) bitwise the aligned launch's row."""
    x, *w = _mlp_operands(cuda, dtype, 300, din, h, dout, seed=2)
    ops.reset_launch_counts()
    first = ops.fused_mlp(x, *w)
    assert torch.equal(ops.fused_mlp(x, *w), first)
    assert ops.launch_counts()["fused_mlp"] == 2
    shifted = ops.fused_mlp(x[1:], *w)  # a contiguous view one row in
    assert torch.equal(shifted, first[1:])


def test_depth1_fields_run_through_the_kernel(cuda):
    params = nn.mlp_init(torch.Generator().manual_seed(4), [17, 32, 16], device=cuda)
    deep = nn.mlp_init(torch.Generator().manual_seed(4), [17, 32, 32, 16], device=cuda)
    x = torch.randn(64, 17, device=cuda)
    ops.reset_launch_counts()
    y = nn.mlp(params, x, nn.lipswish, torch.tanh)
    nn.mlp(deep, x)
    nn.mlp(params, x, nn.silu)
    assert ops.launch_counts()["fused_mlp"] == 1
    (l1, l2) = params["layers"]
    assert torch.equal(y, torch.tanh(ops.fused_mlp(x, l1["w"], l1["b"], l2["w"], l2["b"])))


# The backward kernel's rows: one block, the ELBO batch, a ragged count, the
# 1024-row bucket, several tiles a block.  Its float32 dW and db are sums of
# R terms, which round by ~sqrt(R)·eps of the partial sums: they are held
# within MLP_TOL of their largest magnitude as well (chip_smoke.py MLP_TOL
# has the reasoning).
MLP_BWD_ROWS = [1, 64, 300, 1024, 4096]


def _mlp_bwd_operands(cuda, dtype, rows, din, h, dout, seed=0):
    x, *w = _mlp_operands(cuda, dtype, rows, din, h, dout, seed)
    g = torch.randn(rows, dout, generator=torch.Generator().manual_seed(seed + 1),
                    dtype=torch.float64).to(cuda, dtype)
    return x, w, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("din,h,dout", MLP_WIDTHS)
@pytest.mark.parametrize("rows", MLP_BWD_ROWS)
def test_fused_mlp_backward_kernel_matches_plain_version(cuda, dtype, din, h, dout, rows):
    from repro_torch.kernels import fused_mlp as fm, ref

    x, w, g = _mlp_bwd_operands(cuda, dtype, rows, din, h, dout)
    ops.reset_launch_counts()
    got = fm._launch_bwd(x, *w, g)
    assert ops.launch_counts()["fused_mlp_bwd"] == 1
    want = ref.fused_mlp_bwd(x, *w, g)
    torch.cuda.synchronize()
    for name, a, b, t in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want, (x, *w)):
        assert a.dtype == dtype and a.shape == t.shape and torch.isfinite(a).all()
        tol = dict(MLP_TOL[dtype])
        if dtype == torch.float32 and name != "dx":  # sums over R rows: chip_smoke.MLP_TOL
            tol["atol"] = max(tol["atol"], tol["atol"] * b.abs().max().item())
        torch.testing.assert_close(a, b, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("din,h,dout", [(17, 32, 16), (32, 64, 32), (512, 512, 512)])
def test_fused_mlp_backward_is_deterministic_and_dx_rows_invariant(cuda, dtype, din, h, dout):
    """Two launches give the same bits (no atomics in any sum: the cluster
    adds the blocks' sums in ascending rank), and a row's dx is the same
    whether 1, 1000 or 1024 rows are launched; an expanded cotangent gives
    its contiguous copy's bits."""
    from repro_torch.kernels import fused_mlp as fm

    x, w, g = _mlp_bwd_operands(cuda, dtype, 1024, din, h, dout, seed=1)
    full = fm._launch_bwd(x, *w, g)
    assert all(torch.equal(a, b) for a, b in zip(full, fm._launch_bwd(x, *w, g)))
    assert torch.equal(fm._launch_bwd(x[:1000].contiguous(), *w, g[:1000].contiguous())[0],
                       full[0][:1000])
    for r in (0, 517, 1023):
        one = fm._launch_bwd(x[r:r + 1].contiguous(), *w, g[r:r + 1].contiguous())
        assert torch.equal(one[0][0], full[0][r])
    ge = g[:1].expand(1024, dout)
    assert all(torch.equal(a, b) for a, b in zip(fm._launch_bwd(x, *w, ge),
                                                 fm._launch_bwd(x, *w, ge.contiguous())))


@pytest.mark.parametrize("code", [0, 1, 2])
def test_fused_mlp_backward_plan_is_the_mirror_and_the_cluster_schedules(cuda, code):
    """The library's plan (``fused_mlp.bwd_plan``, from ``rt_fused_mlp_bwd_plan``)
    is its mirror's (``_fused_mlp_plan.bwd_plan``, which the CPU tests use)
    at every width and row count of the checks, and the card holds at least
    one cluster of the launch (``cudaOccupancyMaxActiveClusters``)."""
    from _fused_mlp_plan import bwd_plan as mirror
    from repro_torch.kernels import build, fused_mlp as fm

    lib = build.load()
    for din, h, dout in MLP_WIDTHS:
        for rows in MLP_BWD_ROWS:
            assert fm.bwd_plan(code, rows, din, h, dout) == mirror(code, rows, din, h, dout), (
                din, h, dout, rows)
            assert lib.rt_fused_mlp_bwd_clusters(code, rows, din, h, dout) >= 1


def test_fused_mlp_backward_is_one_launch_and_none_under_create_graph(cuda):
    x, w, _ = _mlp_bwd_operands(cuda, torch.float32, 64, 17, 32, 16)
    leaves = [t.requires_grad_() for t in (x, *w)]
    ops.reset_launch_counts()
    ops.fused_mlp(*leaves).sum().backward()
    assert ops.launch_counts()["fused_mlp"] == ops.launch_counts()["fused_mlp_bwd"] == 1
    ops.reset_launch_counts()
    gx, = torch.autograd.grad(ops.fused_mlp(*leaves).sum(), leaves[0], create_graph=True)
    (gx ** 2).sum().backward()
    assert ops.launch_counts()["fused_mlp"] == 1 and ops.launch_counts()["fused_mlp_bwd"] == 0
    ops.reset_launch_counts()
    with torch.no_grad():
        assert ops.fused_mlp(*leaves).grad_fn is None
    assert ops.launch_counts()["fused_mlp"] == 1


def _linear_loss_grads(fn, inputs, seed):
    """Gradients of sum(c·out) for fixed random c, for every output."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=leaves[0].device).manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=g, device=o.device, dtype=o.dtype)).sum()
               for o in outs)
    return torch.autograd.grad(loss, leaves)


def test_kernel_gradients_match_plain_path_attention_ssd_bitwise_mlp_within_tol(cuda):
    """For a loss linear in the outputs the cotangents do not depend on the
    forward's bits, so the attention's and the SSD scan's gradients (the
    plain versions' VJPs at the same inputs) equal the plain path's bit for
    bit; fused_mlp's come from its backward kernel, which sums in its own
    order, so they are held within MLP_TOL (float64 here: 1e-12)."""
    mlp = _mlp_operands(cuda, torch.float64, 64, 17, 32, 16)
    g = torch.Generator().manual_seed(2)
    qkv = [torch.randn(2, h, 70, 64, generator=g).to(cuda) for h in (8, 2, 2)]
    x = torch.randn(2, 70, 4, 16, generator=g).to(cuda).transpose(1, 2)
    a = (-0.1 * torch.randn(2, 70, 4, generator=g).abs()).to(cuda).transpose(1, 2)
    bc = [(0.5 * torch.randn(2, 70, 16, generator=g)).to(cuda)[:, None].expand(2, 4, 70, 16)
          for _ in range(2)]
    cases = [(ops.fused_mlp, mlp, "fused_mlp"),
             (ops.flash_attention, qkv, "flash_attention"),
             (ops.ssd_chunk, [x, a, *bc], "ssd_chunk")]
    for fn, inputs, name in cases:
        ops.reset_launch_counts()
        got = _linear_loss_grads(fn, inputs, 3)
        assert ops.launch_counts()[name] == 1
        want = _linear_loss_grads(lambda *t: fn(*t, use_kernel=False), inputs, 3)
        assert all(gr is not None for gr in got), name
        if name == "fused_mlp":
            for gr, w in zip(got, want):
                torch.testing.assert_close(gr, w, **MLP_TOL[torch.float64])
        else:
            assert all(torch.equal(gr, w) for gr, w in zip(got, want)), name


def test_sde_gan_clip_step_matches_plain_fields(cuda, monkeypatch):
    """One SDE-GAN clip step's gradients (8 solver steps, 9 observations,
    batch 16, float64) with the fields through fused_mlp and its backward
    kernel against the same gradients on the layer loop, within MLP_TOL
    (1e-12); the launches are chip_smoke.py's GAN_STEP_LAUNCHES formula at
    N = T = 8; one pull of both players' gradients equals the two pulls."""
    from _gan_pulls import two_pull_grads
    from repro_torch.core.sde import discriminator_init
    from repro_torch.data import ou_process
    from repro_torch.launch.steps import sde_gan_grads
    from repro_torch.nn import core as nn_core

    cfg = NeuralSDEConfig(num_steps=8, dtype=torch.float64)
    g = torch.Generator().manual_seed(5)
    params = {"gen": generator_init(g, cfg, device=cuda),
              "disc": discriminator_init(g, cfg, device=cuda)}
    key = prng.PRNGKey(6, device=cuda)
    y_real = ou_process(prng.fold_in_key(key, 0), 16, 9, dtype=torch.float64)
    ops.reset_launch_counts()
    got = sde_gan_grads(params, cfg, prng.fold_in_key(key, 1), y_real, 16)
    counts = ops.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "fused_mlp": 185, "fused_mlp_bwd": 66,
                      "brownian_increment": 16}
    two = two_pull_grads(params, cfg, prng.fold_in_key(key, 1), y_real, 16)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got), tree.leaves(two)))
    monkeypatch.setattr(nn_core, "_mlp_dispatch",
                        lambda layers, x: nn_core._mlp_layers(layers, x, nn.lipswish))
    want = sde_gan_grads(params, cfg, prng.fold_in_key(key, 1), y_real, 16)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        torch.testing.assert_close(a, b, **MLP_TOL[torch.float64])


XENT_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,V", [(64, 1024), (32, 1000), (1, 7), (9, 1), (300, 50280)])
def test_fused_xent_kernels_match_plain_versions(cuda, dtype, R, V):
    from repro_torch.kernels import ref, xent

    g = torch.Generator().manual_seed(R + V)
    x = (3 * torch.randn(R, V, generator=g)).to(dtype).to(cuda)
    lab = torch.randint(0, V, (R,), generator=g).to(cuda)
    cot = torch.randn(R, generator=g).to(cuda)
    ops.reset_launch_counts()
    loss, lse = xent.launch_fwd(x, lab)
    dx = xent.launch_bwd(x, lab, lse, cot)
    assert ops.launch_counts()["fused_xent"] == ops.launch_counts()["fused_xent_bwd"] == 1
    want_loss, want_lse = ref.fused_xent_fwd(x, lab)
    tol = XENT_TOL[dtype]
    assert torch.allclose(loss, want_loss, rtol=tol, atol=tol)
    assert torch.allclose(lse, want_lse, rtol=tol, atol=tol)
    want_dx = ref.fused_xent_bwd(x, lab, lse, cot)
    assert dx.dtype == dtype and dx.shape == x.shape
    if dtype == torch.float32:
        assert torch.allclose(dx, want_dx, rtol=1e-5, atol=1e-5)
    else:  # the same f32 value rounded: at most one bf16 ulp apart
        ulp = torch.finfo(torch.bfloat16).eps * want_dx.float().abs().clamp_min(2 ** -126)
        assert ((dx.float() - want_dx.float()).abs() <= ulp).all()
    one, _ = xent.launch_fwd(x[-1:].contiguous(), lab[-1:])
    assert torch.equal(one, loss[-1:])  # rows invariant


def test_fused_xent_node_and_lm_training_step(cuda):
    from repro_torch import configs
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import transformer as T

    cfg = configs.smoke_config("tinyllama-1.1b")
    params = T.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 33), device=cuda, dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    init, update = make_optimizer(cfg)
    ops.reset_launch_counts()
    _, _, m = make_train_step(cfg, update)(params, init(params), batch)
    counts = ops.launch_counts()
    assert counts["fused_xent"] == counts["fused_xent_bwd"] == 1
    logits, _ = T.lm_forward(params, cfg, batch["tokens"])
    want = T.softmax_xent(logits, batch["labels"])
    assert torch.allclose(m["xent"], want, rtol=1e-5)


# -----------------------------------------------------------------------------
# the srk solver's space-time draws (the port's own kernels)
# -----------------------------------------------------------------------------

# one key over the srk ELBO's draws at B 64 and 1024 and over an odd width
# (the last counter pair's zero pad), the adaptive srk gradient's (256, 32),
# and a key a row
ST_CASES = [(1, (64, 17)), (1, (256, 32)), (1, (1024, 17)), (1, (1087,))] + [
    (rows, shape) for rows in (1, 64, 1000, 1024) for shape in ((1,), (8,), (17,))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,shape", ST_CASES)
def test_space_time_increment_bitwise_equals_plain_version(cuda, dtype, rows, shape):
    """Bitwise the plain version, two launches alike, and at 1024 rows a
    row's bits the same alone."""
    g = torch.Generator().manual_seed(rows)
    keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g, dtype=torch.int64).to(cuda)
    got = ops.space_time_increment(keys, 9, shape, dtype, 1.0 / 23)
    want = ops.space_time_increment(keys, 9, shape, dtype, 1.0 / 23, use_kernel=False)
    assert all(a.shape == (rows, *shape) and torch.equal(a, b) for a, b in zip(got, want))
    again = ops.space_time_increment(keys, 9, shape, dtype, 1.0 / 23)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if rows == 1024:
        one = ops.space_time_increment(keys[5:6].contiguous(), 9, shape, dtype, 1.0 / 23)
        assert all(torch.equal(a[0], b[5]) for a, b in zip(one, got))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,shape", ST_CASES)
@pytest.mark.parametrize("depth", [0, 1, 10, 24])
def test_space_time_value_bitwise_equals_plain_version(cuda, dtype, rows, shape, depth):
    g = torch.Generator().manual_seed(rows + depth)
    keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g, dtype=torch.int64).to(cuda)
    for t in (torch.zeros(rows), torch.ones(rows), torch.full((rows,), 0.375),
              torch.rand(rows, generator=g, dtype=torch.float64)):
        t = t.to(dtype=dtype, device=cuda)
        got = ops.space_time_value(keys, t, 0.0, 1.0, shape, dtype, depth)
        want = ops.space_time_value(keys, t, 0.0, 1.0, shape, dtype, depth, use_kernel=False)
        assert all(a.shape == (rows, *shape) and torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,shape", [(1, (256, 32)), (1024, (32,))])
@pytest.mark.parametrize("depth", [100, 512])
def test_space_time_value_bitwise_past_its_ring_of_levels(cuda, dtype, rows, shape, depth):
    """Depths past the kernel's ring of 16 levels (the walker waits for the
    combiner to free a slot): bitwise the plain version, two launches
    alike, a row's bits the same alone and among 1024.  A
    float32 descent from t0 past ~150 levels divides by an interval length
    that underflowed to 0, in the plain version as in the kernel: NaN
    counts as equal to NaN at the same places."""
    def alike(got, want):
        return all(torch.equal(a.isnan(), b.isnan()) and torch.equal(a[~a.isnan()], b[~a.isnan()])
                   for a, b in zip(got, want))

    g = torch.Generator().manual_seed(rows + depth)
    keys = torch.randint(0, 2 ** 32, (rows, 2), generator=g, dtype=torch.int64).to(cuda)
    t = torch.rand(rows, generator=g, dtype=torch.float64)
    t[: min(rows, 3)] = torch.tensor([0.0, 1.0, 0.375])[: min(rows, 3)]
    t = t.to(dtype=dtype, device=cuda)
    got = ops.space_time_value(keys, t, 0.0, 1.0, shape, dtype, depth)
    want = ops.space_time_value(keys, t, 0.0, 1.0, shape, dtype, depth, use_kernel=False)
    assert all(a.shape == (rows, *shape) for a in got) and alike(got, want)
    assert alike(ops.space_time_value(keys, t, 0.0, 1.0, shape, dtype, depth), got)
    r = rows - 1
    one = ops.space_time_value(keys[r:].contiguous(), t[r:].contiguous(), 0.0, 1.0, shape,
                               dtype, depth)
    assert alike([a[0] for a in one], [b[r] for b in got])


def test_space_time_kernels_are_counted_and_refuse_bad_operands(cuda):
    from repro_torch.kernels import brownian as bk

    keys = torch.zeros(3, 2, dtype=torch.int64, device=cuda)
    t = torch.zeros(3, device=cuda)
    ops.reset_launch_counts()
    ops.space_time_increment(keys, 0, (4,), torch.float32, 0.1)
    ops.space_time_value(keys, t, 0.0, 1.0, (4,), torch.float32, 10)
    counts = ops.launch_counts()
    assert counts["space_time_increment"] == counts["space_time_value"] == 1
    with pytest.raises(ValueError, match="depth"):
        bk.space_time_value(keys, t, 0.0, 1.0, (4,), torch.float32, bk.SPACE_TIME_MAX_DEPTH + 1)
    with pytest.raises(ValueError, match="t must be"):
        bk.space_time_value(keys, t.double(), 0.0, 1.0, (4,), torch.float32, 10)
    with pytest.raises(ValueError, match="CUDA"):
        bk.space_time_increment(keys.cpu(), 0, (4,), torch.float32, 0.1)


def test_srk_elbo_gradients_on_the_card_match_the_cpu(cuda):
    """The srk checkpoint ELBO gradient with the fields through the MLP
    kernels and the draws through ``space_time_increment``, against the
    port's CPU result: ≤ 1e-9 relative L1 in float64; no other Brownian
    kernel launches."""
    ops.reset_launch_counts()
    got = _terminal_grads(cuda, "checkpoint", "srk")
    counts = ops.launch_counts()
    want = _terminal_grads("cpu", "checkpoint", "srk")
    num = sum((a - b).abs().sum().item() for a, b in zip(got, want))
    assert num / sum(b.abs().sum().item() for b in want) <= 1e-9
    assert counts["space_time_increment"] > 0
    assert counts["brownian_increment"] == counts["brownian_value"] == 0


def _chunk_case(cuda, bucket, seed=40):
    """The scheduler's chunk step at GAN widths (32 steps in 4 chunks) on
    ``bucket`` rows at mixed chunk positions, and its inputs."""
    from repro_torch.core.sde import generator_initial_state, generator_rollout_chunk
    from repro_torch.serving.scheduler import _keys

    cfg = NeuralSDEConfig(data_dim=1, hidden_dim=16, noise_dim=4, width=32, num_steps=32)
    params = generator_init(torch.Generator().manual_seed(seed), cfg, device=cuda)
    keys = _keys([seed] * bucket, range(bucket), cuda, chunks=[i % 4 for i in range(bucket)])
    x0 = generator_initial_state(params, cfg, keys)
    ts = torch.tensor([(i % 4) * 0.25 for i in range(bucket)]).to(cuda)

    def step(k, x, t):
        with torch.no_grad():
            return generator_rollout_chunk(params, cfg, k, x, t, 0.25, 8)

    return step, (keys, x0, ts)


@pytest.mark.parametrize("bucket", [1, 64, 1024])
def test_chunk_graph_replay_bitwise_equals_the_eager_chunk(cuda, bucket):
    """A captured chunk replays the eager chunk's bits, counts the kernels
    it recorded, and each replay adds them to the registry's counter."""
    import collections

    from repro_torch.serving.registry import CapturedGraph

    step, args = _chunk_case(cuda, bucket)
    want = step(*args)
    graph = CapturedGraph(step, args)
    graph.counter = collections.Counter()
    got = graph(*args)
    again = graph(*args)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)
    # 8 steps: one ΔW each; the fields at t0 and once a step, drift and diffusion
    assert graph.launches["brownian_increment"] == 8 and graph.launches["fused_mlp"] == 18
    assert graph.counter["brownian_increment"] == 16 and graph.nbytes > 0
    graph.release()


def test_eviction_frees_the_graphs_bytes_and_a_rebuild_gives_its_bits(cuda):
    from repro_torch.serving import LoadedModel, ModelRegistry
    from repro_torch.serving.registry import CapturedGraph

    big_step, big = _chunk_case(cuda, 1024)
    small_step, small = _chunk_case(cuda, 64)
    reg = ModelRegistry()
    cfg = NeuralSDEConfig(data_dim=1, hidden_dim=16, noise_dim=4, width=32, num_steps=32)
    reg.register(LoadedModel("default", "sde-gan", cfg, {}))
    a = reg.compiled("default", "chunk", 1024, lambda: CapturedGraph(big_step, big))
    want = a(*big)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    reg.pool_budget_bytes = a.nbytes
    b = reg.compiled("default", "chunk", 64, lambda: CapturedGraph(small_step, small))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the evicted pool's segments go back here
    assert reg.evictions == 1 and reg.pool_keys() == (("default", "chunk", 64),)
    assert before + b.nbytes - torch.cuda.memory_reserved() >= a.nbytes
    rebuilt = reg.compiled("default", "chunk", 1024, lambda: CapturedGraph(big_step, big))
    for g, w in zip(rebuilt(*big), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,ranks", [(1024, 17, 2), (1024, 17, 3), (1024, 4, 2),
                                          (7, 3, 2), (5, 1, 3)])
def test_row_windowed_draws_are_the_whole_launch_bitwise(cuda, dtype, rows, d, ranks):
    """Rows 5, 7 and 12 with a data-parallel rank's element window: each
    window bitwise its plain version, the windows concatenated bitwise the
    whole launch, and each window counted as a windowed launch."""
    from repro_torch.kernels import brownian as bk

    key = prng.PRNGKey(rows + d, device=cuda)
    g = torch.Generator().manual_seed(rows * d)
    st = [torch.randn(rows, d, generator=g, dtype=dtype).to(cuda) for _ in range(4)]
    calls = {
        "brownian_increment": lambda w, sl, uk: (ops.brownian_increment(
            key, 5, (sl.stop - sl.start, d), dtype, 0.1, use_kernel=uk, window=w),),
        "rev_heun_phase1_gen": lambda w, sl, uk: ops.rev_heun_phase1_gen(
            *(t[sl] for t in st), key, 5, 0.1, 0.1, -1.0, use_kernel=uk, window=w),
        "space_time_increment": lambda w, sl, uk: ops.space_time_increment(
            key, 5, (sl.stop - sl.start, d), dtype, 0.1, use_kernel=uk, window=w),
    }
    bounds = [rows * r // ranks for r in range(ranks + 1)]
    for name, call in calls.items():
        whole = call(None, slice(0, rows), True)
        before = bk.WINDOW_LAUNCHES[name]
        parts = []
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            got = call((r0 * d, rows * d), slice(r0, r1), True)
            want = call((r0 * d, rows * d), slice(r0, r1), False)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (name, r0)
            parts.append(got)
        assert bk.WINDOW_LAUNCHES[name] - before == ranks
        for i, w in enumerate(whole):
            assert torch.equal(torch.cat([p[i] for p in parts]), w), name
