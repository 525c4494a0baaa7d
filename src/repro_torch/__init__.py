"""repro_torch — the PyTorch/CUDA port of :mod:`repro`, slice by slice.

Every module mirrors the JAX package's layout and names its counterpart,
which stays the reference it is held against (tests/test_torch_*.py).
The port imports ``torch`` and numpy only: nothing of JAX and nothing of
``repro``.

What is ported so far — Latent-SDE ELBO training (the exact reversible
adjoint), SDE-GAN training, the paper's baselines (euler, midpoint, heun,
the backsolve, checkpointing, bf16 fields), the srk solver on space-time
Lévy-area paths, the whole Brownian layer (the counter-based path, the
Dense path, the Virtual Brownian Tree, the host Brownian Interval), the
prior-decode serving path, adaptive stepping (the PI
controller loop, the exact adjoint over the accepted grid, the SDE-GAN generator's
fixed-grid and adaptive terminal services), LM serving of the dense
family (prefill through the GQA attention kernel) and the pure-SSM
family (prefill through the SSD chunk-scan kernel), with greedy decode,
LM training (AdamW, the loss through the cross-entropy kernels,
resumable checkpoints), and data-parallel Neural-SDE training and serving
on ``torch.distributed``:

=====================================  ======================================
port module                            reference
=====================================  ======================================
repro_torch.kernels.prng               repro.kernels.prng (+ ``split``,
                                       ``randint``)
repro_torch.kernels.ref                repro.kernels.ref (plain versions)
repro_torch.kernels.csrc/*             the Pallas kernels rev_heun_phase1,
                                       rev_heun_phase2, rev_heun_bwd_phase1,
                                       rev_heun_bwd_phase2, rev_heun_phase1_gen,
                                       brownian_increment, brownian_value,
                                       fused_mlp, flash_attention, ssd_chunk,
                                       fused_xent (+ its backward); and the
                                       port's own space_time_increment and
                                       space_time_value (srk's draws)
repro_torch.kernels.ops                repro.kernels.ops (dispatch)
repro_torch.nn.core                    repro.nn.core (MLP pieces, GRU,
                                       rmsnorm, layernorm, gelu, softplus)
repro_torch.configs                    repro.configs (ArchConfig; the dense
                                       qwen2.5-14b, tinyllama-1.1b,
                                       starcoder2-3b; the MoE dbrx-132b,
                                       grok-1-314b; the SSM mamba2-1.3b;
                                       the hybrid jamba-v0.1-52b)
repro_torch.models                     repro.models (layers, transformer,
                                       counting: the dense, MoE, SSM and
                                       hybrid families' prefill, decode
                                       and training loss)
repro_torch.core.brownian              repro.core.brownian (BrownianPath
                                       in both levy_area modes,
                                       DenseBrownianPath,
                                       VirtualBrownianTree, the space-time
                                       Lévy area, Davie's approximation)
repro_torch.core.brownian_interval     repro.core.brownian_interval
                                       (BrownianInterval,
                                       HostVirtualBrownianTree)
repro_torch.core.solvers               repro.core.solvers (reversible Heun,
                                       euler, midpoint, heun, srk)
repro_torch.core.gradients             repro.core.gradients (exact adjoint
                                       as autograd Functions, fixed grid and
                                       adaptive; discretise)
repro_torch.core.solve                 repro.core.solve (fixed grid and
                                       adaptive)
repro_torch.core.sde                   repro.core.sde (Latent SDE: ELBO and
                                       prior decode; SDE-GAN generator
                                       samplers)
repro_torch.data                       repro.data.synthetic (air quality,
                                       LM token batches)
repro_torch.optim                      repro.optim (Adam, AdamW, clipping,
                                       the cosine schedule, int8
                                       error-feedback compression)
repro_torch.distributed                repro.distributed (compat: meshes
                                       and the rank launcher; sharding:
                                       rule tables, data-parallel
                                       collectives; elastic: the planner)
repro_torch.tree                       jax.tree (flatten, map)
repro_torch.checkpoint                 repro.checkpoint (training
                                       checkpoints, serving bundles)
repro_torch.serving / launch           repro.serving / repro.launch (drain
                                       loops incl. adaptive terminal
                                       sampling, serve and train CLIs, step
                                       factories, serve_lm, the production
                                       mesh)
=====================================  ======================================

ROADMAP.md lists what is still to port, in order.
"""

from .device import NoCudaDeviceError, resolve_device  # noqa: F401
from .core.solve import (  # noqa: F401
    SOLVERS,
    AdaptiveStats,
    SolverSpec,
    available_solvers,
    gradient_capabilities,
    solve,
    solve_adaptive,
    solve_batched,
)

__version__ = "0.1.0"
