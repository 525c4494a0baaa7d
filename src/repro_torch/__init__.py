"""repro_torch — the PyTorch/CUDA port of :mod:`repro`, slice by slice.

Every module mirrors the JAX package's layout and names its counterpart,
which stays the reference it is held against (tests/test_torch_*.py).
The port imports ``torch`` and numpy only: nothing of JAX and nothing of
``repro``.

What is ported so far — Latent-SDE ELBO training (the exact reversible
adjoint) and the prior-decode serving path:

=====================================  ======================================
port module                            reference
=====================================  ======================================
repro_torch.kernels.prng               repro.kernels.prng (+ ``split``,
                                       ``randint``)
repro_torch.kernels.ref                repro.kernels.ref (plain versions)
repro_torch.kernels.csrc/*             the Pallas kernels rev_heun_phase1,
                                       rev_heun_phase2, rev_heun_bwd_phase1,
                                       rev_heun_bwd_phase2, rev_heun_phase1_gen,
                                       brownian_increment
repro_torch.kernels.ops                repro.kernels.ops (dispatch)
repro_torch.nn.core                    repro.nn.core (MLP pieces, GRU)
repro_torch.core.brownian              repro.core.brownian (BrownianPath,
                                       fixed-grid increments)
repro_torch.core.solvers               repro.core.solvers (reversible Heun,
                                       forward and reverse step)
repro_torch.core.gradients             repro.core.gradients (exact adjoint
                                       as an autograd Function, discretise)
repro_torch.core.solve                 repro.core.solve (fixed grid)
repro_torch.core.sde                   repro.core.sde (Latent SDE: ELBO and
                                       prior decode)
repro_torch.data                       repro.data.synthetic (air quality)
repro_torch.optim                      repro.optim (Adam)
repro_torch.tree                       jax.tree (flatten, map)
repro_torch.checkpoint                 repro.checkpoint (bundles)
repro_torch.serving / launch           repro.serving / repro.launch (prior
                                       decode drain loop, serve and train
                                       CLIs, step builders)
=====================================  ======================================

ROADMAP.md lists what is still to port, in order.
"""

from .device import NoCudaDeviceError, resolve_device  # noqa: F401

__version__ = "0.1.0"
