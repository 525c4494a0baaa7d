"""Device policy of the port's entry points.

Entry points (``serve_sde``, ``train_latent_sde``, the serve and train
CLIs, ``make_sample_step``, ``make_latent_sde_step``) run on the card
unless the caller asks for the CPU.  Without a card and without
an explicit CPU request they raise :class:`NoCudaDeviceError`; they never
fall back to the CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class NoCudaDeviceError(RuntimeError):
    """An entry point defaulted to the card, and no card is visible."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card (``cuda``); ``"cpu"`` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "repro_torch entry points run on the GPU by default and no CUDA "
            "device is visible; pass device='cpu' (CLI: --device cpu) to run "
            "the plain PyTorch versions on the CPU")
    return dev
