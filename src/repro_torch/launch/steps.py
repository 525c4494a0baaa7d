"""Step builders (port of :mod:`repro.launch.steps`; so far the serving
sampler ``make_sample_step`` for the Latent-SDE prior decode)."""

from __future__ import annotations

from ..device import resolve_device

SERVE_WORKLOADS = ("sde-gan", "latent-sde")


def make_sample_step(workload: str, cfg, latent_mode: str = "prior", device=None):
    """Build the batched trajectory sampler of one serving bucket:
    ``(params, keys) -> (num_steps+1, len(keys), data_dim)``.

    Runs on the card unless ``device="cpu"`` (no card: a named error).
    ``keys`` are moved to that device; ``params`` must already live there.
    Every output row is a pure function of ``(params, keys[i])``, so padding
    ``keys`` up to a bucket cannot change the real rows.  Validation is
    eager: an unported workload or mode raises here, at build time.
    """
    from ..core import sde as S
    from ..serving.service import ServingNotPortedError

    if workload not in SERVE_WORKLOADS:
        raise ValueError(f"workload must be one of {SERVE_WORKLOADS}, got {workload!r}")
    if workload != "latent-sde":
        raise ServingNotPortedError(
            f"the {workload!r} sampler is not ported yet — ROADMAP.md Queue 1, "
            f"items 7 and 12")
    if latent_mode not in ("prior", "posterior"):
        raise ValueError(f"latent_mode must be 'prior' or 'posterior', got {latent_mode!r}")
    if latent_mode != "prior":
        raise ServingNotPortedError(
            "latent_mode='posterior' is not ported yet — ROADMAP.md Queue 1, "
            "items 6 and 12")
    dev = resolve_device(device)

    def sample(params, keys):
        return S.latent_sde_sample_paths(params, cfg, keys.to(dev))

    return sample
