"""Seeded synthetic datasets (port of :mod:`repro.data`)."""

from .synthetic import air_quality_like, ou_process, token_batches  # noqa: F401
