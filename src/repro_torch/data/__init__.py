"""Seeded synthetic datasets (port of :mod:`repro.data`)."""

from .synthetic import air_quality_like, air_quality_rows, ou_process, token_batches  # noqa: F401
