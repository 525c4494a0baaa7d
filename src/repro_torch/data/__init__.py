"""Seeded synthetic datasets (port of :mod:`repro.data`)."""

from .synthetic import air_quality_like  # noqa: F401
