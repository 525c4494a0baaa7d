"""Mesh planning (port of :mod:`repro.distributed`: the pure-Python elastic
planner so far)."""

from .elastic import plan_mesh, rebatch, surviving_devices  # noqa: F401
