"""Entry points (port of :mod:`repro.launch`)."""
