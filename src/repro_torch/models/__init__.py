"""The transformer zoo (port of :mod:`repro.models`), the dense family:
``layers``, ``transformer``, ``counting``."""
