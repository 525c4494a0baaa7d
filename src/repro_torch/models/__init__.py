"""The transformer zoo (port of :mod:`repro.models`), the dense, MoE, SSM
and hybrid families: ``layers``, ``transformer``, ``counting``."""
