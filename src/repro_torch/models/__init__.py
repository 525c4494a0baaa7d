"""The transformer zoo (port of :mod:`repro.models`), the dense and SSM
families: ``layers``, ``transformer``, ``counting``."""
