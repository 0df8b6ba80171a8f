"""Drivers: one module per kind of cell (``train``, ``predict``,
``serve``), each with ``run(ctx)``."""
