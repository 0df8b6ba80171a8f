"""Per-layer metrics: one module per metric, named as the metric, with
its ``LAYER``, ``UNIT``, ``BETTER``, ``SOURCE``, ``MOVES`` and
``WORKLOADS``, and ``read(ctx)``, which returns the value from the
traced run's context, or None where there is nothing to read. The
shared readings are in ``readers.py``."""
