"""The benchmark's plain reference of the CLI-default model, in plain
PyTorch and fp32.

The modules here are a frozen copy of the math of what the
configurations run: the ResUNet-a tower with neighborhood attention at
the CLI-default options, both temporal front ends, the
Tanimoto-complement loss, the host augmenters, with the attention in
plain PyTorch (``natten.na2d``, ``temporal_attention.temporal_attention``)
and no kernel, export or parallel path. Nothing here imports the program
under test or the JAX package: the benchmark hands both sides the same
weights and inputs, and this package works out again whatever the
program derives from them. ``lowp.py`` runs the same math with every
parameter and every layer's output rounded to fp8: the control that the
comparison limits must reject.
"""
