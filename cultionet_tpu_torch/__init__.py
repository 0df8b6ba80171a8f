"""cultionet-tpu-torch: the PyTorch / CUDA (NVIDIA H100) port of cultionet_tpu.

The JAX package ``cultionet_tpu`` stays the reference; this package mirrors
its module layout (``nn/``, ``ops/``, ``models/``, ``train/``, ``data/``,
``utils/``, ``predict.py``) and imports nothing from it, nor JAX. Every
Pallas kernel on a ported path becomes a hand-written Hopper kernel beside a
plain PyTorch version of the same function (``ops/natten.py`` and
``ops/natten_cuda.py`` for neighborhood attention).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
