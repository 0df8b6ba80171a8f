"""Errors of the port (copy of cultionet_tpu/errors.py)."""


class TensorShapeError(Exception):
    """Raised when chip tensors have unexpected shapes."""


class TopologyClipError(Exception):
    """Raised when vector training data cannot be clipped to a grid."""
