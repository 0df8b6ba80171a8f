"""int16-packing scale for x, bdist, and output rasters
(copy of cultionet_tpu/data/constant.py)."""

SCALE_FACTOR = 10_000.0
