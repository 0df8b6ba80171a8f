"""Window-based prediction reshaping (port of cultionet_tpu/utils/reshape.py).

``ModelOutputs`` slices the padded window interior out of stitched model
outputs, clips value ranges per stream, and replaces non-finite values:
the single-window reshape path, kept for the API (the blended
``predict.py::ScenePredictor`` is the main path).
"""

import typing as T

import numpy as np


class ModelOutputs:
    def __init__(
        self,
        distance: np.ndarray,  # (H, W)
        edge: np.ndarray,  # (H, W)
        crop: np.ndarray,  # (H, W)
        apply_softmax: bool = False,
    ):
        self.distance = np.asarray(distance, dtype="float32")
        self.edge = np.asarray(edge, dtype="float32")
        self.crop = np.asarray(crop, dtype="float32")
        self.apply_softmax = apply_softmax

    def stack_outputs(
        self,
        row_off: int = 0,
        col_off: int = 0,
        height: T.Optional[int] = None,
        width: T.Optional[int] = None,
    ) -> np.ndarray:
        """(3, height, width) stack of the window interior, clipped to
        [0, 1], with NaN and infinities set to 0."""
        height = height if height is not None else self.distance.shape[0]
        width = width if width is not None else self.distance.shape[1]

        def window(a: np.ndarray) -> np.ndarray:
            sliced = a[row_off : row_off + height, col_off : col_off + width]
            return np.nan_to_num(
                np.clip(sliced, 0.0, 1.0), nan=0.0, posinf=0.0, neginf=0.0
            )

        return np.stack(
            [window(self.distance), window(self.edge), window(self.crop)]
        )
