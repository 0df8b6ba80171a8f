"""Import the PyTorch reference model (jgrss/cultionet) for numeric parity
(port of cultionet_tpu/utils/torch_import.py).

The reference package (its ``src`` directory at ``REFERENCE_CULTIONET``,
else ``reference/src`` at the root of this repository) cannot import in a
minimal image: it depends on lightning, natten (CUDA),
geowombat/rasterio/pyproj (GDAL stack), tsaug, ray/dask, etc. Everything except ``natten`` is only touched at import time
by the model files the tests need (models/nunet.py, models/cultionet.py,
nn/modules/*), so those are satisfied with permissive stub modules.

``natten`` is different: it is the math. The stand-in below is natten
0.17's ``NeighborhoodAttention2D`` (same parameter tree: qkv/proj Linear)
and its functional ``na2d``, ``na2d_qk`` and ``na2d_av`` on the port's
own plain neighborhood attention (``ops/natten.py``: the clamped-window
neighbor table and ``neighborhood_attention_2d_ref``), so the reference
model constructs and computes. It serves the tests only; no model path
of the port runs it.
"""

import importlib
import os
import sys
import types
import typing as T

REFERENCE_PATH = os.environ.get(
    "REFERENCE_CULTIONET",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "reference",
        "src",
    ),
)

# Top-level packages stubbed at any submodule depth (only when the real
# package is absent from the image).
_STUB_ROOTS = [
    "lightning",
    "torchmetrics",
    "geowombat",
    "xarray",
    "pyproj",
    "rasterio",
    "geopandas",
    "pygrts",
    "shapely",
    "dask",
    "ray",
    "tsaug",
    "frozendict",
    "skimage",
    "kornia",
    "tqdm",
    "rich",
    "rich_argparse",
    "decorator",
    "retry",
    "pandas",
    "torchvision",
    "joblib",
    "affine",
    "cv2",
    "opencv-python",
]


class _AnyClass:
    """Permissive base: subclassable, callable, attribute-forgiving."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        return self

    def __getattr__(self, name):
        return _AnyClass()


def _make_stub(name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__path__ = []  # mark as package so submodule imports resolve

    def module_getattr(attr, _name=name):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return _AnyClass

    mod.__getattr__ = module_getattr
    return mod


class _StubFinder:
    """meta_path finder creating permissive stubs for any submodule of the
    registered roots."""

    def __init__(self, roots: T.Sequence[str]):
        self.roots = set(roots)

    def find_spec(self, fullname, path=None, target=None):
        import importlib.machinery

        root = fullname.split(".", 1)[0]
        if root not in self.roots:
            return None

        class _Loader:
            def create_module(self, spec):
                return _make_stub(spec.name)

            def exec_module(self, module):
                pass

        return importlib.machinery.ModuleSpec(
            fullname, _Loader(), is_package=True
        )


def _install_torch_natten() -> None:
    """A real (torch) natten: clamped-window neighborhood attention."""
    import torch
    import torch.nn as nn

    from ..ops.natten import (
        _axis_neighbor_indices,
        neighborhood_attention_2d_ref,
    )

    def attend(q, k, v, kernel_size, dilation, scale, weights_fn=None):
        # (B, H, W, N, D) in/out; the reference scales by D^-0.5.
        default = q.shape[-1] ** -0.5
        if scale is not None and scale != default:
            q = q * (scale / default)
        return neighborhood_attention_2d_ref(
            q, k, v, kernel_size, dilation, weights_fn=weights_fn
        )

    def _neighbors(x, kernel_size, dilation):
        # x: (B, N, H, W, D) -> (B, N, H, W, k*k, D)
        height, width = x.shape[2:4]
        idx_h = torch.from_numpy(
            _axis_neighbor_indices(height, kernel_size, dilation).reshape(-1)
        ).to(x.device)
        idx_w = torch.from_numpy(
            _axis_neighbor_indices(width, kernel_size, dilation).reshape(-1)
        ).to(x.device)
        b, n, _, _, d = x.shape
        nbr = x.index_select(2, idx_h).reshape(b, n, height, kernel_size, width, d)
        nbr = nbr.index_select(4, idx_w).reshape(
            b, n, height, kernel_size, width, kernel_size, d
        )
        return nbr.permute(0, 1, 2, 4, 3, 5, 6).reshape(
            b, n, height, width, kernel_size * kernel_size, d
        )

    def na2d_qk(q, k, kernel_size, dilation=1, **_):
        # q, k: (B, heads, H, W, D) (natten layout) -> (B, heads, H, W, k*k)
        return torch.einsum(
            "bnhwd,bnhwkd->bnhwk", q, _neighbors(k, kernel_size, dilation)
        )

    def na2d_av(attn, v, kernel_size, dilation=1, **_):
        # attn: (B, heads, H, W, k*k), v: (B, heads, H, W, D)
        return torch.einsum(
            "bnhwk,bnhwkd->bnhwd", attn, _neighbors(v, kernel_size, dilation)
        )

    def na2d(q, k, v, kernel_size, dilation=1, scale=None, **_):
        # (B, H, W, N, D) in/out (natten functional layout)
        return attend(q, k, v, kernel_size, dilation, scale)

    class NeighborhoodAttention2D(nn.Module):
        """Parameter-compatible stand-in for natten 0.17's module
        (qkv/proj Linear tree, (B, H, W, C) in/out)."""

        def __init__(
            self,
            dim: int,
            num_heads: int,
            kernel_size: int,
            dilation: int = 1,
            rel_pos_bias: bool = False,
            qkv_bias: bool = True,
            qk_scale: T.Optional[float] = None,
            attn_drop: float = 0.0,
            proj_drop: float = 0.0,
        ):
            super().__init__()
            if rel_pos_bias:
                raise NotImplementedError("rel_pos_bias is not supported")
            self.num_heads = num_heads
            self.head_dim = dim // num_heads
            self.scale = qk_scale or self.head_dim**-0.5
            self.kernel_size = kernel_size
            self.dilation = dilation
            self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
            self.attn_drop = nn.Dropout(attn_drop)
            self.proj = nn.Linear(dim, dim)
            self.proj_drop = nn.Dropout(proj_drop)

        def forward(self, x):
            b, h, w, c = x.shape
            qkv = self.qkv(x).reshape(
                b, h, w, 3, self.num_heads, self.head_dim
            )
            q, k, v = qkv.unbind(dim=3)  # (B, H, W, N, D)
            out = attend(
                q, k, v, self.kernel_size, self.dilation, self.scale,
                weights_fn=self.attn_drop,
            )
            return self.proj_drop(self.proj(out.reshape(b, h, w, c)))

    natten = types.ModuleType("natten")
    natten.NeighborhoodAttention2D = NeighborhoodAttention2D
    functional = types.ModuleType("natten.functional")
    functional.na2d = na2d
    functional.na2d_qk = na2d_qk
    functional.na2d_av = na2d_av
    natten.functional = functional
    sys.modules["natten"] = natten
    sys.modules["natten.functional"] = functional


_installed = False


def install_reference_stubs() -> None:
    """Register permissive stubs for the reference's heavy dependencies and
    the torch natten stand-in. Idempotent. Packages actually present in
    the image are never shadowed."""
    global _installed
    if _installed:
        return
    if "natten" not in sys.modules or not hasattr(
        sys.modules["natten"], "NeighborhoodAttention2D"
    ):
        _install_torch_natten()
    missing = []
    for name in _STUB_ROOTS:
        if name in sys.modules:
            continue
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    sys.meta_path.append(_StubFinder(missing))
    _installed = True


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_PATH)


def load_reference_module(module: str):
    """Import a module from the reference package with stubs installed,
    e.g. ``load_reference_module('cultionet.models.nunet')``."""
    install_reference_stubs()
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)
    return importlib.import_module(module)
