"""Reference checkpoint importer: a jgrss/cultionet TowerUNet / CultioNet
``state_dict`` (e.g. the one a Lightning ``last.ckpt`` holds) loaded into
the port's model (port of cultionet_tpu/utils/torch_params.py).

``translate_state_dict`` is the JAX package's translator, copied as it is:
its rules decide which reference names are accepted, and it maps each
entry to a flax variable path in flax layout:

  Conv2d     (O, I, kh, kw)     -> (kh, kw, I, O)
  Conv3d     (O, I, kt, kh, kw) -> (kt, kh, kw, I, O)
  ConvTransp (I, O, kh, kw)     -> (kh, kw, I, O) + spatial flip
  Linear     (O, I)             -> (I, O)
  BatchNorm/LayerNorm weight/bias -> scale/bias; running stats -> the
  ``batch_stats`` collection.

The port names its submodules after the flax scopes, so
``import_torch_state_dict`` takes those paths through ``utils/params.py``'s
``from_flax``, which undoes the layouts: a reference Conv, Conv3d,
ConvTranspose or Linear weight lands in the port's module as it was.

The natten qkv packing needs no permutation: torch reshapes the fused
projection as (3, heads, dim) and flax splits thirds then heads, the same
column order.
"""

import re
import typing as T

import numpy as np
import torch
from torch import nn

from .params import from_flax

TensorDict = T.Dict[str, T.Any]


def _seq_ordinals(state_dict: TensorDict) -> T.Dict[str, T.Tuple[str, int]]:
    """For every ``<prefix>.seq.<i>`` child holding parameters, assign the
    flax auto-name ordinal per layer type: convs count Conv_0, Conv_1, ...;
    norms count BatchNorm_0, ... (flax names by type, not position, so this
    is correct for either batchnorm_first order)."""
    children: T.Dict[str, T.Dict[int, str]] = {}
    for key, value in state_dict.items():
        m = re.match(r"(.*\.seq)\.(\d+)\.(weight)$", key)
        if not m:
            continue
        prefix, idx = m.group(1), int(m.group(2))
        ndim = len(value.shape)
        kind = "conv" if ndim >= 4 else "norm"
        children.setdefault(prefix, {})[idx] = kind

    table: T.Dict[str, T.Tuple[str, int]] = {}
    for prefix, kids in children.items():
        conv_n = 0
        norm_n = 0
        for idx in sorted(kids):
            if kids[idx] == "conv":
                table[f"{prefix}.{idx}"] = ("conv", conv_n)
                conv_n += 1
            else:
                table[f"{prefix}.{idx}"] = ("norm", norm_n)
                norm_n += 1
    return table


_ATTENTION_CHILD = {
    "1": "LayerNorm_0",
    "2": "NeighborhoodAttention2D_0",
    "3": "LayerNorm_1",
}


def _translate_module(
    segs: T.Sequence[str], seq_table, state_key: str
) -> T.Tuple[T.List[str], str]:
    """Translate the torch module path (without the leaf) to the flax path.
    Returns (flax segments, kind) with kind in conv/conv_transpose/linear/
    norm/param."""
    out: T.List[str] = []
    kind = "param"
    # 'encoder' may sit below a wrapper scope (CultioNet's 'mask_model.'
    # prefix for whole-model state_dicts), so search, don't index.
    in_encoder = "encoder" in segs
    i = 0
    while i < len(segs):
        s = segs[i]
        nxt = segs[i + 1] if i + 1 < len(segs) else None
        if s == "_orig_mod":
            i += 1
        elif s == "res_modules":
            out.append(f"res_branch_{nxt}")
            i += 2
        elif s == "block":
            out.append(f"ConvBlock2d_{nxt}")
            i += 2
        elif s == "res_conv" and in_encoder:
            out.append("ResidualAConv_0")
            i += 1
        elif s == "seq":
            # seq children are always parameter leaves, so the table key is
            # the raw module path (incl. any _orig_mod) = key minus leaf.
            seq_kind, ordinal = seq_table[state_key.rsplit(".", 1)[0]]
            if seq_kind == "conv":
                out.append(f"Conv_{ordinal}")
                kind = "conv"
            else:
                out.extend([f"BatchNorm_{ordinal}", "BatchNorm_0"])
                kind = "norm"
            i += 2
        elif s == "attention_conv" and nxt in _ATTENTION_CHILD:
            out.append(_ATTENTION_CHILD[nxt])
            if nxt in ("1", "3"):
                kind = "norm"
            i += 2
        elif s == "attention_conv":
            # spatial_channel variant (reference attention.py:89-125)
            out.append("SpatialChannelAttention_0")
            i += 1
        elif s == "channel_attention":
            out.append("ChannelAttention_0")
            i += 1
        elif s in ("fc1", "fc2") and nxt in ("0", "2"):
            pool = "avg" if s == "fc1" else "max"
            out.append(f"{pool}_fc{1 if nxt == '0' else 2}")
            kind = "conv"
            i += 2
        elif s == "spatial_attention":
            out.append("SpatialAttention_0")
            i += 1
        elif s == "conv" and nxt is None:
            # SpatialAttention's 3x3 gate conv
            out.append("Conv_0")
            kind = "conv"
            i += 1
        elif s == "up_conv" and nxt == "up_conv":
            out.extend(["up_conv", "ConvTranspose_0"])
            kind = "conv_transpose"
            i += 2
        elif s in ("backbone_down_conv", "decode_down_conv", "tower_conv") \
                and nxt == "up_conv":
            out.extend([s, "ConvTranspose_0"])
            kind = "conv_transpose"
            i += 2
        elif s == "conv" and nxt is not None and nxt.isdigit():
            # TowerUNetFinal stream convs: conv.0 = ConvBlock2d, conv.1 =
            # plain 1-channel conv (reference unet_parts.py:196-224).
            if nxt == "0":
                out.append("ConvBlock2d_0")
            else:
                out.append("Conv_0")
                kind = "conv"
            i += 2
        elif s == "layer_norm" and nxt is not None and nxt.isdigit():
            # pre_unet: Sequential(Rearrange, LayerNorm, Rearrange).
            out.append("LayerNorm_0")
            kind = "norm"
            i += 2
        elif s in ("final_dist", "final_edge", "final_crop") \
                and nxt is not None and nxt.isdigit():
            if s == "final_edge" and nxt == "1":
                out.append("edge_crisp")
            else:
                out.append(s)
                kind = "conv"
            i += 2
        elif s in ("qkv", "proj"):
            out.append(s)
            kind = "linear"
            i += 1
        elif s == "skip":
            out.append(s)
            kind = "conv"
            i += 1
        else:
            out.append(s)
            i += 1
    return out, kind


def _transform(value: np.ndarray, kind: str, leaf: str) -> np.ndarray:
    if leaf in ("running_mean", "running_var"):
        return value
    if kind == "conv" and leaf == "weight":
        if value.ndim == 5:
            return np.transpose(value, (2, 3, 4, 1, 0))
        if value.ndim == 4:
            return np.transpose(value, (2, 3, 1, 0))
    if kind == "conv_transpose" and leaf == "weight":
        return np.transpose(value, (2, 3, 0, 1))[::-1, ::-1]
    if kind == "linear" and leaf == "weight":
        return value.T
    return value


def translate_state_dict(
    state_dict: TensorDict,
) -> T.Tuple[T.Dict[tuple, np.ndarray], T.Dict[tuple, np.ndarray]]:
    """Translate a torch state_dict into flat {flax path tuple: array} maps
    for the params and batch_stats collections."""
    seq_table = _seq_ordinals(state_dict)
    params: T.Dict[tuple, np.ndarray] = {}
    stats: T.Dict[tuple, np.ndarray] = {}
    for key, tensor in state_dict.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            continue
        value = np.asarray(
            tensor.detach().cpu().numpy()
            if hasattr(tensor, "detach")
            else tensor
        )
        module_segs = key.split(".")[:-1]
        flax_segs, kind = _translate_module(module_segs, seq_table, key)
        value = _transform(value, kind, leaf)
        if leaf == "running_mean":
            stats[tuple(flax_segs) + ("mean",)] = value
        elif leaf == "running_var":
            stats[tuple(flax_segs) + ("var",)] = value
        elif leaf == "weight":
            name = "scale" if kind == "norm" else "kernel"
            params[tuple(flax_segs) + (name,)] = value
        elif leaf == "bias":
            params[tuple(flax_segs) + ("bias",)] = value
        else:
            # bare parameters: gammas, SigmoidCrisp gamma
            params[tuple(flax_segs) + (leaf,)] = value
    return params, stats


def _flax_shape(scope: T.Sequence[str], leaf: str, shape) -> tuple:
    """The flax layout's shape of a port tensor (the inverse of
    ``utils/params.py::_layout``)."""
    shape = tuple(shape)
    if leaf != "kernel":
        return shape
    if len(shape) == 2:
        return shape[::-1]
    if scope[-1].startswith("ConvTranspose"):
        return shape[2:] + shape[:2]
    return shape[2:] + (shape[1], shape[0])


def _flax_tree(model: nn.Module) -> T.Dict[str, dict]:
    """The model's variables as the nested flax {"params", "batch_stats"}
    trees of shapes, by the names ``from_flax`` maps to the model's keys
    (a 1-D ``weight`` is a norm's ``scale``, a wider one a ``kernel``)."""
    trees: T.Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in model.state_dict().items():
        *scope, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        if name in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", name[len("running_"):]
        elif name == "weight":
            collection = "params"
            leaf = "scale" if tensor.ndim == 1 else "kernel"
        else:
            collection, leaf = "params", name
        node = trees[collection]
        for seg in scope:
            node = node.setdefault(seg, {})
        node[leaf] = _flax_shape(scope, leaf, tensor.shape)
    return trees


def _place(tree: dict, path: tuple, value: np.ndarray, errors: list) -> bool:
    """The JAX importer's ``_set_nested`` check on a tree of shapes:
    append the same message for a path or leaf the tree lacks or a shape
    that differs; True where the value has its place."""
    node = tree
    for seg in path[:-1]:
        if not isinstance(node, dict) or seg not in node:
            errors.append(f"missing path: {'/'.join(path)}")
            return False
        node = node[seg]
    leaf = path[-1]
    if not isinstance(node, dict) or leaf not in node:
        errors.append(f"missing leaf: {'/'.join(path)}")
        return False
    expected = node[leaf]
    if tuple(expected) != tuple(value.shape):
        errors.append(
            f"shape mismatch at {'/'.join(path)}: "
            f"flax {tuple(expected)} vs torch {tuple(value.shape)}"
        )
        return False
    return True


def _nest(flat: T.Mapping[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = value
    return tree


def import_torch_state_dict(
    state_dict: TensorDict,
    model: nn.Module,
    prefix: str = "",
) -> int:
    """Load a reference TowerUNet/CultioNet ``state_dict`` into the port's
    ``model`` in place; returns the number of entries loaded.

    ``prefix`` strips a leading torch scope, e.g. ``"cultionet_model."`` for
    Lightning checkpoints or ``"mask_model."`` to load a CultioNet
    state_dict into a bare TowerUNet; entries without it are ignored, and
    ``_orig_mod`` (torch.compile) segments are skipped.

    The rule is the JAX importer's: every entry must have a place in the
    model with the same shape, else one ``ValueError`` lists every entry
    that has not (all or nothing: the model is left as it was).
    ``num_batches_tracked`` is skipped. A parameter or statistic that the
    ``state_dict`` lacks keeps the model's value (this is not
    ``load_flax``'s ``strict=True``). Values are cast to the dtype of the
    model's tensor they replace.
    """
    if prefix:
        state_dict = {
            k[len(prefix):]: v
            for k, v in state_dict.items()
            if k.startswith(prefix)
        }
    params_map, stats_map = translate_state_dict(state_dict)

    expected = _flax_tree(model)
    errors: T.List[str] = []
    for path, value in params_map.items():
        _place(expected["params"], path, value, errors)
    for path, value in stats_map.items():
        _place(expected["batch_stats"], path, value, errors)

    n_expected = len(params_map) + len(stats_map)
    if errors:
        raise ValueError(
            f"torch->flax import failed for {len(errors)}/{n_expected} "
            "entries:\n" + "\n".join(errors[:40])
        )

    variables = {"params": _nest(params_map)}
    if stats_map:
        variables["batch_stats"] = _nest(stats_map)
    targets = model.state_dict()
    with torch.no_grad():
        for key, value in from_flax(variables).items():
            targets[key].copy_(value.to(dtype=targets[key].dtype))
    return n_expected


def load_reference_checkpoint(
    path: str,
    model: nn.Module,
    prefix: str = "cultionet_model.",
) -> int:
    """Load a reference Lightning checkpoint file (``ckpt/last.ckpt``) into
    the port's CultioNet ``model``; returns the number of entries loaded.
    The Lightning module stores the model under ``cultionet_model.``; pass
    ``prefix='cultionet_model.mask_model.'`` to load into a bare TowerUNet
    instead."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    return import_torch_state_dict(state_dict, model, prefix=prefix)
