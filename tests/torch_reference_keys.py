"""Reference (jgrss/cultionet) names for the port's model parameters: the
inverse of the naming rules of ``utils/torch_params.py::_translate_module``.

``reference_state_dict(state)`` turns a port ``state_dict`` (or, through
``utils/params.py::from_flax``, JAX variables) into a reference-format
``state_dict`` of numpy arrays; ``lightning_checkpoint`` wraps one as a
Lightning ``last.ckpt`` holds it. The JAX package's ``translate_state_dict``
maps the result back to the variables leaf for leaf
(``tests/test_torch_import_torch.py`` holds that for every option set the
translator names).

Where the translator passes a flax scope through unchanged (its last
``else``), the name round-trips whatever it is, and a weight there is not
re-laid out: such a name and layout are the translator's, not checked
against the reference model (``ResConvBlock2d_0``, ``ResidualConv_0``, the
``batchnorm_first`` ``pool_conv`` kernel). Sequential positions follow
the blocks' layer order: ``ConvBlock2d`` is (conv, norm, activation), or
(norm, activation, conv) where its conv has a bias (``batchnorm_first``);
the temporal ``Conv3d`` stack is (conv, norm, activation) twice.

numpy only: ``chip_smoke.py`` imports it too.
"""

import re
import typing as T

import numpy as np

_LAYER = re.compile(r"(Conv|BatchNorm)_(\d+)$")


def _array(value) -> np.ndarray:
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def _flax_layout(value: np.ndarray) -> np.ndarray:
    """A port weight in the flax layout (``from_flax`` undone)."""
    if value.ndim == 2:
        return value.T
    if value.ndim == 4:
        return value.transpose(2, 3, 1, 0)
    if value.ndim == 5:
        return value.transpose(2, 3, 4, 1, 0)
    return value


def _seq_positions(children: T.Set[str], conv_bias: bool) -> T.Dict[str, int]:
    """Sequential index of each Conv_k / BatchNorm_k child of a block."""
    convs = sorted(int(_LAYER.match(c).group(2)) for c in children
                   if c.startswith("Conv_"))
    norms = sorted(int(_LAYER.match(c).group(2)) for c in children
                   if c.startswith("BatchNorm_"))
    positions = {}
    for k in range(max(len(convs), len(norms))):
        if conv_bias:  # batchnorm_first: norm, activation, conv
            positions[f"BatchNorm_{k}"] = 3 * k
            positions[f"Conv_{k}"] = 3 * k + 2
        else:  # conv, norm, activation
            positions[f"Conv_{k}"] = 3 * k
            positions[f"BatchNorm_{k}"] = 3 * k + 1
    return positions


def reference_state_dict(state: T.Mapping[str, T.Any]) -> T.Dict[str, np.ndarray]:
    """The reference ``state_dict`` of a port ``state_dict``: the same
    values (``num_batches_tracked`` included) under reference names, in
    the reference layout where the translator re-lays out the weight."""
    keys = list(state)
    children: T.Dict[tuple, T.Set[str]] = {}
    for key in keys:
        segs = key.split(".")[:-1]
        for i in range(len(segs)):
            children.setdefault(tuple(segs[:i]), set()).add(segs[i])

    def final_stream(parent: tuple) -> bool:
        sibs = children.get(parent, set())
        return "ConvBlock2d_0" in sibs and "Conv_0" in sibs and not any(
            s.startswith("BatchNorm_") for s in sibs
        )

    out: T.Dict[str, np.ndarray] = {}
    for key in keys:
        *segs, leaf = key.split(".")
        value = _array(state[key])
        ref: T.List[str] = []
        relaid = False  # the translator re-lays out this weight
        i = 0
        while i < len(segs):
            s = segs[i]
            parent = tuple(segs[:i])
            up = segs[i - 1] if i else None
            nxt = segs[i + 1] if i + 1 < len(segs) else None
            if s.startswith("res_branch_"):
                ref += ["res_modules", s[len("res_branch_"):]]
            elif s == "ResidualAConv_0" and "encoder" in segs:
                ref.append("res_conv")
            elif s.startswith("ConvBlock2d_"):
                if final_stream(parent):
                    ref += ["conv", "0"]
                else:
                    ref += ["block", s[len("ConvBlock2d_"):]]
            elif s == "Conv_0" and up == "SpatialAttention_0":
                ref.append("conv")
                relaid = True
            elif s == "Conv_0" and final_stream(parent):
                ref += ["conv", "1"]
                relaid = True
            elif _LAYER.match(s):
                sibs = children[parent]
                bias = ".".join([*parent, "Conv_0", "bias"]) in state
                ref += ["seq", str(_seq_positions(sibs, bias)[s])]
                relaid = s.startswith("Conv_")
                if s.startswith("BatchNorm_") and nxt == "BatchNorm_0":
                    i += 1
            elif s == "LayerNorm_0" and up == "pre_unet":
                ref += ["layer_norm", "1"]
            elif s in ("LayerNorm_0", "NeighborhoodAttention2D_0", "LayerNorm_1"):
                position = {"LayerNorm_0": "1", "NeighborhoodAttention2D_0": "2",
                            "LayerNorm_1": "3"}[s]
                ref += ["attention_conv", position]
            elif s == "SpatialChannelAttention_0":
                ref.append("attention_conv")
            elif s == "ChannelAttention_0":
                ref.append("channel_attention")
            elif s == "SpatialAttention_0":
                ref.append("spatial_attention")
            elif s in ("avg_fc1", "avg_fc2", "max_fc1", "max_fc2"):
                ref += ["fc1" if s.startswith("avg") else "fc2",
                        "0" if s.endswith("1") else "2"]
                relaid = True
            elif s == "ConvTranspose_0":
                ref.append("up_conv")
                relaid = True
            elif s in ("final_dist", "final_edge", "final_crop"):
                ref += [s, "0"]
                relaid = True
            elif s == "edge_crisp":
                ref += ["final_edge", "1"]
            elif s in ("qkv", "proj", "skip"):
                ref.append(s)
                relaid = True
            else:
                ref.append(s)
            i += 1
        if leaf == "weight" and not relaid:
            value = _flax_layout(value)
        out[".".join([*ref, leaf])] = value
    return out


def lightning_checkpoint(
    state: T.Mapping[str, T.Any],
    hyper_parameters: T.Optional[dict] = None,
) -> dict:
    """A Lightning-shaped checkpoint of a port CultioNet ``state_dict``:
    the reference names under ``cultionet_model.`` (as torch tensors, as
    Lightning saves them), with ``hyper_parameters`` where given."""
    import torch

    ckpt = {
        "state_dict": {
            f"cultionet_model.{k}": torch.from_numpy(np.ascontiguousarray(v))
            for k, v in reference_state_dict(state).items()
        }
    }
    if hyper_parameters is not None:
        ckpt["hyper_parameters"] = dict(hyper_parameters)
    return ckpt
