"""Convert a JAX package checkpoint (orbax) into a checkpoint of the
PyTorch port.

    python convert_orbax.py JAX_STORE PORT_STORE

``JAX_STORE`` is a ``cultionet_tpu`` checkpoint directory (for example
``<project>/ckpt/last_store``: ``last/model``, ``last/opt`` and
``last.meta.json``). ``PORT_STORE`` receives, for each of ``last`` and
``best`` found, the port's layout (``cultionet_tpu_torch/train/checkpoint.py``):

- ``<which>/model.pt``: the parameters and BatchNorm statistics translated
  by ``cultionet_tpu_torch/utils/params.py::from_flax`` and loaded strictly
  into the port's model built from the checkpoint's hyperparameters, and
  the step;
- ``<which>/opt.pt``: where the JAX checkpoint holds an optimizer state,
  optax's moments (``mu``, ``nu``, or SGD's ``trace``), its update count
  and, under gradient accumulation, the accumulated gradients, as the
  port's optimizer keeps them, so ``fit`` resumes from a converted
  ``last`` with the same moments. An optax state with no counterpart
  raises, naming what it holds;
- ``<which>.meta.json``: the JAX meta file (epoch, step, metrics,
  hyperparameters) as it is.

The script imports JAX, orbax and ``cultionet_tpu``, so it runs where they
are installed; its output is plain ``torch.save`` files that the port
reads on a machine without JAX (``load_model``, ``fit``).
"""

import argparse
import dataclasses
import json
import shutil
import typing as T
from pathlib import Path

import jax
import numpy as np
import torch


def restore_jax_checkpoint(store, which: str = "last"):
    """A ``cultionet_tpu`` checkpoint restored as the JAX package's
    ``load_model`` restores it (``model._load_state``), on a template
    traced with ``jax.eval_shape``: the model built from the checkpoint's
    hyperparameters and the same ``Checkpointer.restore``, without an
    eager initialization of the template. Returns the state (its optimizer
    state left as the template's) and the JAX model."""
    from cultionet_tpu.data.synthetic import create_batch
    from cultionet_tpu.models import CultioNet
    from cultionet_tpu.train import optim, step
    from cultionet_tpu.train.checkpoint import Checkpointer

    ckpt = Checkpointer(store)
    hp = ckpt.load_meta(which)["hyperparams"]
    fields = {f.name for f in dataclasses.fields(CultioNet) if f.name != "parent"}
    model = CultioNet(**{k: v for k, v in hp.items() if k in fields})
    init_batch = create_batch(
        num_channels=hp["in_channels"], num_time=hp["in_time"], height=32,
        width=32, rng=np.random.default_rng(0),
    )
    abstract = jax.eval_shape(
        lambda: step.create_train_state(
            model, optim.build_optimizer("AdamW", 1e-3), init_batch, seed=0
        )
    )
    template = jax.tree_util.tree_map(
        lambda leaf: np.zeros(leaf.shape, leaf.dtype), abstract
    )
    return ckpt.restore(template, which, with_opt_state=False), model


def _find(tree, keys: T.Sequence[str], skip=("acc_grads",)):
    """The first mapping in ``tree`` (depth first) that holds all of
    ``keys``; subtrees under the names in ``skip`` are not searched."""
    if isinstance(tree, dict):
        if all(k in tree for k in keys):
            return tree
        children = [v for k, v in tree.items() if k not in skip]
    elif isinstance(tree, (list, tuple)):
        children = list(tree)
    else:
        return None
    for child in children:
        found = _find(child, keys, skip)
        if found is not None:
            return found
    return None


def _describe(tree, prefix="") -> T.List[str]:
    if isinstance(tree, dict):
        return [d for k, v in tree.items() for d in _describe(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [d for i, v in enumerate(tree) for d in _describe(v, f"{prefix}/{i}")]
    return [prefix or "/"]


def _by_port_name(param_tree, names: T.Sequence[str]) -> T.List[torch.Tensor]:
    """A params-shaped tree (moments, accumulated gradients) translated to
    torch names and layouts, in the port model's parameter order."""
    from cultionet_tpu_torch.utils.params import from_flax

    state = from_flax({"params": param_tree})
    missing = sorted(set(names) - set(state))
    extra = sorted(set(state) - set(names))
    if missing or extra:
        raise ValueError(
            f"optimizer tree does not match the model: missing {missing}, "
            f"unexpected {extra}"
        )
    return [state[name] for name in names]


def convert_opt_state(raw: dict, model) -> dict:
    """The port's ``Optimizer.state_dict`` from a JAX ``opt`` checkpoint
    restored without a target (``{"opt_state": ...}`` as nested dicts):
    Adam's, AdamW's and RAdam's ``mu``/``nu``/``count``, or SGD's
    momentum ``trace`` with the schedule's ``count``. The hyperparameters
    are the resuming optimizer's own (``Optimizer.load_state_dict`` reads
    only the state), so only the parameter indices are written for them."""
    opt_state = raw["opt_state"]
    names = [name for name, _ in model.named_parameters()]
    adam = _find(opt_state, ("mu", "nu", "count"))
    trace = _find(opt_state, ("trace",))
    counted = _find(opt_state, ("count",))
    if adam is not None:
        count = int(np.asarray(adam["count"]))
        mus = _by_port_name(adam["mu"], names)
        nus = _by_port_name(adam["nu"], names)
        slots = {
            i: {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": mu,
                "exp_avg_sq": nu,
            }
            for i, (mu, nu) in enumerate(zip(mus, nus))
        }
    elif trace is not None and counted is not None:
        count = int(np.asarray(counted["count"]))
        slots = {
            i: {"momentum_buffer": t}
            for i, t in enumerate(_by_port_name(trace["trace"], names))
        }
    else:
        raise ValueError(
            "optax state has no counterpart in the port: "
            + ", ".join(_describe(opt_state))
        )
    steps = _find(opt_state, ("mini_step", "acc_grads"), skip=())
    mini_step, acc = 0, None
    if steps is not None:
        mini_step = int(np.asarray(steps["mini_step"]))
        acc = _by_port_name(steps["acc_grads"], names) if mini_step else None
    return {
        "torch_optimizer": {
            "state": slots,
            "param_groups": [{"params": list(range(len(names)))}],
        },
        "count": count,
        "mini_step": mini_step,
        "acc": acc,
    }


def convert(
    jax_store: T.Union[str, Path], port_store: T.Union[str, Path]
) -> T.List[str]:
    """Convert ``last`` and ``best`` of ``jax_store``, each where it
    exists, into ``port_store``; returns the names converted."""
    import orbax.checkpoint as ocp

    from cultionet_tpu_torch.model import _NON_MODEL_KEYS
    from cultionet_tpu_torch.train.fit import model_from_kwargs
    from cultionet_tpu_torch.utils.params import load_flax

    jax_store, port_store = Path(jax_store), Path(port_store)
    done = []
    for name in ("last", "best"):
        meta_path = jax_store / f"{name}.meta.json"
        if not (jax_store / name / "model").exists() or not meta_path.exists():
            continue
        meta = json.loads(meta_path.read_text())
        state, _ = restore_jax_checkpoint(jax_store, name)
        hp = dict(meta["hyperparams"])
        in_channels = hp.get("in_channels", 3)
        model = model_from_kwargs(
            in_channels,
            {k: v for k, v in hp.items() if k not in _NON_MODEL_KEYS},
        )
        load_flax(
            model,
            {"params": state.params, "batch_stats": state.batch_stats},
        )
        out = port_store / name
        if out.exists():
            shutil.rmtree(out)
        out.mkdir(parents=True)
        torch.save(
            {
                "params": {
                    n: p.detach().clone() for n, p in model.named_parameters()
                },
                "batch_stats": {
                    n: b.detach().clone()
                    for n, b in model.state_dict().items()
                    if n not in dict(model.named_parameters())
                },
                "step": int(np.asarray(state.step)),
            },
            out / "model.pt",
        )
        opt_dir = jax_store / name / "opt"
        if opt_dir.exists():
            raw = ocp.StandardCheckpointer().restore(opt_dir.absolute())
            torch.save(
                {
                    "opt_state": convert_opt_state(raw, model),
                    "generator": None,
                },
                out / "opt.pt",
            )
        (port_store / f"{name}.meta.json").write_text(
            json.dumps(meta, indent=2)
        )
        done.append(name)
    if not done:
        raise FileNotFoundError(f"no JAX checkpoint under {jax_store}")
    return done


def main(argv: T.Optional[T.Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("jax_store", help="JAX checkpoint dir (last_store)")
    parser.add_argument("port_store", help="output dir for the port")
    args = parser.parse_args(argv)
    done = convert(args.jax_store, args.port_store)
    print(f"converted {', '.join(done)} into {args.port_store}")


if __name__ == "__main__":
    main()
