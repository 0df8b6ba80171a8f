"""Checkpointing of the train state (port of
cultionet_tpu/train/checkpoint.py::Checkpointer, backed by ``torch.save``
instead of orbax).

Layout under ``ckpt_dir``:

- ``{last,best}/model.pt``: ``params`` (the model's parameters),
  ``batch_stats`` (its buffers: BatchNorm running statistics) and
  ``step``, as host tensors;
- ``{last,best}/opt.pt``: the optimizer's state (``Optimizer.state_dict``)
  and the state of the train step's dropout generator, so a resumed run
  continues the same random stream;
- ``{last,best}.meta.json``: ``epoch``, ``step``, ``metrics`` and
  ``hyperparams``, the keys of the JAX meta file.

An inference restore (``with_opt_state=False``) reads ``model.pt`` only.
The JAX package's orbax checkpoints convert to this layout with the root
script ``convert_orbax.py``.

In a data-parallel run every rank calls ``save_last``/``save_best``: the
state is gathered (FSDP's shards whole, and every rank's dropout
generator, kept as ``generators`` beside rank 0's ``generator``), rank 0
alone writes, and the others wait at a barrier. So a checkpoint is the
same file as a single card's, and each rank's restore shards it again and
takes back its own generator.
"""

import json
import shutil
import typing as T
from pathlib import Path

import torch
import torch.distributed as dist

from ..parallel.mesh import full_tensor, rank_and_world, shard_like
from .step import TrainState


def _persistent_buffers(model) -> T.Dict[str, torch.Tensor]:
    """The buffers a ``state_dict`` holds (the BatchNorm statistics), by
    name: not a non-persistent one such as the transformer front end's
    sinusoid table, which the model rebuilds."""
    persistent = model.state_dict(keep_vars=True)
    return {n: b for n, b in model.named_buffers() if n in persistent}


def _host(tensors: T.Mapping[str, torch.Tensor]) -> T.Dict[str, torch.Tensor]:
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


class Checkpointer:
    """Manages ``<ckpt_dir>/{last,best}`` train-state checkpoints."""

    def __init__(self, ckpt_dir: T.Union[str, Path]):
        self.ckpt_dir = Path(ckpt_dir).absolute()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)

    def _meta_path(self, which: str) -> Path:
        return self.ckpt_dir / f"{which}.meta.json"

    def _has(self, which: str) -> bool:
        return (self.ckpt_dir / which / "model.pt").exists() and (
            self._meta_path(which).exists()
        )

    def has_last(self) -> bool:
        return self._has("last")

    def has_best(self) -> bool:
        return self._has("best")

    def _save(
        self,
        which: str,
        state: TrainState,
        epoch: int,
        metrics: T.Optional[T.Dict[str, float]] = None,
        hyperparams: T.Optional[dict] = None,
        generator: T.Optional[torch.Generator] = None,
    ) -> None:
        """Write into ``<which>.tmp`` and move it into place, so a run cut
        while saving leaves the previous checkpoint whole."""
        rank, world = rank_and_world()
        model = state.model
        model_payload = {
            "params": _host(
                {n: full_tensor(p) for n, p in model.named_parameters()}
            ),
            "batch_stats": _host(_persistent_buffers(model)),
            "step": int(state.step),
        }
        opt_payload = {
            "opt_state": state.optimizer.state_dict(),
            "generator": None if generator is None else generator.get_state(),
        }
        if world > 1 and generator is not None:
            states = [None] * world
            dist.all_gather_object(states, generator.get_state())
            opt_payload["generators"] = states
        if rank == 0:
            self._write(which, epoch, model_payload, opt_payload, metrics,
                        hyperparams)
        if world > 1:
            dist.barrier()

    def _write(self, which, epoch, model_payload, opt_payload, metrics,
               hyperparams) -> None:
        path = self.ckpt_dir / which
        tmp = self.ckpt_dir / f"{which}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(model_payload, tmp / "model.pt")
        torch.save(opt_payload, tmp / "opt.pt")
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)
        meta = {
            "epoch": int(epoch),
            "step": int(model_payload["step"]),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "hyperparams": hyperparams or {},
        }
        self._meta_path(which).write_text(json.dumps(meta, indent=2))

    def save_last(self, state, epoch, metrics=None, hyperparams=None,
                  generator=None):
        self._save("last", state, epoch, metrics, hyperparams, generator)

    def save_best(self, state, epoch, metrics=None, hyperparams=None,
                  generator=None):
        self._save("best", state, epoch, metrics, hyperparams, generator)

    def load_meta(self, which: str = "last") -> dict:
        return json.loads(self._meta_path(which).read_text())

    def restore(
        self,
        state: TrainState,
        which: str = "last",
        with_opt_state: bool = True,
        generator: T.Optional[torch.Generator] = None,
    ) -> TrainState:
        """Load checkpoint ``which`` into ``state`` in place (strictly: every
        parameter and buffer by name) and return it. With
        ``with_opt_state=False`` (inference) the optimizer is left as it
        is; otherwise its state is restored, and ``generator``'s too when
        one is given and was saved."""
        payload = torch.load(
            self.ckpt_dir / which / "model.pt", map_location="cpu",
            weights_only=True,
        )
        model = state.model
        current = dict(model.named_parameters())
        # Files written before the save kept persistent buffers only also
        # hold the transformer's sinusoid table: the model rebuilds it.
        persistent = _persistent_buffers(model)
        model.load_state_dict(
            {
                **{
                    n: shard_like(v, current[n]) if n in current else v
                    for n, v in payload["params"].items()
                },
                **{
                    n: v
                    for n, v in payload["batch_stats"].items()
                    if n in persistent
                },
            },
            strict=True,
        )
        state.step = int(payload["step"])
        if with_opt_state:
            # Read to the host: the torch optimizer moves its state to the
            # parameters' device and keeps its step counts where it keeps
            # them (on the host).
            opt = torch.load(
                self.ckpt_dir / which / "opt.pt", map_location="cpu",
                weights_only=True,
            )
            state.optimizer.load_state_dict(opt["opt_state"])
            saved = opt.get("generators") or [opt["generator"]]
            rank = rank_and_world()[0]
            if generator is not None and rank < len(saved) and saved[rank] is not None:
                generator.set_state(saved[rank])
        return state
