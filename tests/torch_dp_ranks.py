"""Rank functions of the port's data-parallel tests.

``cultionet_tpu_torch.parallel.distributed.launch`` starts each in new
processes ("spawn") joined in a gloo group, which import it by name; this
module imports only the port (no JAX), so the ranks start quickly. Each
rank writes what the parent test compares to ``<out>/rank<r>.pt``.
"""

import copy
from pathlib import Path

import torch

from cultionet_tpu_torch.data.batch import Batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.parallel import (
    data_parallel,
    global_batch_from_local,
    make_sharded_eval_step,
    make_sharded_predict_step,
    make_sharded_train_step,
    rank_and_world,
    shard_batch,
    shard_state_fsdp,
    topology_summary,
)
from cultionet_tpu_torch.parallel.mesh import (
    full_tensor,
    gather_blocks,
    gather_for_loss,
    is_sharded,
)
from cultionet_tpu_torch.train import optim
from cultionet_tpu_torch.train.step import create_train_state


def keep_gradients(state) -> dict:
    """Wrap ``state.optimizer.step`` so that its next call first copies
    every parameter's gradient, whole (a collective under FSDP), into the
    returned dict: the gradient the optimizer sees, after the all-reduce."""
    grads = {}
    update = state.optimizer.step

    def step_keeping_gradients():
        grads.update(
            {
                n: full_tensor(p.grad.detach()).clone()
                for n, p in state.model.named_parameters()
                if p.grad is not None
            }
        )
        return update()

    state.optimizer.step = step_keeping_gradients
    return grads


def _step_checks(model: CultioNet, batch: Batch, tx_kwargs, fsdp: bool):
    """One sharded fp32 train step and the sharded eval step from
    ``model``'s weights; with ``fsdp`` the submodules with a parameter of
    128 elements or more are sharded first. Also the gradients the
    optimizer received."""
    state = create_train_state(
        copy.deepcopy(model), optim.build_optimizer(), device="cpu"
    )
    names = []
    if fsdp:
        names = shard_state_fsdp(state, min_size=128)
    sharded = [n for n, p in state.model.named_parameters() if is_sharded(p)]
    state.optimizer = optim.build_optimizer(**tx_kwargs).init(
        state.model.parameters()
    )
    kwargs = dict(loss_name="TanimotoComplementLoss", precision="fp32",
                  device="cpu")
    step = make_sharded_train_step(**kwargs)
    grads = keep_gradients(state)
    state, logs = step(state, shard_batch(batch), torch.Generator())
    metrics = make_sharded_eval_step(**kwargs)(state, shard_batch(batch))
    return {
        "loss": float(logs["loss"]),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "params": {
            n: full_tensor(p.detach()).clone()
            for n, p in state.model.named_parameters()
        },
        "buffers": {n: b.clone() for n, b in state.model.named_buffers()},
        "grads": grads,
        "fsdp_modules": names,
        "sharded": sharded,
    }


def _batchnorm_check(bn_state, x_nchw, probe):
    """The port's BatchNorm in training over this rank's block inside
    ``data_parallel``: the gathered output, the input gradient of
    ``sum(out * probe)`` and the running statistics."""
    from cultionet_tpu_torch.nn.blocks import BatchNorm

    bn = BatchNorm(x_nchw.shape[1])
    bn.load_state_dict(bn_state)
    bn.train()
    x = shard_batch(Batch(x=x_nchw)).x.clone().requires_grad_()
    local_probe = shard_batch(Batch(x=probe)).x
    with data_parallel():
        out = bn(x)
    (out * local_probe).sum().backward()
    return {
        "out": gather_blocks(out.detach()),
        "grad": gather_blocks(x.grad),
        "running_mean": bn.BatchNorm_0.running_mean.clone(),
        "running_var": bn.BatchNorm_0.running_var.clone(),
    }


def _ratio_loss_checks(preds, bdist, mask):
    """Each masked ratio loss of the registry on the gathered outputs of
    this rank's block: its value and the ranks' gradients gathered."""
    from cultionet_tpu_torch.losses.losses import (
        boundary_loss,
        class_balanced_mse_loss,
        log_cosh_loss,
    )

    world = rank_and_world()[1]
    out = {}
    for name, fn in (
        ("log_cosh_loss", log_cosh_loss),
        ("class_balanced_mse_loss", class_balanced_mse_loss),
        ("boundary_loss", boundary_loss),
    ):
        local = shard_batch(Batch(x=preds)).x.clone().requires_grad_()
        block = shard_batch(Batch(x=preds, y=mask, bdist=bdist))
        with data_parallel():
            outputs, labels = gather_for_loss({"dist": local}, block)
        loss = fn(outputs["dist"], labels.bdist, mask=labels.y)
        loss.backward()
        # Every rank computes the global loss: the ranks' gradients sum to
        # the world size times its gradient.
        out[name] = {
            "loss": float(loss),
            "grad": gather_blocks(local.grad) / world,
        }
    return out


def parallel_checks(device, payload: dict, out: str) -> None:
    """Everything ``tests/test_torch_parallel.py`` runs on two ranks."""
    rank, world = rank_and_world()
    batch = Batch(**payload["batch"])
    model = CultioNet(**payload["model_kwargs"])
    model.load_state_dict(payload["state_dict"])
    block = shard_batch(batch)
    predict = make_sharded_predict_step(model, precision="fp32", device="cpu")
    result = {
        "rank": rank,
        "world": world,
        "topology": topology_summary(),
        "block_x": block.x.clone(),
        "global_x": global_batch_from_local(block).x,
        "predict": {
            k: v.clone() for k, v in predict(block.x).items() if v is not None
        },
        "dp": _step_checks(model, batch, payload["tx"], fsdp=False),
        "fsdp": _step_checks(model, batch, payload["tx"], fsdp=True),
        "bn": _batchnorm_check(**payload["bn"]),
        "ratio": _ratio_loss_checks(**payload["ratio"]),
    }
    from cultionet_tpu_torch.train.fit import fit

    got = fit(payload["fit_params"], device="cpu")
    result["fit"] = {
        "history": got.history,
        "steps_per_epoch": got.steps_per_epoch,
        "step": got.state.step,
        "state": got.state.model.state_dict(),
    }
    torch.save(result, Path(out) / f"rank{rank}.pt")
