"""The numbers that decide ``correct``, each computed the same way for
the program and for the control."""

import typing as T

import numpy as np
import torch

Tensor = torch.Tensor


def loss_gap(program: T.Sequence[float], reference: T.Sequence[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(program, reference))


def worst_leaf_gap(
    program: T.Mapping[str, float],
    reference: T.Mapping[str, float],
    leaves: T.Optional[T.Iterable[str]] = None,
) -> T.Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; and the leaf."""
    names = list(reference if leaves is None else leaves)
    floor = float(np.median([reference[n] for n in names]))
    gaps = {
        n: abs(program[n] - reference[n]) / max(reference[n], floor, 1e-30)
        for n in names
    }
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_leaf_gap(
    program: T.Mapping[str, float],
    reference: T.Mapping[str, float],
    leaves: T.Optional[T.Iterable[str]] = None,
) -> float:
    """The median over leaves of the same gap as ``worst_leaf_gap``."""
    names = list(reference if leaves is None else leaves)
    floor = float(np.median([reference[n] for n in names]))
    return float(np.median([
        abs(program[n] - reference[n]) / max(reference[n], floor, 1e-30)
        for n in names
    ]))


def moving_leaves(first_grad_norms: T.Mapping[str, float]) -> T.List[str]:
    """Leaves whose reference gradient is above a thousandth of the
    median leaf's: the others (a bias before a BatchNorm, say) move under
    Adam by round-off alone."""
    floor = 1e-3 * float(np.median(list(first_grad_norms.values())))
    return [n for n, v in first_grad_norms.items() if v > floor]


def output_gaps(program: np.ndarray, reference: np.ndarray) -> T.Tuple[float, float]:
    """Mean and largest absolute gap of fp32 outputs in [0, 1]."""
    diff = np.abs(np.asarray(program, np.float64) - np.asarray(reference, np.float64))
    return float(diff.mean()), float(diff.max())


def leaf_norms(tensors: T.Mapping[str, Tensor], scale: float = 1.0) -> T.Dict[str, float]:
    """Per-leaf L2 norms, in one host copy."""
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([tensors[n].detach().float().norm() for n in names]) * scale
    return dict(zip(names, norms.cpu().tolist()))
