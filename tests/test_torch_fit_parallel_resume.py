"""The port's ``fit`` on two CPU ranks that it launches itself, against
itself: FSDP and resume. The chips, weights and configuration are
``test_torch_fit_parallel.py``'s (2 epochs of 2 steps, ExponentialLR,
dropout 0, fp32).

- ``fsdp=True`` (``fsdp_min_size`` 128) against the plain 2-rank run:
  history 1e-5, parameters and statistics 1e-4 of the largest entry; its
  checkpoint holds whole tensors, as a single card's does;
- under FSDP a 1-epoch run resumed to 2 epochs equals the uninterrupted
  2-epoch FSDP run bit for bit: the checkpoint's whole tensors are
  sharded again on restore, and the optimizer's moments, both ranks'
  dropout generators and the shuffles come back;
- ``use_chipstore="stream"`` on two ranks, 1 epoch, against one process
  streaming the same store at the whole batch: history 1e-5, parameters
  and statistics 1e-4 of the largest entry; the ranks share one store
  file (``-p0-``), which rank 0 built.
"""

import pytest
import torch

from test_torch_fit_parallel import (  # noqa: F401 (fixtures)
    _check_weights,
    _port_fit,
    chips,
    one_torch_thread,
    plain,
    weights,
)

FSDP = dict(fsdp=True, fsdp_min_size=128)


@pytest.fixture(scope="module")
def fsdp_run(chips, weights, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("fsdp")
    return ckpt, _port_fit(chips, ckpt, weights, **FSDP)


def test_fsdp_fit_matches_plain(fsdp_run, plain):
    ckpt, got = fsdp_run
    _, want = plain
    for got_row, want_row in zip(got.history, want.history):
        for key in ("loss", "val_loss", "val_score"):
            assert abs(got_row[key] - want_row[key]) <= 1e-5, key
    state = want.state.model.state_dict()
    _check_weights(got.state.model.state_dict(), state, 1e-4)
    saved = torch.load(
        ckpt / "last_store" / "last" / "model.pt", weights_only=True
    )["params"]
    for name, value in saved.items():
        assert value.shape == state[name].shape, name


def test_resume_equals_uninterrupted(chips, weights, fsdp_run, tmp_path):
    _, want = fsdp_run
    _port_fit(chips, tmp_path, weights, epochs=1, **FSDP)
    got = _port_fit(chips, tmp_path, weights, **FSDP)
    assert [row["epoch"] for row in got.history] == [1]
    assert got.history[0] == want.history[1]
    state = want.state.model.state_dict()
    for name, value in got.state.model.state_dict().items():
        assert torch.equal(value, state[name]), name
    assert got.state.optimizer.count == want.state.optimizer.count
    got_opt = got.state.optimizer.state_dict()["torch_optimizer"]["state"]
    want_opt = want.state.optimizer.state_dict()["torch_optimizer"]["state"]
    for index, slot in want_opt.items():
        for key, value in slot.items():
            assert torch.equal(got_opt[index][key], value), (index, key)


def test_stream_fit_on_two_ranks_shares_one_store(chips, weights, tmp_path):
    got = _port_fit(chips, tmp_path / "two", weights, epochs=1,
                    use_chipstore="stream")
    want = _port_fit(chips, tmp_path / "one", weights, epochs=1,
                     use_chipstore="stream", devices=1)
    assert got.state.step == want.state.step == 2
    for key in ("loss", "val_loss", "val_score"):
        assert abs(got.history[0][key] - want.history[0][key]) <= 1e-5, key
    _check_weights(
        got.state.model.state_dict(), want.state.model.state_dict(), 1e-4
    )
    assert [p.name[:9] for p in (tmp_path / "two").glob("*.cts")] == [
        "train-p0-"
    ]
