"""Transfer learning (``cultionet_tpu_torch/model.py::fit_transfer``)
against the JAX ``fit(pretrained_state=...)``: ``finetune="all"`` (every
parameter trained), and ``finetune="fc"`` with an active gradient clip
(1e-3), whose global norm counts the frozen gradients, as optax's
``clip_by_global_norm`` before the freezing mask does. The fixtures and
the check are ``test_torch_transfer.py``'s, which holds the ``None`` and
``"fc"`` cases.
"""

import pytest

from test_torch_transfer import (  # noqa: F401 (fixtures)
    check_fit_transfer,
    chips,
    one_torch_thread,
    pretrained,
)


@pytest.mark.parametrize(
    "finetune, clip", [("all", None), ("fc", 1e-3)], ids=["all", "fc-clip"]
)
def test_fit_transfer_matches_jax(
    chips, pretrained, tmp_path, monkeypatch, finetune, clip
):
    check_fit_transfer(
        chips, pretrained, tmp_path, monkeypatch, finetune, clip=clip
    )
