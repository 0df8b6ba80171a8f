"""The "16-mixed" (bf16) train step on the CPU at the CLI chip size.

torch's CPU bf16 ``conv3d`` weight gradient (oneDNN, torch 2.13.0+cpu)
crashes with a segmentation fault, or never returns, for a 1x1 spatial
kernel from about 99 x 99 pixels on: the conv front end's time
convolutions (``models/temporal.py``, kernels (kT, 1, 1)) at 100 x 100
pixels. ``TimeConv`` computes them as the 2-D convolution of (B, C, T,
H*W) with an (O, C, kT, 1) kernel, the same parameters and sums. Each
check runs in a subprocess, so a crash fails one test and leaves the test
runner's worker alive.

- the time convolution alone at the shape that crashed, its bf16 output
  and gradients against the fp32 ones (bf16 rounding: 2e-2 of the largest
  entry; measured 2.9e-3 to 4.2e-3);
- one whole bf16 step at 4 x 12 x 100 x 100 x 3, hidden 8, NA, dilations
  [1, 2], dropout 0, its loss within 1e-2 (relative) of the fp32 step's on
  the same weights and batch (measured 3.3e-4).
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TIME_CONV = """
import copy, json, torch
from cultionet_tpu_torch.models.temporal import TimeConv
torch.set_num_threads(1)
g = torch.Generator().manual_seed(0)
conv = TimeConv(3, 8, (10, 1, 1), bias=False)
with torch.no_grad():
    conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.1)
x = torch.randn(4, 3, 10, 100, 100, generator=g)
grad = torch.randn(4, 8, 1, 100, 100, generator=g)
out = {}
for dtype in (torch.bfloat16, torch.float32):
    conv_d = copy.deepcopy(conv).to(dtype)
    xi = x.to(dtype).requires_grad_()
    y = conv_d(xi)
    gx, gw = torch.autograd.grad(y, (xi, conv_d.weight), grad.to(dtype))
    out[str(dtype)] = [t.detach().float() for t in (y, gx, gw)]
errors = [
    float((a - b).abs().max() / b.abs().max())
    for a, b in zip(out["torch.bfloat16"], out["torch.float32"])
]
print(json.dumps(errors))
"""

STEP = """
import json, numpy as np, torch
from cultionet_tpu_torch.data.synthetic import create_batch
from cultionet_tpu_torch.models import CultioNet
from cultionet_tpu_torch.train import step as S
from cultionet_tpu_torch.train.optim import build_optimizer
torch.set_num_threads(1)
batch = create_batch(
    num_time=12, height=100, width=100, batch_size=4,
    rng=np.random.default_rng(0),
)
losses = {}
for precision in ("bf16", "fp32"):
    model = CultioNet(in_time=12, hidden_channels=8, dilations=[1, 2],
                      dropout=0.0)
    state = S.create_train_state(
        model, build_optimizer("AdamW", 1e-3), seed=0, device="cpu"
    )
    step = S.make_train_step(precision=precision, device="cpu")
    state, logs = step(state, batch, torch.Generator().manual_seed(0))
    losses[precision] = float(logs["loss"])
print(json.dumps(losses))
"""


def _run(code: str, timeout: float) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=timeout,
    )
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    return proc.stdout.strip().splitlines()[-1]


def test_time_conv_bf16_gradient_at_100px():
    errors = json.loads(_run(TIME_CONV, timeout=120))
    assert max(errors) <= 2e-2, errors


def test_bf16_train_step_at_cli_chip_size():
    losses = json.loads(_run(STEP, timeout=240))
    assert abs(losses["bf16"] - losses["fp32"]) <= 1e-2 * abs(losses["fp32"])
