#!/usr/bin/env python3
"""Device times of the neighborhood-attention kernels (#1-#4) of several
checkouts of this repository, in turns, on one NVIDIA GPU.

    python3 na_kernels_ab.py ROOT [ROOT ...]

Each ROOT is a directory that holds a checkout's ``cultionet_tpu_torch``
package (for example the parent commit's, unpacked with ``git archive``
into a directory that ``.gitignore`` lists). Give the roots in turns
(parent, change, change, parent) to see the card drift between them. Each
runs in a process of its own, which builds that checkout's kernels and
times ``na2d_fwd`` at the predict path's bf16 shapes and
``na2d_fwd_drop``, ``na2d_bwd`` and ``na2d_bwd_drop`` (p = 0.2 for the
dropout pair) at the train path's, with this checkout's
``chip_smoke.device_ms`` (calls queued back to back on the card) and
``chip_smoke.median_ms`` (single calls, host dispatch included). It prints
the card's name and power limit, then one JSON line per root and call.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke():
    """This checkout's chip_smoke.py, whatever package ``sys.path`` finds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", HERE / "chip_smoke.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_root(root: Path) -> None:
    sys.path.insert(0, str(root))
    import torch

    from cultionet_tpu_torch.ops import natten_cuda

    package = Path(natten_cuda.__file__).resolve()
    if root not in package.parents:
        raise RuntimeError(f"imported {package}, not the package in {root}")
    smoke = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    seed = torch.tensor([12345], dtype=torch.int32, device="cuda")
    calls = [("na2d_fwd", shape, 0.0) for shape in smoke.MODEL_SHAPES]
    calls += [("na2d_fwd_drop", shape, 0.2) for shape in smoke.TRAIN_SHAPES]
    calls += [
        (name, shape, p)
        for shape in smoke.TRAIN_SHAPES
        for name, p in (("na2d_bwd", 0.0), ("na2d_bwd_drop", 0.2))
    ]
    for name, shape, p in calls:
        q, k, v = smoke.fused_qkv(shape, torch.bfloat16, gen)
        ks, dil = shape[5], shape[6]
        run_seed = seed if p > 0 else None
        if name.startswith("na2d_fwd"):

            def fn():
                return natten_cuda.launch_na2d_fwd(
                    q, k, v, ks, dil, p, run_seed
                )

            bound, _ = smoke.na_bound_ms(shape, q.element_size())
        else:
            g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)

            def fn():
                return natten_cuda.launch_na2d_bwd(
                    q, k, v, g, ks, dil, p, run_seed
                )

            bound, _ = smoke.na_bwd_bound_ms(shape, q.element_size())
        record = {
            "root": str(root),
            "kernel": name,
            "shape": list(shape[:5]),
            "kernel_size": ks,
            "dilation": dil,
            "dtype": "bfloat16",
            "ms": smoke.device_ms(fn),
            "call_ms": smoke.median_ms(fn),
            "bound_ms": bound,
        }
        record["share_of_bound"] = bound / record["ms"]
        print(json.dumps(record), flush=True)


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--root":
        time_root(Path(argv[1]).resolve())
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    for root in argv:
        subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--root", root],
            check=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
