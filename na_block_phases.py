#!/usr/bin/env python3
"""Where the time of the fused NA block kernel (#7, ``na_block_fwd``) goes,
phase by phase, on one NVIDIA GPU.

    python3 na_block_phases.py

It copies ``cultionet_tpu_torch/ops/csrc/na_block_fwd.cu`` into a temporary
directory with a probe at each phase boundary (a block barrier, then
thread 0 adds the SM clocks since the last probe to a device counter),
builds the copy with ``nvcc`` as ``ops/build.py`` builds the kernel, and
launches it on the layout ``prepare_weights`` makes at
``chip_smoke.NA_BLOCK_SITES`` in bf16. The phases: x's copy into shared
memory, LN1, the QKV products with their epilogues, the attention, the
projection, LN2 with the store. It prints the card's name and power limit,
then one JSON line per site: the probed launch's time (the barriers add a
few percent) and the mean SM clocks a block spends in each phase. The
package's own build is not touched.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke
from cultionet_tpu_torch.ops import build, na_block_cuda

PHASES = ("x_load", "ln1", "qkv", "attention", "projection", "ln2_store")

# (anchor in the source, text put before it, text put after it): each
# PHASE_END(k) closes phase k.
PROBES = [
    ("namespace {\n", "", "__device__ unsigned long long phase_clocks[8];\n"),
    (
        "  const bool vec = geo.vec > 1;\n",
        "",
        "  long long phase_t0 = clock64();\n"
        "#define PHASE_END(k) __syncthreads(); if (threadIdx.x == 0) { "
        "long long now = clock64(); atomicAdd(&phase_clocks[k], "
        "(unsigned long long)(now - phase_t0)); phase_t0 = now; }\n",
    ),
    ("  cp_async_wait<0>();\n  __syncthreads();\n", "", "  PHASE_END(0)\n"),
    ("  int idx = 0;  // the stream's chunk in use\n", "  PHASE_END(1)\n", ""),
    (
        "    // (b) q, k and v of this pass's heads.\n",
        "    if (pass > 0) { PHASE_END(3) }\n",
        "",
    ),
    ("    __syncthreads();\n    // (c)\n", "", "    PHASE_END(2)\n"),
    ("  // (d) the projection", "  PHASE_END(3)\n", ""),
    ("  // + b_proj, LN2 and the store", "  PHASE_END(4)\n", ""),
    ("  }\n}\n\n// The host's checks", "  PHASE_END(5)\n", ""),
]
READERS = """
extern "C" int phase_clocks_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, phase_clocks, sizeof(phase_clocks));
}
extern "C" int phase_clocks_reset() {
  unsigned long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(phase_clocks, zero, sizeof(zero));
}
"""


def probed_source() -> str:
    """The kernel's source with the probes in (raises if an anchor moved)."""
    src = (build.CSRC / "na_block_fwd.cu").read_text()
    for anchor, before, after in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"na_block_phases: anchor not unique: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    return src + READERS


def build_probed(workdir: Path) -> ctypes.CDLL:
    source = workdir / "na_block_phases.cu"
    source.write_text(probed_source())
    library = workdir / "libna_block_phases.so"
    subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
         str(library), str(source)],
        check=True,
    )
    lib = ctypes.CDLL(str(library))
    registered = build.LIBRARIES["na_block_fwd"]
    lib.na_block_fwd.argtypes = list(registered.signatures["na_block_fwd"])
    lib.na_block_fwd.restype = ctypes.c_int
    lib.phase_clocks_read.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("na_block_phases: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_probed(Path(tmp))
        for site in chip_smoke.NA_BLOCK_SITES:
            b, h, w, c, heads, k, d = site
            weights = na_block_cuda.prepare_weights(
                chip_smoke.na_block_params_on_card(c, gen), heads
            )
            x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
            out = torch.empty_like(x)
            plan = na_block_cuda._tile_plan(h, w, k, d, c, heads, 2, b)
            args = (
                1, na_block_cuda._vector_width(x, out), x.data_ptr(),
                *(weights[key].data_ptr() for key in (
                    "ln1_scale", "ln1_bias", "w_qkv", "b_qkv", "w_proj",
                    "b_proj", "ln2_scale", "ln2_bias",
                )),
                out.data_ptr(), b, h, w, c, heads, k, d, plan.args, 1e-6,
            )

            def launch():
                stream = torch.cuda.current_stream().cuda_stream
                code = lib.na_block_fwd(*args, stream)
                if code != 0:
                    raise RuntimeError(f"na_block_fwd launch failed: {code}")

            launch()
            torch.cuda.synchronize()
            lib.phase_clocks_reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            torch.cuda.synchronize()
            clocks = (ctypes.c_ulonglong * 8)()
            lib.phase_clocks_read(clocks)
            blocks = b * d * d * plan.tiles_h * plan.tiles_w
            print(json.dumps({
                "site": list(site), "dtype": "bfloat16",
                "tile": [plan.th, plan.tw], "blocks": blocks,
                "probed_ms": start.elapsed_time(end),
                "clocks_per_block": {
                    name: clocks[i] / blocks for i, name in enumerate(PHASES)
                },
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
