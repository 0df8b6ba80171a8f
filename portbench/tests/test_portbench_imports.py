"""Nothing the benchmark runs loads JAX or the JAX package; the check
compares whole top-level module names."""

import json
import subprocess
import sys
import types

from portbench import harness
from portbench.testing import ROOT, run_cell


def test_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cultionet_tpu_torch_like", types.ModuleType("x"))
    assert "cultionet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cultionet_tpu.models", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["cultionet_tpu"]


def test_harness_and_program_load_no_jax():
    code = (
        "import sys, pathlib\n"
        "import portbench.harness as h, portbench.control, portbench.roofline\n"
        "for d in ('train', 'predict', 'serve'):\n"
        "    h.load_module(h.ROOT / 'portbench' / 'drivers' / f'{d}.py', 'd_' + d)\n"
        "for p in (h.ROOT / 'portbench' / 'metrics').glob('*.py'):\n"
        "    h.load_module(p, 'm_' + p.stem.replace('.', '_'))\n"
        "import cultionet_tpu_torch.train.fit, cultionet_tpu_torch.export\n"
        "import cultionet_tpu_torch.predict\n"
        "print(h.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_metric_that_loads_jax_fails_the_run(tiny_root, capsys, tmp_path, monkeypatch):
    """The check runs last, after every per-layer metric has been read: a
    metric file that imports (a stub of) ``jax`` leaves the run without a
    result."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub.parent))
    (tiny_root / "portbench/metrics/loads_jax.serve.py").write_text(
        "import jax\n\n\ndef read(ctx):\n    return 1.0\n"
    )
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "loads_jax.serve", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "serve",
                               "moves": "serve_p95_ms", "workloads": ["serve-conv-b8"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    had_jax = "jax" in sys.modules
    try:
        code, result, err = run_cell(tiny_root, "serve-conv-b8", capsys, trace=1)
    finally:
        if not had_jax:
            sys.modules.pop("jax", None)
    assert code != 0 and result is None
    assert "jax" in err and "JAX" in err
