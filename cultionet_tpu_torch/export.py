"""Ahead-of-time model export for serving (port of cultionet_tpu/export.py,
where the program is StableHLO from ``jax.export``).

The complete predict program — int16 dequantize -> clip -> optional
Dynamic World log transform -> z-score normalization -> CultioNet eval
forward -> the three heads in fp32 — is traced ONCE with
``torch.export.export`` into a self-contained, versioned artifact:

* the weights (cast to the compute dtype once), the BatchNorm statistics
  and the normalization statistics live in the program; serving needs the
  artifact, ``torch`` and this module, no model code, checkpoint store or
  norm sidecar;
* the input contract is the wire format (int16 x 10000 chips) plus the
  (B,) chip-centroid lat/lon vectors;
* neighborhood and temporal attention, and the transformer front end's
  LayerNorms, stay in the program as the registered ops
  ``cultionet_tpu_torch::na2d``, ``cultionet_tpu_torch::temporal_attention``
  and ``cultionet_tpu_torch::layer_norm_rows``
  (``ops/natten.py::na2d_inference``, ``ops/temporal.py::
  temporal_inference``, ``ops/layer_norm.py::layer_norm_inference``): an
  artifact exported on the card launches the
  hand-written kernels, one exported on the CPU computes their plain
  versions. ``torch.export`` bakes the device into the program, so export
  on the device that serves. There is no kernel-free fallback: an op that
  cannot be traced makes the export raise.

The artifact is one zip file (``.cnx``): ``program.pt2``
(``torch.export.save``) and ``meta.json`` with the JAX manifest's keys.
``export_predictor`` / ``load_predictor`` are the file-level API; the
command line exposes them as ``export``.

A loaded card artifact called on inputs of its fixed geometry replays its
program as one CUDA graph (``ExportedPredictor.call_on_device``,
``eager_reason``): the host then launches one graph a call where the
exported module dispatches its operators one by one.
"""

import copy
import datetime
import io
import json
import threading
import typing as T
import zipfile
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from .data.batch import dequantize
from .data.constant import SCALE_FACTOR
from .enums import InferenceNames
from .ops import layer_norm as _layer_norm_ops  # noqa: F401  (the LayerNorm op)
from .ops import natten as _natten_ops  # noqa: F401  (registers the NA op)
from .ops import temporal as _temporal_ops  # noqa: F401  (the temporal op)
from .ops import flags
from .ops.flags import cuda_natten_enabled, cuda_temporal_enabled
from .train.precision import resolve_dtype
from .utils import profiling
from .utils.device import resolve_device
from .utils.logging import set_color_logger
from .utils.profiling import span, to_device, to_host

logger = set_color_logger(__name__)

# Bump when the serve program's calling convention (inputs/outputs) changes.
SERVE_ABI_VERSION = 1

# The serve program sanitizes wire inputs as the dataset pipeline does
# (data/datasets.py::ChipDataset._scale): negative nodata sentinels and
# int16 values above 10000 are clipped, not fed to the model.
CLIP_MIN = 1e-9
CLIP_MAX = 1.0

FORMAT = "torch.export"
_PROGRAM_NAME = "program.pt2"
_META_NAME = "meta.json"
OP_NAMESPACE = "cultionet_tpu_torch"

OUTPUT_NAMES = (
    str(InferenceNames.DISTANCE),
    str(InferenceNames.EDGE),
    str(InferenceNames.CROP),
)

# Eager calls on a side stream before a capture, as train/graphed.py:
# cuDNN's algorithm choice and lazy kernel set-up happen outside it.
WARMUP = 2


class ServeProgram(nn.Module):
    """``forward(x, lat, lon)``: int16 (B, T, H, W, C) chips x 10000 and
    (B,) fp32 coordinates -> fp32 (distance, edge, crop), step for step
    the JAX ``serve_fn``. The model's weights are a compute-dtype copy; the
    norm statistics and the coordinates stay fp32 (a ``use_latlon`` model
    embeds the coordinates; any other leaves them unused)."""

    def __init__(
        self,
        model: nn.Module,
        norm_mean: T.Optional[np.ndarray],
        norm_std: T.Optional[np.ndarray],
        precision: str,
        log_transform: bool,
    ):
        super().__init__()
        self.compute_dtype = resolve_dtype(precision)
        self.model = copy.deepcopy(model).eval().to(dtype=self.compute_dtype)
        self.log_transform = bool(log_transform)
        self.normalized = norm_mean is not None
        if self.normalized:
            self.register_buffer(
                "norm_mean", torch.as_tensor(np.asarray(norm_mean, np.float32))
            )
            self.register_buffer(
                "norm_std", torch.as_tensor(np.asarray(norm_std, np.float32))
            )

    def forward(self, x, lat, lon):
        vals = dequantize(x).clamp(CLIP_MIN, CLIP_MAX)
        if self.log_transform:
            vals = torch.log(vals * 50.0 + 1.0).clamp_min(CLIP_MIN)
        if self.normalized:
            vals = (vals - self.norm_mean) / self.norm_std
        outputs = self.model(vals.to(self.compute_dtype), lat, lon)
        return tuple(outputs[name].to(torch.float32) for name in OUTPUT_NAMES)


def build_serve_fn(
    state,
    norm_mean: T.Optional[np.ndarray] = None,
    norm_std: T.Optional[np.ndarray] = None,
    precision: str = "bf16",
    log_transform: bool = False,
    device=None,
) -> ServeProgram:
    """The full predict program over a trained state (a ``TrainState`` or
    the model itself) as an eager module on ``device`` (by default the
    model's): ``serve(x, lat, lon)`` on int16 (B, T, H, W, C) chips
    returns the fp32 ``(distance, edge, crop)`` rasters."""
    model = getattr(state, "model", state)
    if device is None:
        device = next(model.parameters()).device
    return ServeProgram(
        model, norm_mean, norm_std, precision, log_transform
    ).to(device)


def kernel_ops(program: torch.export.ExportedProgram) -> T.Dict[str, int]:
    """How often the program's graph calls each op of the port's namespace
    (``cultionet_tpu_torch::na2d``: 3 in the CLI-default model)."""
    counts: T.Dict[str, int] = {}
    for node in program.graph_module.graph.nodes:
        target = node.target
        if node.op == "call_function" and hasattr(target, "namespace"):
            if target.namespace == OP_NAMESPACE:
                name = f"{OP_NAMESPACE}::{target._opname}"
                counts[name] = counts.get(name, 0) + 1
    return counts


def export_state(
    state,
    out_file: T.Union[str, Path],
    *,
    in_time: int,
    in_channels: int,
    batch_size: int = 8,
    chip_size: int = 100,
    precision: str = "bf16",
    norm_mean: T.Optional[np.ndarray] = None,
    norm_std: T.Optional[np.ndarray] = None,
    log_transform: bool = False,
    device="cuda",
    extra_meta: T.Optional[dict] = None,
) -> Path:
    """Export a trained state (``TrainState`` or model) as a serving
    artifact for ``device``: the card unless ``device="cpu"``.

    Shapes are static: one artifact per (batch, chip) geometry. On the
    card the attention ops must run the kernels: an export with
    ``set_cuda_natten(False)`` or ``set_cuda_temporal(False)`` in force
    raises rather than bake the plain versions into a card program.
    """
    device = resolve_device(device)
    if device.type == "cuda" and not (
        cuda_natten_enabled() and cuda_temporal_enabled()
    ):
        raise RuntimeError(
            "export on the card needs the attention kernels: "
            "set_cuda_natten(False) or set_cuda_temporal(False) is in force"
        )
    serve = build_serve_fn(
        state, norm_mean, norm_std, precision, log_transform, device
    )
    x_shape = (batch_size, in_time, chip_size, chip_size, in_channels)
    example = (
        torch.zeros(x_shape, dtype=torch.int16, device=device),
        torch.zeros((batch_size,), dtype=torch.float32, device=device),
        torch.zeros((batch_size,), dtype=torch.float32, device=device),
    )
    with torch.no_grad():
        program = torch.export.export(serve, example)
    ops = kernel_ops(program)

    meta = {
        "abi_version": SERVE_ABI_VERSION,
        "format": FORMAT,
        "platforms": [device.type],
        "kernels": "cuda" if device.type == "cuda" else "plain",
        "ops": ops,
        "precision": precision,
        "inputs": {
            "x": {"shape": list(x_shape), "dtype": "int16",
                  "scale": int(SCALE_FACTOR), "clip": [CLIP_MIN, CLIP_MAX]},
            "lat": {"shape": [batch_size], "dtype": "float32"},
            "lon": {"shape": [batch_size], "dtype": "float32"},
        },
        "coords": (
            "required: the contract carries chip-centroid lat/lon for models "
            "that embed them on the unit sphere; (0, 0) is a real location, "
            "not a null"
        ),
        "outputs": list(OUTPUT_NAMES),
        "normalized": norm_mean is not None,
        "log_transform": bool(log_transform),
        "created": datetime.datetime.now().isoformat(timespec="seconds"),
        "torch_version": torch.__version__,
    }
    if extra_meta:
        meta.update(extra_meta)

    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    out_path = Path(out_file)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(out_path, "w") as zf:
        # The program is a zip archive of its own, mostly weights: stored.
        zf.writestr(_PROGRAM_NAME, buffer.getvalue(), zipfile.ZIP_STORED)
        zf.writestr(_META_NAME, json.dumps(meta, indent=2), zipfile.ZIP_DEFLATED)
    return out_path


def export_predictor(
    ckpt_dir: T.Union[str, Path],
    out_file: T.Union[str, Path],
    *,
    batch_size: int = 8,
    chip_size: int = 100,
    precision: str = "bf16",
    which: str = "best",
    norm_file: T.Optional[T.Union[str, Path]] = None,
    log_transform: T.Optional[bool] = None,
    allow_unnormalized: bool = False,
    device="cuda",
) -> Path:
    """Load a checkpoint store and its norm sidecar and export them for
    serving on ``device``.

    The program must reproduce the training-time input pipeline, so the two
    pipeline flags are resolved defensively, as the JAX package does:

    * ``log_transform`` comes from the checkpoint's hyperparams; ``None``
      with a checkpoint that predates the record is an error, and an
      explicit value that contradicts the record is an error;
    * missing norm statistics are an error unless the checkpoint records
      unnormalized training or ``allow_unnormalized=True``; a norm sidecar
      beside a checkpoint that records unnormalized training is ignored.
    """
    from .model import checkpoint_hyperparams, load_model
    from .utils.normalize import NormValues

    hp = checkpoint_hyperparams(ckpt_dir, which)

    if log_transform is None:
        if "log_transform" in hp:
            log_transform = bool(hp["log_transform"])
        else:
            raise ValueError(
                "This checkpoint predates log_transform tracking, so the "
                "training-time input pipeline is unknown. Re-export with an "
                "explicit choice: --log-transform yes|no "
                "(log_transform=True/False)."
            )
    elif "log_transform" in hp and bool(hp["log_transform"]) != bool(
        log_transform
    ):
        raise ValueError(
            f"Explicit log_transform={bool(log_transform)} contradicts the "
            f"checkpoint's recorded training pipeline "
            f"(log_transform={bool(hp['log_transform'])}). Drop the flag "
            "(auto uses the recorded value) or re-train with the pipeline "
            "you want to serve."
        )

    norm_mean = norm_std = None
    if norm_file is not None and Path(norm_file).is_file():
        norm = NormValues.from_file(norm_file)
        norm_mean, norm_std = norm.dataset_mean, norm.dataset_std
    if norm_mean is not None and hp.get("normalized_input") is False:
        logger.warning(
            f"Ignoring norm sidecar {norm_file}: the checkpoint records "
            "unnormalized training input (normalized_input=False) — "
            "baking z-score normalization would diverge from the "
            "training pipeline. Exporting unnormalized."
        )
        norm_mean = norm_std = None
    if norm_mean is None and hp.get("normalized_input") is not False:
        msg = (
            f"No normalization sidecar found (norm_file={norm_file}); the "
            "checkpoint "
            + (
                "records normalized training input"
                if hp.get("normalized_input")
                else "does not record whether training input was normalized"
            )
            + ". Exporting without z-score normalization diverges from the "
            "training pipeline."
        )
        if not allow_unnormalized:
            raise ValueError(
                msg + " Pass --allow-unnormalized (allow_unnormalized=True) "
                "to export anyway."
            )
        logger.warning(msg + " Proceeding because allow_unnormalized=True.")

    _, model = load_model(ckpt_dir, which=which, device=device)
    return export_state(
        model,
        out_file,
        in_time=int(hp.get("in_time", 12)),
        in_channels=int(hp.get("in_channels", 3)),
        batch_size=batch_size,
        chip_size=chip_size,
        precision=precision,
        norm_mean=norm_mean,
        norm_std=norm_std,
        log_transform=log_transform,
        device=device,
        extra_meta={"hyperparams": {
            k: v for k, v in hp.items()
            if isinstance(v, (int, float, str, bool, list, type(None)))
        }},
    )


def eager_reason(meta: dict, x, lat, lon) -> T.Optional[str]:
    """Why a call of the artifact described by ``meta`` on ``(x, lat,
    lon)`` runs its program eagerly; None where it can replay a CUDA graph:
    a card artifact, the three inputs on one CUDA device, and each input's
    shape and dtype those of ``meta["inputs"]`` (the artifact's fixed
    geometry). Inputs on another card than the program's weights pass, and
    the eager warm-up calls raise for them as the module does."""
    if meta["platforms"][0] != "cuda":
        return "not a card artifact"
    inputs = {"x": x, "lat": lat, "lon": lon}
    if any(v.device.type != "cuda" or v.device != x.device
           for v in inputs.values()):
        return "the inputs are not on one card"
    for name, value in inputs.items():
        spec = meta["inputs"][name]
        if (list(value.shape) != list(spec["shape"])
                or value.dtype != getattr(torch, spec["dtype"])):
            return f"{name} is not the artifact's {spec['dtype']} {spec['shape']}"
    return None


def _backend_settings() -> tuple:
    """The settings under which cuDNN and cuBLAS pick their algorithms when
    a program runs: a graph keeps those of its capture."""
    cudnn = torch.backends.cudnn
    return (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


class ExportedPredictor:
    """A loaded serving artifact: ``pred(x, lat, lon) -> dict`` of fp32
    numpy rasters. Needs only torch and the op registrations: no model code
    of this package runs.

    Where ``eager_reason`` finds nothing against it, ``call_on_device``
    runs the program as a CUDA graph: per key (the inputs' card and the
    backend settings) the first ``WARMUP`` calls run eagerly on a side
    stream, the next captures the program on static copies of the inputs
    and replays it, and every later call copies its inputs into them,
    replays and returns clones of the outputs (the next replay overwrites
    the graph's). Each call counts its kernel launches
    (``ops/flags.py::launch_tables``) once, as an eager call does, and
    the counters ``graph_captures`` and ``graph_replays``. A lock holds
    each graphed call's launches whole, and a replay waits on the card for
    the last call's clones: callers may share the predictor between
    threads and streams. Every other call runs the module eagerly.
    ``call_on_device`` returns without waiting for the card; ``__call__``
    waits inside its span ``serve.program``."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict):
        self.meta = meta
        self.device = torch.device(meta["platforms"][0])
        self.batch_size = int(meta["inputs"]["x"]["shape"][0])
        if self.device.type == "cuda":
            # The program's host constants (the resize matrices, made from
            # numpy while it was traced) go to its card once: else every
            # call copies them from pageable memory, which a CUDA graph
            # cannot capture. Their values and the ops on them stay.
            card = next(iter(program.state_dict.values())).device
            program = move_to_device_pass(program, {"cpu": str(card)})
        self.program = program
        self._module = program.module()
        self._lock = threading.Lock()
        self._key: T.Optional[tuple] = None
        self._warm = 0
        self._graph = None
        self._static: T.Tuple[torch.Tensor, ...] = ()
        self._outputs: T.Tuple[torch.Tensor, ...] = ()
        self._launches: T.List[T.Dict[str, int]] = []
        self._stream = None
        self._done = None

    def __call__(
        self,
        x: np.ndarray,
        lat: T.Optional[np.ndarray] = None,
        lon: T.Optional[np.ndarray] = None,
        *,
        fill_coords: bool = False,
    ) -> T.Dict[str, np.ndarray]:
        b = x.shape[0]
        if (lat is None or lon is None) and not fill_coords:
            raise ValueError(
                "lat/lon chip centroids are required: the contract carries "
                "coordinates for models that embed them on the unit sphere, "
                "and (0, 0) is a real location — zero-filling silently skews "
                "predictions for models with learned geographic priors. Pass "
                "fill_coords=True to explicitly serve with zero coordinates."
            )
        if lat is None:
            lat = np.zeros((b,), np.float32)
        if lon is None:
            lon = np.zeros((b,), np.float32)
        with span("serve.call"):
            with span("serve.copy"):
                inputs = [
                    to_device(torch.as_tensor(np.asarray(a, dtype)), self.device)
                    for a, dtype in ((x, np.int16), (lat, np.float32),
                                     (lon, np.float32))
                ]
            with span("serve.program"):
                outs = self.call_on_device(*inputs)
                if self.device.type == "cuda":
                    # The span ends on the program's completion: else the
                    # readback's blocking copy holds the card's time.
                    torch.cuda.current_stream(self.device).synchronize()
            with span("serve.readback"):
                return {
                    name: to_host(val).numpy()
                    for name, val in zip(self.meta["outputs"], outs)
                }

    def call_on_device(self, x, lat, lon):
        """Run the program on tensors already on its device and return its
        output tuple as it is (no host copy, no zero-fill): the serving hot
        path, and the call benchmarks time."""
        with torch.inference_mode():
            if eager_reason(self.meta, x, lat, lon) is not None:
                return self._module(x, lat, lon)
            with self._lock:
                return self._graphed((x, lat, lon))

    def plan(self, key: tuple) -> str:
        """What a graphed call with ``key`` does: "eager" (a warm-up),
        "capture" or "replay". A new key drops the graph."""
        if key != self._key:
            # The graph's static tensors go with it (they hold its memory).
            self._key, self._warm, self._graph = key, 0, None
            self._static, self._outputs, self._launches = (), (), []
            self._stream = self._done = None
        if self._warm < WARMUP:
            return "eager"
        return "replay" if self._graph is not None else "capture"

    def _graphed(self, inputs: T.Tuple[torch.Tensor, ...]):
        action = self.plan((inputs[0].device, _backend_settings()))
        if action == "eager":
            outs = self._on_side_stream(inputs)
            # Counted once it ran: a call the module rejects never
            # brings the capture nearer.
            self._warm += 1
            return outs
        outs = self._capture(inputs) if action == "capture" else self._replay(inputs)
        profiling.add_count("graph_replays")
        return outs

    def _on_side_stream(self, inputs):
        if self._stream is None:
            self._stream = torch.cuda.Stream(inputs[0].device)
        side, main = self._stream, torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            outs = self._module(*inputs)
        main.wait_stream(side)
        return outs

    def _capture(self, inputs):
        self._static = tuple(value.clone() for value in inputs)
        before = [dict(table) for table in flags.launch_tables()]
        graph = torch.cuda.CUDAGraph()
        # Capture starts with a device synchronize: the clones are done.
        # "thread_local": other threads' copies and waits, such as a
        # concurrent ``__call__``'s, leave this capture valid.
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            self._outputs = tuple(self._module(*self._static))
        self._launches = [
            {k: table[k] - old.get(k, 0) for k in table if table[k] != old.get(k, 0)}
            for table, old in zip(flags.launch_tables(), before)
        ]
        self._graph = graph
        profiling.add_count("graph_captures")
        # The capture ran the module's Python (the launch tables moved)
        # and recorded its launches; the replay runs them.
        graph.replay()
        return self._clones()

    def _replay(self, inputs):
        # The last call's clones are done before the static tensors are
        # written, on whichever stream that call ran.
        torch.cuda.current_stream().wait_event(self._done)
        for static, value in zip(self._static, inputs):
            static.copy_(value)
        self._graph.replay()
        for table, moved in zip(flags.launch_tables(), self._launches):
            for name, n in moved.items():
                table[name] += n
        return self._clones()

    def _clones(self):
        """The outputs as the caller keeps them: the next replay
        overwrites the graph's."""
        outs = tuple(out.clone() for out in self._outputs)
        self._done = torch.cuda.Event()
        self._done.record()
        return outs


def load_predictor(path: T.Union[str, Path]) -> ExportedPredictor:
    """Read an artifact written by ``export_state``: its ABI is checked
    before the program is deserialized, and a card artifact needs a card."""
    with zipfile.ZipFile(Path(path)) as zf:
        meta = json.loads(zf.read(_META_NAME).decode())
        if meta.get("abi_version") != SERVE_ABI_VERSION:
            raise ValueError(
                f"Artifact ABI {meta.get('abi_version')} != "
                f"supported {SERVE_ABI_VERSION}"
            )
        if meta.get("format") != FORMAT or _PROGRAM_NAME not in zf.namelist():
            raise ValueError(
                f"{path} is not a {FORMAT} serving artifact (format "
                f"{meta.get('format')!r}, kernels {meta.get('kernels')!r}): "
                "an artifact of the JAX package (cultionet_tpu, a StableHLO "
                "program.bin) is read by cultionet_tpu.export.load_predictor"
            )
        platform = meta["platforms"][0]
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{path} is a card program (platforms {meta['platforms']}) "
                "and torch.cuda.is_available() is False"
            )
        program = torch.export.load(io.BytesIO(zf.read(_PROGRAM_NAME)))
    return ExportedPredictor(program, meta)
