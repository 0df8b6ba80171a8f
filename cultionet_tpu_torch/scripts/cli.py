"""The command line of the port (port of cultionet_tpu/scripts/cli.py):
``python -m cultionet_tpu_torch <command>``, or ``cultionet-tpu-torch``.

The subcommands, flags and defaults are the JAX package's: ``create`` burns
each region's polygons into train chips, ``train`` fits the model on them
(``train-transfer`` from a trained checkpoint), ``create-predict`` cuts a
scene into window chips and ``predict`` writes their blended prediction as
a 3-band GeoTIFF; ``export`` writes a serving artifact
(``export.py``); ``predict-transfer``, ``skfoldcv`` (spatial folds, or one
fold per named polygon of a partition file) and ``version`` as well. The
argument tree comes from ``args.json`` (the JAX ``args.yml`` as JSON, so
parsing needs no PyYAML); every invocation is archived as JSON under
``<project>/commands/`` and the class metadata persists to
``data/classes.info``.

A region is ``<project>/time_series_vars/<region>/`` holding ``scene.npz``
(``x`` (T, H, W, C), ``bounds`` (4,), ``cell_res`` (), optionally ``crs``)
or per-variable GeoTIFFs, and its polygons (``data/vector.py``).

``main(argv, device="cuda")`` runs on the card; the tests pass
``device="cpu"``. Without a card and with ``device="cuda"`` it raises.

``import-torch`` converts a reference (jgrss/cultionet) Lightning
checkpoint into the store ``ckpt/last_store`` that ``predict``,
``train-transfer`` and ``model.py::load_model`` read
(``utils/torch_params.py``).

Deliberate differences: ``export --platform`` takes ``cuda`` or ``cpu``
(the artifact runs on the device it was exported on), not JAX's StableHLO
platforms. ``train --devices N`` launches N ranks (``--fsdp``
shards the large parameters) and ``predict --devices N`` runs a model
replica on each of N cards (``train/fit.py``, ``predict.py``).
``--use-chipstore stream|hbm|auto``,
``--device-augment`` and ``--device-augment-noise`` run the device data
path (``train/fit.py``).
"""

import argparse
import datetime
import json
import sys
import typing as T
from pathlib import Path

import numpy as np

from .. import __version__
from ..config import CultionetParams
from ..data.create import (
    _fork_available,
    create_predict_dataset,
    create_train_batch,
)
from ..data.datasets import ChipDataset
from ..data.loader import ChipLoader
from ..enums import CLISteps, Destinations, ModelNames
from ..utils.device import resolve_device
from ..utils.logging import set_color_logger
from ..utils.normalize import NormValues
from ..utils.project_paths import ProjectPaths, setup_paths

logger = set_color_logger("cultionet_tpu_torch")

PROG = "cultionet-tpu-torch"
ARGS_SPEC = Path(__file__).parent / "args.json"

SUBCOMMAND_GROUPS = {
    CLISteps.CREATE: ["shared_project", "shared_dates", "shared_create"],
    CLISteps.CREATE_PREDICT: [
        "shared_project",
        "shared_dates",
        "shared_create",
        "create_predict",
    ],
    CLISteps.TRAIN: ["shared_project", "shared_model", "train"],
    CLISteps.TRAIN_TRANSFER: [
        "shared_project",
        "shared_model",
        "train",
        "transfer",
    ],
    CLISteps.PREDICT: ["shared_project", "shared_dates", "predict"],
    CLISteps.PREDICT_TRANSFER: ["shared_project", "shared_dates", "predict"],
    CLISteps.SKFOLDCV: ["shared_project", "shared_model", "train", "skfoldcv"],
    CLISteps.IMPORT_TORCH: ["shared_project", "shared_model", "import_torch"],
    CLISteps.EXPORT: ["shared_project", "export"],
    CLISteps.VERSION: [],
}

EXPORT_PLATFORMS = ("cuda", "cpu")


def build_parser() -> argparse.ArgumentParser:
    """The parser of every subcommand from the argument spec: groups of
    {dest: {"flags", "kwargs"}}, composed per subcommand."""
    spec = json.loads(ARGS_SPEC.read_text())
    parser = argparse.ArgumentParser(
        prog=PROG,
        description=(
            "Crop-field boundary segmentation from satellite image time "
            "series, in PyTorch on an NVIDIA GPU"
        ),
    )
    subparsers = parser.add_subparsers(dest="command", required=True)
    for command, groups in SUBCOMMAND_GROUPS.items():
        sub = subparsers.add_parser(str(command))
        for group in groups:
            for name, arg in spec[group].items():
                kwargs = dict(arg.get("kwargs", {}))
                if "type" in kwargs and isinstance(kwargs["type"], str):
                    kwargs["type"] = {"int": int, "float": float}[
                        kwargs["type"]
                    ]
                sub.add_argument(*arg["flags"], dest=name, **kwargs)
    return parser


def log_command(
    ppaths: ProjectPaths,
    args: argparse.Namespace,
    argv: T.Optional[T.Sequence[str]] = None,
) -> None:
    """Archive the invocation as ``commands/<command>_<stamp>.json``."""
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f")
    words = [PROG, *argv] if argv is not None else sys.argv
    payload = {
        "command": " ".join(str(w) for w in words),
        "args": {
            k: (str(v) if isinstance(v, Path) else v)
            for k, v in vars(args).items()
        },
        "version": __version__,
    }
    (ppaths.commands_path / f"{args.command}_{stamp}.json").write_text(
        json.dumps(payload, indent=2)
    )


def read_project_config(ppaths: ProjectPaths) -> dict:
    """``<project>/config.yml`` (image_vis, regions, the seasonal window),
    read with PyYAML; {} when there is no such file. A config file that
    exists where PyYAML is not installed raises, naming the file: it is
    never skipped."""
    cfg_file = Path(ppaths.project_path) / "config.yml"
    if not cfg_file.is_file():
        return {}
    try:
        import yaml
    except ImportError as exc:
        raise RuntimeError(
            f"{cfg_file} exists but PyYAML is not installed to read it; "
            "install PyYAML or move the file away"
        ) from exc
    loaded = yaml.safe_load(cfg_file.read_text()) or {}
    return loaded if isinstance(loaded, dict) else {}


def load_scene(
    region_path: Path,
    window: T.Optional[dict] = None,
    ref_res: T.Optional[float] = None,
    resampling: str = "nearest",
    date_format: T.Optional[str] = None,
    class_column: T.Optional[str] = None,
    replace_dict: T.Optional[T.Dict[int, int]] = None,
    feature_pattern: T.Optional[str] = None,
    image_vis: T.Optional[T.Sequence[str]] = None,
    skip_index: int = 0,
) -> T.Tuple[np.ndarray, tuple, float, T.Optional[str], T.Optional[list]]:
    """A region's scene (``scene.npz``, else its GeoTIFF time series through
    ``data/geotiff.py::read_time_series``, with the seasonal ``window``,
    ``ref_res`` resampling, ``feature_pattern`` variable directories and
    ``skip_index``) and its polygons: (x, bounds, cell_res, crs,
    polygons)."""
    scene_file = region_path / "scene.npz"
    crs = None
    if scene_file.is_file():
        with np.load(scene_file, allow_pickle=False) as data:
            x = data["x"]
            bounds = tuple(float(v) for v in data["bounds"])
            cell_res = float(data["cell_res"])
            if "crs" in data.files:
                crs = str(data["crs"])
    else:
        from ..data.geotiff import read_time_series

        var_dirs = None
        if feature_pattern:
            root = region_path.parent
            var_dirs = [
                root
                / feature_pattern.format(
                    region=region_path.name, image_vi=vi
                )
                for vi in (image_vis or [])
            ]
            if not var_dirs:
                raise ValueError(
                    "--feature-pattern requires image_vis in config.yml"
                )
        x, bounds, cell_res, crs = read_time_series(
            region_path,
            ref_res=ref_res,
            resampling=resampling,
            date_format=date_format,
            var_dirs=var_dirs,
            skip_index=skip_index,
            **(window or {}),
        )

    from ..data.vector import read_region_polygons

    polygons = read_region_polygons(
        region_path,
        bounds=bounds,
        project_path=region_path.parent.parent,
        class_column=class_column,
        replace_dict=replace_dict,
    )
    return x, bounds, cell_res, crs, polygons


def scene_crs(ppaths: ProjectPaths, region: T.Optional[str]) -> T.Optional[str]:
    """The region's CRS from its scene manifest, if recorded."""
    if not region:
        return None
    scene_file = ppaths.image_path / region / "scene.npz"
    if not scene_file.is_file():
        return None
    with np.load(scene_file, allow_pickle=False) as data:
        if "crs" in data.files:
            return str(data["crs"])
    return None


def iter_regions(
    ppaths: ProjectPaths, regions, base: T.Optional[Path] = None
) -> T.List[Path]:
    """The named regions' directories, else every directory under the
    imagery root but the project's own bookkeeping directories."""
    base = base if base is not None else ppaths.image_path
    if regions:
        return [base / r for r in regions]
    if not base.is_dir():
        return []
    aux = {str(d) for d in Destinations} | {"commands"}
    return sorted(
        p for p in base.iterdir() if p.is_dir() and p.name not in aux
    )


def write_classes_info(ppaths: ProjectPaths, max_crop_class: int) -> None:
    ppaths.classes_info_path.parent.mkdir(parents=True, exist_ok=True)
    ppaths.classes_info_path.write_text(
        json.dumps(
            {
                "max_crop_class": max_crop_class,
                "edge_class": max_crop_class + 1,
            }
        )
    )


def read_classes_info(ppaths: ProjectPaths) -> dict:
    if ppaths.classes_info_path.is_file():
        return json.loads(ppaths.classes_info_path.read_text())
    return {"max_crop_class": 1, "edge_class": 2}


def _parse_replace_dict(
    tokens: T.Optional[T.Sequence[str]],
) -> T.Optional[T.Dict[int, int]]:
    """'61:0 141:1' -> {61: 0, 141: 1}."""
    if not tokens:
        return None
    mapping: T.Dict[int, int] = {}
    for token in tokens:
        src, dst = str(token).split(":")
        mapping[int(src)] = int(dst)
    return mapping


def _parse_bbox_offsets(
    tokens: T.Optional[T.Sequence[str]],
) -> T.List[T.Tuple[float, float]]:
    """'0,100 -100,0' -> [(0, 100), (-100, 0)] map-unit (x, y) shifts."""
    out: T.List[T.Tuple[float, float]] = []
    for token in tokens or []:
        sx, sy = str(token).split(",")
        out.append((float(sx), float(sy)))
    return out


def _shift_scene(
    x: np.ndarray,
    bounds: T.Tuple[float, float, float, float],
    cell_res: float,
    offset_xy: T.Tuple[float, float],
) -> T.Tuple[np.ndarray, T.Tuple[float, float, float, float]]:
    """The same-size window shifted by (x, y) map units, zero-filled where
    the shift leaves the scene, and its bounds."""
    dx = int(round(offset_xy[0] / cell_res))
    dy = int(round(offset_xy[1] / cell_res))
    _, h, w, _ = x.shape
    shifted = np.zeros_like(x)
    # Row 0 is the top of the raster: shifted[r, c] = x[r - dy, c + dx].
    dst_r0, dst_r1 = max(0, dy), min(h, h + dy)
    dst_c0, dst_c1 = max(0, -dx), min(w, w - dx)
    if dst_r1 <= dst_r0 or dst_c1 <= dst_c0:
        raise ValueError(
            f"bbox offset {offset_xy} shifts the window fully outside "
            f"the scene"
        )
    shifted[:, dst_r0:dst_r1, dst_c0:dst_c1] = x[
        :, dst_r0 - dy : dst_r1 - dy, dst_c0 + dx : dst_c1 + dx
    ]
    left, bottom, right, top = bounds
    new_bounds = (
        left + offset_xy[0],
        bottom + offset_xy[1],
        right + offset_xy[0],
        top + offset_xy[1],
    )
    return shifted, new_bounds


def _create_region_job(spec: T.Dict[str, T.Any]) -> T.List[str]:
    """Create one region's train chip, and one more for each bbox offset
    under ``<region>-off<x>x<y>``; returns log lines. Driven by one
    picklable spec, so it runs the same inline or in a forked worker (which
    touches no CUDA state)."""
    region_path = Path(spec["region_path"])
    x, bounds, cell_res, _, polygons = load_scene(
        region_path, **spec["scene_kwargs"]
    )
    msgs: T.List[str] = []
    for off in spec["offsets"]:
        if off == (0.0, 0.0):
            region_id, off_x, off_bounds = region_path.name, x, bounds
        else:
            off_x, off_bounds = _shift_scene(x, bounds, cell_res, off)
            region_id = f"{region_path.name}-off{off[0]:g}x{off[1]:g}"
        out = create_train_batch(
            image_time_series=off_x,
            polygons=polygons,
            bounds=off_bounds,
            cell_res=cell_res,
            region=region_id,
            **spec["batch_kwargs"],
        )
        if out is None:
            msgs.append(f"{region_id}: already processed")
        else:
            msgs.append(f"{region_id}: wrote {out.name}")
    return msgs


def create_dataset(args: argparse.Namespace, argv=None) -> None:
    ppaths = setup_paths(args.project_path, append_ts=args.append_ts == "y")
    log_command(ppaths, args, argv)
    write_classes_info(ppaths, args.max_crop_class)

    config = read_project_config(ppaths)
    window = _season_window(args, config)
    if args.delete_dataset:
        import shutil

        shutil.rmtree(ppaths.process_path, ignore_errors=True)
    regions = args.regions or config.get("regions")
    if args.grid_id:
        regions = [args.grid_id]
    image_root = args.time_series_path

    scene_kwargs = dict(
        window=window,
        ref_res=args.ref_res,
        resampling=args.resampling,
        date_format=args.date_format,
        class_column=args.crop_column,
        replace_dict=_parse_replace_dict(args.replace_dict),
        feature_pattern=args.feature_pattern,
        image_vis=config.get("image_vis"),
        skip_index=args.skip_index,
    )
    batch_kwargs = dict(
        process_path=ppaths.process_path,
        start_date=args.start_date,
        end_date=args.end_date,
        gain=args.gain,
        offset=args.offset,
        max_crop_class=args.max_crop_class,
        keep_crop_classes=args.keep_crop_classes,
        nonag_is_unknown=args.nonag_is_unknown,
        overwrite=args.overwrite,
        all_touched=args.all_touched,
        zero_padding=args.zero_padding,
        grid_size=tuple(args.grid_size) if args.grid_size is not None else None,
        compression=args.compression,
    )
    offsets = [(0.0, 0.0)] + _parse_bbox_offsets(args.bbox_offsets)
    specs = [
        dict(
            region_path=str(region_path),
            scene_kwargs=scene_kwargs,
            batch_kwargs=batch_kwargs,
            offsets=offsets,
        )
        for region_path in iter_regions(
            ppaths, regions, base=Path(image_root) if image_root else None
        )
    ]

    num_workers = int(args.num_workers or 1)
    if num_workers > 1 and len(specs) > 1 and _fork_available():
        # One forked process per region at a time: the label math and the
        # npz compression are Python under the interpreter lock.
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("fork")
        with ProcessPoolExecutor(
            max_workers=num_workers, mp_context=ctx
        ) as pool:
            for msgs in pool.map(_create_region_job, specs):
                for msg in msgs:
                    logger.info(msg)
    else:
        for spec in specs:
            for msg in _create_region_job(spec):
                logger.info(msg)


def _season_window(args: argparse.Namespace, config: dict) -> T.Optional[dict]:
    """The seasonal GeoTIFF window from the flags, else ``config.yml``; the
    end year from ``--end-year`` or a yyyy-mm-dd ``--end-date``, plus
    ``--add-year``."""
    end_year = args.end_year
    start_mmdd = args.start_mmdd or config.get("start_mmdd")
    end_mmdd = args.end_mmdd or config.get("end_mmdd")
    num_months = args.num_months or config.get("num_months")
    if end_year is None and str(args.end_date).count("-") == 2:
        end_year = int(str(args.end_date)[:4])
    if end_year is None or not (start_mmdd and end_mmdd):
        return None
    end_year = int(end_year) + int(getattr(args, "add_year", 0) or 0)
    return dict(
        end_year=int(end_year),
        start_mmdd=str(start_mmdd),
        end_mmdd=str(end_mmdd),
        num_months=None if num_months is None else int(num_months),
    )


def create_predict(args: argparse.Namespace, argv=None) -> None:
    ppaths = setup_paths(args.project_path, append_ts=args.append_ts == "y")
    log_command(ppaths, args, argv)

    config = read_project_config(ppaths)
    window = _season_window(args, config)
    for region_path in iter_regions(ppaths, args.regions or config.get("regions")):
        x, bounds, _, _, _ = load_scene(
            region_path,
            window=window,
            ref_res=args.ref_res,
            resampling=args.resampling,
            date_format=args.date_format,
            feature_pattern=args.feature_pattern,
            image_vis=config.get("image_vis"),
            skip_index=args.skip_index,
        )
        paths = create_predict_dataset(
            image_time_series=x,
            region=region_path.name,
            process_path=ppaths.predict_process_path,
            start_date=args.start_date,
            end_date=args.end_date,
            window_size=args.window_size,
            padding=args.padding,
            bounds=bounds,
            num_workers=args.num_workers,
            compression=args.compression,
        )
        logger.info(f"{region_path.name}: wrote {len(paths)} windows")


def _build_params(
    args: argparse.Namespace, ppaths: ProjectPaths, dataset: ChipDataset
) -> CultionetParams:
    """The training configuration from the train flags (the JAX CLI's
    mapping, field for field)."""
    class_info = read_classes_info(ppaths)
    attention = (
        None if args.attention_weights == "none" else args.attention_weights
    )
    return CultionetParams(
        ckpt_file=ppaths.ckpt_file,
        dataset=dataset,
        val_frac=args.val_frac,
        spatial_partitions=args.spatial_partitions,
        partition_name=args.partition_name,
        partition_column=args.partition_column,
        batch_size=args.batch_size,
        load_batch_workers=args.load_batch_workers,
        edge_class=args.edge_class or class_info["edge_class"],
        hidden_channels=args.hidden_channels,
        activation_type=args.activation_type,
        dropout=args.dropout,
        dilations=args.dilations,
        res_block_type=args.res_block_type,
        attention_weights=attention,
        pool_by_max=args.pool_by_max,
        batchnorm_first=args.batchnorm_first,
        use_latlon=args.use_latlon,
        temporal_encoder=args.temporal_encoder,
        optimizer=args.optimizer,
        loss_name=args.loss_name,
        learning_rate=args.learning_rate,
        lr_scheduler=args.lr_scheduler,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        accumulate_grad_batches=args.accumulate_grad_batches,
        gradient_clip_val=args.gradient_clip_val,
        gradient_clip_algorithm=args.gradient_clip_algorithm,
        steplr_step_size=args.steplr_step_size,
        precision=args.precision,
        devices=args.devices,
        augment_prob=args.augment_prob,
        device_augment=args.device_augment,
        device_augment_noise=args.device_augment_noise,
        use_chipstore=args.use_chipstore,
        random_seed=args.random_seed,
        reset_model=args.reset_model,
        skip_train=args.skip_train,
        stochastic_weight_averaging=args.stochastic_weight_averaging,
        stochastic_weight_averaging_lr=args.stochastic_weight_averaging_lr,
        stochastic_weight_averaging_start=args.stochastic_weight_averaging_start,
        model_type=args.model_type,
        model_pruning=args.model_pruning,
        save_batch_val_metrics=args.save_batch_val_metrics,
        auto_lr_find=args.auto_lr_find,
        scale_pos_weight=args.scale_pos_weight,
        fsdp=args.fsdp,
        finetune=getattr(args, "finetune", None),
        profiler=args.profiler,
    )


def _norm_values(
    ppaths: ProjectPaths,
    dataset: ChipDataset,
    batch_size: int,
    recalc: bool = False,
) -> NormValues:
    """The normalization statistics from ``ckpt/last.norm.npz``, computed
    over the dataset (and written there) when missing or ``recalc``."""
    norm_path = Path(str(ppaths.norm_file) + ".npz")
    if norm_path.is_file():
        if recalc:
            norm_path.unlink()
        else:
            return NormValues.from_file(norm_path)
    class_info = read_classes_info(ppaths)
    loader = ChipLoader(dataset, batch_size=batch_size)
    norm = NormValues.from_dataset(loader, class_info=class_info)
    norm.to_file(norm_path)
    return norm


def train_model(
    args: argparse.Namespace, argv=None, transfer: bool = False, device="cuda"
) -> None:
    """Fit the model on the project's train chips; with ``transfer`` from
    the pretrained ``ckpt/last_store`` into ``last_transfer.ckpt``'s own
    store (``model.py::fit_transfer``)."""
    from .. import model as api

    ckpt_name = (
        ModelNames.CKPT_TRANSFER_NAME if transfer else ModelNames.CKPT_NAME
    )
    ppaths = setup_paths(args.project_path, ckpt_name=ckpt_name)
    log_command(ppaths, args, argv)

    dataset = ChipDataset(
        ppaths.train_path,
        pattern=args.data_pattern or "data*",
        preload=bool(args.preload_data),
    )
    if not len(dataset):
        raise FileNotFoundError(
            f"No training chips under {ppaths.process_path}"
        )
    if (
        args.expected_time is not None
        or args.expected_height is not None
        or args.expected_width is not None
        or args.delete_mismatches
    ):
        bad = dataset.check_dims(
            expected_time=args.expected_time,
            expected_height=args.expected_height,
            expected_width=args.expected_width,
            delete_mismatches=args.delete_mismatches,
        )
        if bad:
            logger.warning(f"Removed {len(bad)} mismatched chips")
    if args.log_transform:
        dataset.log_transform = True
    dataset.norm_values = _norm_values(
        ppaths, dataset, args.batch_size, recalc=args.recalc_zscores
    )

    params = _build_params(args, ppaths, dataset)
    run = api.fit_transfer if transfer else api.fit
    if args.profiler:
        from ..utils.profiling import profile_trace

        with profile_trace(args.profiler):
            result = run(params, device=device)
    else:
        result = run(params, device=device)
    logger.info(
        f"Training finished: best val_score={result.best_score:.4f} "
        f"over {len(result.history)} epochs"
    )


def predict_image(
    args: argparse.Namespace, argv=None, transfer: bool = False, device="cuda"
) -> Path:
    """Predict the region's window chips with the checkpoint and write the
    GeoTIFF. Unlike the JAX CLI, the chips are log-transformed when the
    checkpoint was trained so (its ``log_transform`` hyperparameter)."""
    from ..model import checkpoint_hyperparams, load_model
    from ..predict import ScenePredictor

    ckpt_name = (
        ModelNames.CKPT_TRANSFER_NAME if transfer else ModelNames.CKPT_NAME
    )
    ppaths = setup_paths(args.project_path, ckpt_name=ckpt_name)
    log_command(ppaths, args, argv)

    norm_path = Path(str(ppaths.norm_file) + ".npz")
    norm = NormValues.from_file(norm_path) if norm_path.is_file() else None

    pattern = f"data_{args.region}*" if args.region else "data*"
    chip_root = Path(args.data_path) if args.data_path else ppaths.predict_path
    dataset = ChipDataset(chip_root, pattern=pattern, norm_values=norm)
    if not len(dataset):
        raise FileNotFoundError(f"No predict chips under {chip_root}")

    stem = Path(ppaths.ckpt_file).stem
    store = Path(ppaths.ckpt_file).parent / f"{stem}_store"
    _, model = load_model(store, which=args.which_ckpt, device=device)
    hyperparams = checkpoint_hyperparams(store, which=args.which_ckpt)
    dataset.log_transform = bool(hyperparams.get("log_transform", False))

    predictor = ScenePredictor(
        model,
        batch_size=args.predict_batch_size,
        device=device,
        devices=args.predict_devices,
    )
    out_path = args.out_path or (
        ppaths.predict_path
        / f"{args.region or 'scene'}_{args.start_date}_{args.end_date}.tif"
    )
    written = predictor.predict_to_raster(
        dataset,
        out_path,
        crs=scene_crs(ppaths, args.region),
        reference_image=args.reference_image,
    )
    logger.info(f"Wrote {written}")
    return written


def export_model(args: argparse.Namespace, argv=None, device="cuda") -> Path:
    """Export the trained model (``ckpt/last_store``) as a serving artifact
    (``export.py``) for ``--platform`` (``cuda`` or ``cpu``; default the
    command's device)."""
    from ..export import export_predictor

    if args.platform:
        if len(args.platform) != 1 or args.platform[0] not in EXPORT_PLATFORMS:
            raise ValueError(
                f"--platform {' '.join(args.platform)}: the port exports for "
                f"one of {', '.join(EXPORT_PLATFORMS)} (the artifact runs on "
                "the device it was exported on)"
            )
        device = args.platform[0]
    ppaths = setup_paths(args.project_path)
    log_command(ppaths, args, argv)

    stem = Path(ppaths.ckpt_file).stem
    ckpt_dir = Path(ppaths.ckpt_file).parent / f"{stem}_store"
    out_path = Path(
        args.out_path
        or Path(ppaths.ckpt_file).parent / f"serve_{args.which_ckpt}.cnx"
    )
    written = export_predictor(
        ckpt_dir,
        out_path,
        batch_size=args.export_batch_size,
        chip_size=args.chip_size,
        precision=args.precision,
        which=args.which_ckpt,
        norm_file=Path(str(ppaths.norm_file) + ".npz"),
        log_transform={"auto": None, "yes": True, "no": False}[
            args.log_transform_mode
        ],
        allow_unnormalized=args.allow_unnormalized,
        device=device,
    )
    logger.info(f"Wrote {written}")
    return written


def import_torch(args: argparse.Namespace, argv=None, device="cuda") -> None:
    """Convert a reference PyTorch (Lightning) checkpoint into the port's
    checkpoint store ``<ckpt_stem>_store`` (``best`` and ``last``, epoch
    0, a fresh AdamW(1e-3) state), ready for ``predict`` and
    ``train-transfer``. Model hyperparameters come from the checkpoint's
    ``hyper_parameters`` when present, else from the CLI model flags, else
    from the JAX command's defaults. An entry with no place in the model
    or of the wrong shape fails the whole import
    (``utils/torch_params.py::import_torch_state_dict``)."""
    import torch

    from ..train.checkpoint import Checkpointer
    from ..train.fit import model_from_kwargs
    from ..train.optim import build_optimizer
    from ..train.step import create_train_state
    from ..utils.torch_params import import_torch_state_dict

    ppaths = setup_paths(args.project_path)
    log_command(ppaths, args, argv)

    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    hp = dict(ckpt.get("hyper_parameters", {}))

    def pick(name, cli_value, default=None):
        return hp.get(name, cli_value if cli_value is not None else default)

    attention = (
        None if args.attention_weights == "none" else args.attention_weights
    )
    model_kwargs = dict(
        in_time=int(pick("in_time", args.in_time, 12)),
        hidden_channels=int(
            pick("hidden_channels", args.hidden_channels, 32)
        ),
        dropout=float(pick("dropout", args.dropout, 0.1)),
        activation_type=str(
            pick("activation_type", args.activation_type, "SiLU")
        ),
        dilations=list(pick("dilations", args.dilations, [1, 2]) or [1, 2]),
        res_block_type=str(
            pick("res_block_type", args.res_block_type, "resa")
        ),
        attention_weights=pick("attention_weights", attention, "natten"),
        pool_by_max=bool(pick("pool_by_max", args.pool_by_max, False)),
        batchnorm_first=bool(
            pick("batchnorm_first", args.batchnorm_first, False)
        ),
    )
    in_channels = int(pick("in_channels", args.in_channels, 3))

    model = model_from_kwargs(in_channels, model_kwargs)
    state = create_train_state(
        model, build_optimizer("AdamW", 1e-3), seed=0, device=device
    )
    prefix = (
        "cultionet_model."
        if any(k.startswith("cultionet_model.") for k in state_dict)
        else ""
    )
    import_torch_state_dict(state_dict, state.model, prefix=prefix)

    ckpt_file = Path(ppaths.ckpt_file)
    store_dir = ckpt_file.parent / f"{ckpt_file.stem}_store"
    store = Checkpointer(store_dir)
    hyperparams = {**model_kwargs, "in_channels": in_channels}
    store.save_best(state, epoch=0, metrics={}, hyperparams=hyperparams)
    store.save_last(state, epoch=0, metrics={}, hyperparams=hyperparams)
    logger.info(f"Imported {len(state_dict)} torch entries into {store_dir}")


def spatial_kfoldcv(args: argparse.Namespace, argv=None, device="cuda") -> None:
    """Fit one model per fold, each validated on its held-out fold, and
    write the folds' best scores to ``ckpt/skfoldcv.json``. The folds are
    the named polygons of a partition file (``--spatial-partitions FILE``,
    names from ``--partition-column``), else spatial folds (``--k-folds``,
    or 4^``--splits`` quadtree cells)."""
    from .. import model as api

    ppaths = setup_paths(args.project_path)
    log_command(ppaths, args, argv)

    dataset = ChipDataset(ppaths.train_path)
    dataset.norm_values = _norm_values(ppaths, dataset, args.batch_size)
    partition_file = args.spatial_partitions
    if partition_file and partition_file != "spatial":
        fold_iter = dataset.partition_kfoldcv_iter(
            partition_file, partition_column=args.partition_column
        )
    else:
        folds = 4 ** int(args.splits) if args.splits > 0 else args.k_folds
        fold_iter = dataset.spatial_kfoldcv_iter(folds)

    results = {}
    for fold_name, train_ds, val_ds in fold_iter:
        params = _build_params(args, ppaths, train_ds)
        params.ckpt_file = ppaths.ckpt_path / f"{fold_name}.ckpt"
        params.test_dataset = val_ds
        result = api.fit(params, device=device)
        results[fold_name] = result.best_score
        logger.info(f"{fold_name}: best val_score={result.best_score:.4f}")

    (ppaths.ckpt_path / "skfoldcv.json").write_text(
        json.dumps(results, indent=2)
    )


def main(argv: T.Optional[T.Sequence[str]] = None, device="cuda") -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the command on
    ``device``: the card unless the caller passes ``device="cpu"``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    if args.command == CLISteps.VERSION:
        print(__version__)
    elif args.command == CLISteps.CREATE:
        create_dataset(args, argv)
    elif args.command == CLISteps.CREATE_PREDICT:
        create_predict(args, argv)
    elif args.command == CLISteps.TRAIN:
        train_model(args, argv, device=device)
    elif args.command == CLISteps.TRAIN_TRANSFER:
        train_model(args, argv, transfer=True, device=device)
    elif args.command == CLISteps.IMPORT_TORCH:
        import_torch(args, argv, device=device)
    elif args.command == CLISteps.EXPORT:
        export_model(args, argv, device=device)
    elif args.command == CLISteps.PREDICT:
        predict_image(args, argv, device=device)
    elif args.command == CLISteps.PREDICT_TRANSFER:
        predict_image(args, argv, transfer=True, device=device)
    elif args.command == CLISteps.SKFOLDCV:
        spatial_kfoldcv(args, argv, device=device)


if __name__ == "__main__":
    main()
