"""CultionetParams: the programmatic training configuration (a port-owned,
field-for-field copy of cultionet_tpu/config.py).

Every field of the JAX configuration is here with its default, so a
configuration written for one package reads in the other. Every field
runs: the model's (``remat`` included), the data path's
(``use_chipstore``, ``device_augment``, ``device_augment_noise``) and the
devices' (``devices``, ``fsdp``, ``fsdp_min_size``: ``train/fit.py``).
``model_type="UTAE"`` and ``"TSViT"`` (models of the port alone,
``models/utae.py``, ``models/tsvit.py``) take ``in_time`` and
``hidden_channels``, and the published widths.
"""

import dataclasses
import shutil
import typing as T
from pathlib import Path

from .enums import LearningRateSchedulers, LossTypes, ModelTypes, ResBlockTypes


@dataclasses.dataclass
class CultionetParams:
    # Checkpointing / project layout
    ckpt_file: T.Optional[Path] = None
    model_name: str = "cultionet"
    ckpt_name: str = "last"
    reset_model: bool = False

    # Data
    dataset: T.Any = None
    test_dataset: T.Any = None
    val_frac: float = 0.2
    # 'spatial' = balanced quadtree val sample; a file path = user
    # partition polygons (with partition_name selecting the val region)
    spatial_partitions: T.Optional[str] = None
    partition_name: T.Optional[str] = None
    partition_column: str = "name"

    batch_size: int = 4
    load_batch_workers: int = 2
    edge_class: int = 2
    class_counts: T.Any = None
    augment_prob: float = 0.0
    device_augment: bool = False
    device_augment_noise: float = 0.0
    use_chipstore: T.Union[bool, str] = False

    # Model
    in_channels: T.Optional[int] = None
    in_time: T.Optional[int] = None
    hidden_channels: int = 64
    model_type: str = ModelTypes.TOWERUNET
    activation_type: str = "SiLU"
    dropout: float = 0.1
    dilations: T.Optional[T.Sequence[int]] = None
    res_block_type: str = ResBlockTypes.RESA
    attention_weights: T.Optional[str] = None
    pool_by_max: bool = False
    batchnorm_first: bool = False
    use_latlon: bool = False
    temporal_encoder: str = "conv"
    remat: bool = False

    # Optimization
    optimizer: str = "AdamW"
    loss_name: str = LossTypes.TANIMOTO_COMPLEMENT
    learning_rate: float = 0.01
    lr_scheduler: str = LearningRateSchedulers.ONE_CYCLE_LR
    steplr_step_size: int = 5
    weight_decay: float = 1e-3
    eps: float = 1e-4
    epochs: int = 100
    accumulate_grad_batches: int = 1
    gradient_clip_val: T.Optional[float] = 1.0
    gradient_clip_algorithm: str = "norm"
    precision: str = "16-mixed"  # bf16 on the card
    scale_pos_weight: bool = False
    save_batch_val_metrics: bool = False
    stochastic_weight_averaging: bool = False
    stochastic_weight_averaging_lr: float = 0.05
    stochastic_weight_averaging_start: float = 0.8
    model_pruning: bool = False
    skip_train: bool = False
    auto_lr_find: bool = False
    finetune: T.Optional[str] = None
    random_seed: int = 42

    # Devices
    devices: int = 1
    fsdp: bool = False
    fsdp_min_size: int = 2**16
    profiler: T.Optional[str] = None

    def __post_init__(self):
        if self.ckpt_file is not None:
            self.ckpt_file = Path(self.ckpt_file)
        if self.dilations is not None:
            self.dilations = list(self.dilations)

    def check_checkpoint(self) -> None:
        """Delete the checkpoint when ``reset_model`` is set."""
        if self.reset_model and self.ckpt_file is not None:
            if self.ckpt_file.is_dir():
                shutil.rmtree(self.ckpt_file)
            elif self.ckpt_file.is_file():
                self.ckpt_file.unlink()

    def update_channels(self, dataset) -> "CultionetParams":
        sample = dataset[0]
        self.in_channels = sample.num_channels
        self.in_time = sample.num_time
        return self

    def get_model_kwargs(self) -> dict:
        """The JAX model's keyword arguments (``in_channels`` is separate:
        the JAX model infers it from its input, the port's takes it). A
        U-TAE's and TSViT's are their own (``models/utae.py::UTAE``,
        ``models/tsvit.py::TSViT``)."""
        if self.model_type in (ModelTypes.UTAE, ModelTypes.TSVIT):
            return dict(
                model_type=self.model_type,
                in_time=self.in_time,
                hidden_channels=self.hidden_channels,
            )
        return dict(
            in_time=self.in_time,
            hidden_channels=self.hidden_channels,
            model_type=self.model_type,
            activation_type=self.activation_type,
            dropout=self.dropout,
            dilations=self.dilations,
            res_block_type=self.res_block_type,
            attention_weights=self.attention_weights,
            pool_by_max=self.pool_by_max,
            batchnorm_first=self.batchnorm_first,
            use_latlon=self.use_latlon,
            temporal_encoder=self.temporal_encoder,
            remat=self.remat,
        )

    @property
    def compute_precision(self) -> str:
        return "bf16" if self.precision in ("16-mixed", "bf16", "16") else "fp32"
