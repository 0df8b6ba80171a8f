"""The project directory layout (port-owned copy of
cultionet_tpu/utils/project_paths.py): ``data/{train,test,predict}/processed``
chip stores, ``ckpt/`` checkpoints and the normalization sidecar,
``data/classes.info`` class metadata, figures, user training vectors and the
``commands/`` archive. A project laid out by either package reads in the
other.
"""

import shutil
import typing as T
from dataclasses import dataclass
from pathlib import Path

from ..enums import Destinations, ModelNames


@dataclass
class ProjectPaths:
    project_path: Path
    image_path: Path
    figure_path: Path
    data_path: Path
    classes_info_path: Path
    process_path: Path
    test_process_path: Path
    predict_process_path: Path
    ckpt_path: Path
    train_path: Path
    test_path: Path
    predict_path: Path
    edge_training_path: Path
    ckpt_file: Path
    norm_file: Path
    commands_path: Path

    @property
    def grid_format(self) -> str:
        return "{region}_grid_{end_year}.gpkg"

    @property
    def polygon_format(self) -> str:
        return "{region}_poly_{end_year}.gpkg"

    def remove_train_path(self) -> None:
        if self.process_path.is_dir():
            shutil.rmtree(str(self.process_path))
        self.process_path.mkdir(exist_ok=True, parents=True)

    def get_process_path(self, destination: str) -> Path:
        return self.data_path / destination / Destinations.PROCESSED


def setup_paths(
    project_path: T.Union[str, Path],
    append_ts: bool = True,
    ckpt_name: str = ModelNames.CKPT_NAME,
) -> ProjectPaths:
    project_path = Path(project_path)
    image_path = (
        project_path / Destinations.TIME_SERIES_VARS
        if append_ts
        else project_path
    )
    figure_path = project_path / Destinations.FIGURES
    data_path = project_path / Destinations.DATA
    ckpt_path = project_path / Destinations.CKPT
    classes_info_path = data_path / ModelNames.CLASS_INFO
    train_path = data_path / Destinations.TRAIN
    test_path = data_path / Destinations.TEST
    predict_path = data_path / Destinations.PREDICT
    process_path = train_path / Destinations.PROCESSED
    test_process_path = test_path / Destinations.PROCESSED
    predict_process_path = predict_path / Destinations.PROCESSED
    edge_training_path = project_path / Destinations.USER_TRAIN
    commands_path = project_path / "commands"

    for path in (
        figure_path,
        data_path,
        process_path,
        test_process_path,
        predict_process_path,
        ckpt_path,
        commands_path,
    ):
        path.mkdir(exist_ok=True, parents=True)

    return ProjectPaths(
        project_path=project_path,
        image_path=image_path,
        figure_path=figure_path,
        data_path=data_path,
        classes_info_path=classes_info_path,
        process_path=process_path,
        test_process_path=test_process_path,
        predict_process_path=predict_process_path,
        ckpt_path=ckpt_path,
        train_path=train_path,
        test_path=test_path,
        predict_path=predict_path,
        edge_training_path=edge_training_path,
        ckpt_file=ckpt_path / ckpt_name,
        norm_file=ckpt_path / ModelNames.NORM,
        commands_path=commands_path,
    )
