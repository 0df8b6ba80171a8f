"""Colorized logging (port-owned copy of cultionet_tpu/utils/logging.py):
an ANSI color stream handler at INFO and an optional file handler at
WARNING."""

import logging
import typing as T
from pathlib import Path

_COLORS = {
    logging.DEBUG: "\x1b[38;5;244m",
    logging.INFO: "\x1b[38;5;39m",
    logging.WARNING: "\x1b[38;5;214m",
    logging.ERROR: "\x1b[38;5;196m",
    logging.CRITICAL: "\x1b[31;1m",
}
_RESET = "\x1b[0m"


class ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        base = super().format(record)
        return f"{color}{base}{_RESET}"


def set_color_logger(
    name: str, log_file: T.Optional[Path] = None
) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)

    stream = logging.StreamHandler()
    stream.setLevel(logging.INFO)
    stream.setFormatter(
        ColorFormatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    logger.addHandler(stream)

    if log_file is not None:
        file_handler = logging.FileHandler(log_file)
        file_handler.setLevel(logging.WARNING)
        file_handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logger.addHandler(file_handler)

    return logger
