"""Seasonal-window listing of date-named imagery (port-owned copy of
``get_time_series_list`` and ``_parse_date`` from
cultionet_tpu/utils/model_preprocessing.py)."""

import datetime
import typing as T
from pathlib import Path


def _parse_date(stem: str) -> datetime.date:
    """The date in a file stem's digits: yyyymmdd, yyyyjjj (day of year)
    or yyyymm."""
    digits = "".join(ch for ch in stem if ch.isdigit())
    if len(digits) >= 8:
        return datetime.date(
            int(digits[:4]), int(digits[4:6]), int(digits[6:8])
        )
    if len(digits) == 7:
        return datetime.date(int(digits[:4]), 1, 1) + datetime.timedelta(
            days=int(digits[4:7]) - 1
        )
    if len(digits) >= 6:
        return datetime.date(int(digits[:4]), int(digits[4:6]), 1)
    raise ValueError(f"Cannot parse a date from {stem!r}")


def get_time_series_list(
    feature_path: T.Union[str, Path],
    end_year: int,
    start_mmdd: str,
    end_mmdd: str,
    num_months: T.Optional[int] = None,
    date_format: str = "%Y%j",
) -> T.List[Path]:
    """The ``.tif`` and ``.npy`` files of ``feature_path`` dated inside the
    seasonal window that ends on ``end_mmdd`` of ``end_year``, sorted by
    date, at most ``num_months`` of them.

    The window starts on ``start_mmdd`` of the previous year when that
    month-day is not before ``end_mmdd``, else of ``end_year``. A stem is
    parsed with ``date_format`` first, else from its digits.
    """
    feature_path = Path(feature_path)
    start_m, start_d = int(start_mmdd[:2]), int(start_mmdd[3:5])
    end_m, end_d = int(end_mmdd[:2]), int(end_mmdd[3:5])

    start_year = end_year
    if (start_m, start_d) >= (end_m, end_d):
        start_year = end_year - 1
    start = datetime.date(start_year, start_m, start_d)
    end = datetime.date(end_year, end_m, end_d)

    dated = []
    for path in sorted(feature_path.glob("*.tif")) + sorted(
        feature_path.glob("*.npy")
    ):
        try:
            try:
                when = datetime.datetime.strptime(
                    path.stem, date_format
                ).date()
            except (ValueError, TypeError):
                when = _parse_date(path.stem)
        except ValueError:
            continue
        if start <= when <= end:
            dated.append((when, path))

    dated.sort(key=lambda pair: pair[0])
    files = [path for _, path in dated]
    if num_months is not None:
        files = files[:num_months]
    return files
