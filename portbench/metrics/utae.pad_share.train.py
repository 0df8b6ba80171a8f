"""The share of the window's date images that were padding: the
program's counters ``utae_pad_images`` over ``utae_date_images``
(``data/batch.py::count_date_images``), as they moved over the window.
Nothing where the program has no such counters."""

LAYER = "data: data/loader.py ChipLoader, data/device_cache.py, augment/"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "program_counter", "train_chips_per_s"
WORKLOADS = ["train-utae-pastis"]


def read(ctx):
    dates = ctx.extra.get("date_images")
    if not dates:
        return None
    return 100.0 * ctx.extra["pad_images"] / dates
