"""The traffic generators repeat by seed, and every seed gets the same
sizes."""

import numpy as np

from portbench.traffic.fields import field_chips
from portbench.traffic.scenes import scene_pool
from portbench.traffic.wire import wire_pool

FIELDS = dict(chips=6, chip_size=40, time=6, bands=3, crop_share=0.7)


def test_field_chips_repeat_by_seed():
    a, b = field_chips(FIELDS, 2**31 + 5, "cpu"), field_chips(FIELDS, 2**31 + 5, "cpu")
    c = field_chips(FIELDS, 7, "cpu")
    for k in ("x", "y", "bdist"):
        assert np.array_equal(a[k], b[k]) and a[k].shape == c[k].shape
    assert not np.array_equal(a["x"], c["x"])
    assert a["x"].dtype == np.int16 and set(np.unique(a["y"])) <= {0, 1, 2}
    assert a["bdist"].min() == 0 and a["bdist"].max() <= 10000
    # Edges carry distance 0; 4 x 4 to 5 x 5 fields, 1-px rings.
    assert np.all(a["bdist"][a["y"] == 2] == 0)


def test_scenes_and_wire_repeat_by_seed():
    params = dict(scene_size=30, scene_pool=2, time=4, bands=3)
    a, b = scene_pool(params, 11, "cpu"), scene_pool(params, 11, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and a[0].shape == (4, 30, 30, 3)
    wire = dict(batch=2, window=20, time=4, bands=3, pool=3)
    a, b = wire_pool(wire, 3, "cpu"), wire_pool(wire, 3, "cpu")
    assert all(np.array_equal(u, v) for p, q in zip(a, b) for u, v in zip(p, q))
    assert a[0][0].shape == (2, 4, 20, 20, 3) and a[0][1].dtype == np.float32
