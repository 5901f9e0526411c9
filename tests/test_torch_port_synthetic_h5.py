"""Port twins of the JAX package's h5 writers
(``graphphysics_torch/utils/synthetic.py``: ``write_cylinder_h5``,
``write_plate_h5``, ``write_plate_press_h5``): each writer and its JAX
counterpart write into two temporary directories, with default arguments
and with ``grids=`` or ``seed=`` or smaller shapes, and every h5 dataset,
its dtype, shape and attributes, and ``meta.json`` read back equal."""

import h5py
import numpy as np
import pytest

from graphphysics_torch.utils import synthetic as port
from graphphysics_tpu.utils import synthetic as reference
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)


def _h5_items(path):
    """Every group and dataset of the file: name -> (attributes, and for a
    dataset its dtype, shape and values)."""
    items = {}
    with h5py.File(path, "r") as f:
        items["/"] = (dict(f.attrs), None)

        def visit(name, obj):
            data = (obj.dtype, obj.shape, obj[()]) if isinstance(obj, h5py.Dataset) else None
            items[name] = (dict(obj.attrs), data)

        f.visititems(visit)
    return items


CASES = {
    "cylinder_default": ("write_cylinder_h5", {}),
    "cylinder_grids_seed": ("write_cylinder_h5", {"grids": [(6, 5), (9, 4), (7, 7)], "seed": 3,
                                                  "steps": 5}),
    "cylinder_seed": ("write_cylinder_h5", {"num_traj": 3, "steps": 4, "nx": 5, "ny": 6, "seed": 11}),
    "plate_default": ("write_plate_h5", {}),
    "plate_shape": ("write_plate_h5", {"num_traj": 2, "steps": 3, "n": 4}),
    "plate_press_small_seed": ("write_plate_press_h5", {"num_traj": 2, "steps": 6, "nx": 5, "nz": 2,
                                                        "seed": 7}),
    "plate_press_default": ("write_plate_press_h5", {}),
}


@pytest.mark.parametrize("case", CASES)
def test_port_writer_files_equal_jax(tmp_path, case):
    writer, kwargs = CASES[case]
    got_h5, got_meta = getattr(port, writer)(str(tmp_path / "port"), **kwargs)
    want_h5, want_meta = getattr(reference, writer)(str(tmp_path / "jax"), **kwargs)
    assert (got_h5, got_meta) == (str(tmp_path / "port" / "train.h5"),
                                  str(tmp_path / "port" / "meta.json"))
    with open(got_meta) as a, open(want_meta) as b:
        assert a.read() == b.read()
    got, want = _h5_items(got_h5), _h5_items(want_h5)
    assert sorted(got) == sorted(want)
    for name, (attrs, data) in want.items():
        got_attrs, got_data = got[name]
        assert got_attrs == attrs, name
        if data is None:
            assert got_data is None, name
            continue
        assert got_data[:2] == data[:2], name  # dtype and shape
        np.testing.assert_array_equal(got_data[2], data[2], err_msg=name)
