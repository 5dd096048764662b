"""Port parity: heat dataset generation and the data dicts at n=16.

Both packages draw from ``np.random.default_rng(seed)`` in the same order,
so time grids, initial states and graph events are identical; the ground
truth is a float32 constant-step solve on each side (XLA vs torch CPU
kernels), so trajectories and coefficients agree within 1e-5 (float32
rounding accumulated over ~500 Dopri5/Tsit5 steps).
"""

import dataclasses

import numpy as np
import pytest

from gncde_tpu.data import ode_dataset as jds
from gncde_tpu.data import pipeline as jpipe
from gncde_tpu_torch.data import ode_dataset as tds
from gncde_tpu_torch.data import pipeline as tpipe

TOL = dict(atol=1e-5, rtol=1e-5)

# The flagship dataset block (configs/dyn/perm_equiv_gncde.yaml), cut to
# n=16 and a short time grid.
SPEC = dict(name="heat", batch_size=2, dynamic_graph=True, all_dynamic=True,
            graph_type="grid", split_ratio=(0.8, 0.2), num_nodes=16,
            final_time=5.0, time_tick=10, sampling_type="irregular",
            method="Tsit5", operator_type="norm_lap", padding_mode="same",
            amp_range=(1.0, 1.0), seed=1234)


@pytest.fixture(scope="module")
def datasets():
    jspec = jds.ODEDatasetSpec(**SPEC)
    tspec = tds.ODEDatasetSpec(**SPEC)
    return jspec, jds.generate(jspec), tspec, tds.generate(tspec)


def test_heat_generation_matches(datasets):
    _, jd, _, td = datasets
    np.testing.assert_array_equal(td.t, jd.t)
    np.testing.assert_array_equal(td.x0, jd.x0)
    np.testing.assert_array_equal(td.A, jd.A)
    np.testing.assert_array_equal(td.events_time_indices, jd.events_time_indices)
    assert td.true_y.shape == jd.true_y.shape and td.A.ndim == 4
    np.testing.assert_allclose(td.true_y, jd.true_y, **TOL)


@pytest.mark.parametrize("split", ["train", "test"])
def test_data_dicts_match(datasets, split):
    jspec, jd, tspec, td = datasets
    if split == "train":
        jdict = jpipe.get_split_train_data(jspec, jd, "cubic")
        tdict = tpipe.get_split_train_data(tspec, td, "cubic")
    else:
        jdict = jpipe.get_split_test_data(jspec, jd, "cubic")
        tdict = tpipe.get_split_test_data(tspec, td, "cubic")
    assert set(tdict) == set(jdict)
    for k, v in jdict.items():
        if v is None:
            assert tdict[k] is None
            continue
        tv = tdict[k]
        if k == "y_coeffs":
            # Coefficients of the ground-truth signal divide trajectory
            # differences (within 1e-5) by h^2, h down to 0.005 on the
            # irregular grid: hold them to 1e-5 of each array's scale.
            for a, b in zip(tv, v):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                           atol=1e-5 * np.abs(b).max(), err_msg=k)
        elif isinstance(v, tuple):
            for a, b in zip(tv, v):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=k)
        else:
            np.testing.assert_allclose(tv.numpy(), np.asarray(v), **TOL, err_msg=k)


def test_static_graph_and_unported_families_raise():
    spec = tds.ODEDatasetSpec(**dict(SPEC, dynamic_graph=False, time_tick=6))
    res = tds.generate(spec)
    assert res.A.shape == (2, 16, 16) and res.events_time is None
    assert np.isfinite(res.true_y).all()
    with pytest.raises(NotImplementedError):
        tds.generate(dataclasses.replace(spec, graph_type="community"))
    with pytest.raises(NotImplementedError):
        tds.generate(dataclasses.replace(spec, name="sir"))
