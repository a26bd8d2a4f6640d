"""Utility-layer tests: hierarchy validation, profiling timer, options."""

import numpy as np
import pytest

from ndsm_tpu import GridHierarchy, Options, coarsen_shape, num_grids
from ndsm_tpu.utils.profiling import Timer
from ndsm_tpu.utils.testing import power_law_fit


def test_coarsen_and_numgrids_rules():
    assert coarsen_shape((22, 22, 22)) == (11, 11, 11)
    assert coarsen_shape((3, 2)) == (1, 1)
    assert num_grids((22, 22, 22)) == 3
    assert num_grids((220, 220, 220)) == 6
    with pytest.raises(ValueError):
        num_grids((3, 8))


def test_hierarchy_validation():
    x = np.linspace(0, 1, 16)
    with pytest.raises(ValueError):
        GridHierarchy.from_mesh((np.array([0.0]), x))
    with pytest.raises(ValueError):
        GridHierarchy.from_mesh((x, x), ngrids=0)
    with pytest.raises(ValueError):
        GridHierarchy.from_mesh((x, x), ngrids=10)  # coarsens below 2
    h = GridHierarchy.from_mesh((x, x), ngrids=3)
    assert h.shapes == ((16, 16), (8, 8), (4, 4))
    # coarse spacings follow the regenerated-linspace rule
    assert abs(h.dq[1][0] - 1.0 / 7) < 1e-15


def test_hierarchy_hash_eq():
    x = np.linspace(0, 1, 16)
    y = np.linspace(0, 2, 16)
    h1 = GridHierarchy.from_mesh((x, x))
    h2 = GridHierarchy.from_mesh((x, x))
    h3 = GridHierarchy.from_mesh((y, x))
    assert h1 == h2 and hash(h1) == hash(h2)
    assert h1 != h3  # same shapes, different meshes


def test_timer():
    t = Timer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert "a:" in t.report()


def test_power_law_fit_cov():
    x = np.array([1.0, 2.0, 4.0, 8.0])
    y = 3.0 * x**2
    gamma, A, C, ev = power_law_fit(x, y, cov=True)
    assert abs(gamma - 2.0) < 1e-10
    assert abs(A - 3.0) < 1e-10
    assert C.shape == (2, 2)
    assert abs(ev(3.0) - 27.0) < 1e-8


def test_options_precision_resolution():
    assert Options(precision="fp64").resolve_precision("gpu") == "fp64"
    assert Options().resolve_precision("cpu") == "fp64"
    assert Options().resolve_precision("gpu") == "mixed"
