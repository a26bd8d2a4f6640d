"""Options fields and environment knobs that selected removed kernels are
rejected with a clear error; component batching gives one answer in all
modes; the main path imports nothing beyond jax, numpy and the standard
library."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ndsm_tpu import Options, vector_potential
from ndsm_tpu.options import REMOVED_ENV_KNOBS
from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case


@pytest.mark.parametrize(
    "field,value", [("use_pallas", "on"), ("mixed_defect", "df32")]
)
def test_removed_options_fields_are_rejected(field, value):
    with pytest.raises(TypeError, match=field):
        Options(**{field: value})


@pytest.mark.parametrize("knob", REMOVED_ENV_KNOBS)
def test_removed_env_knobs_are_rejected(knob, monkeypatch):
    monkeypatch.setenv(knob, "1")
    with pytest.raises(ValueError, match=knob):
        Options()


def _case(n=14):
    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    return (x, y, z), potential_field_case(X, Y, Z)[1]


@pytest.mark.parametrize("precision", ["fp64", "mixed"])
@pytest.mark.parametrize("mode", ["auto", "on"])
def test_batch_components_modes_agree(mode, precision):
    """"auto" (sequential components) and "on" (one lane-masked
    program) give the "off" result: identical per-lane iterates."""
    mesh, b = _case()
    _, A_ref, B_ref = vector_potential(
        *mesh, b, options=Options(precision=precision, batch_components="off")
    )
    _, A, B = vector_potential(
        *mesh, b, options=Options(precision=precision, batch_components=mode)
    )
    tol = 1e-12 if precision == "fp64" else 1e-9
    np.testing.assert_allclose(A, A_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(B, B_ref, rtol=0, atol=100 * tol)


def test_batch_components_rejects_unknown_mode():
    mesh, b = _case(8)
    with pytest.raises(ValueError, match="batch_components"):
        vector_potential(*mesh, b, options=Options(batch_components="yes"))


def test_main_path_imports_only_jax_numpy_and_stdlib():
    """Modules a vector_potential call loads beyond those that importing
    jax and numpy loads are ndsm_tpu's own or the standard library's."""
    code = r"""
import sys
import jax, jax.numpy, numpy
before = {m.split(".")[0] for m in sys.modules}
import numpy as np
from ndsm_tpu import vector_potential
from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case
x, y, z = build_test_mesh(10)
Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
vector_potential(x, y, z, potential_field_case(X, Y, Z)[1])
new = {m.split(".")[0] for m in sys.modules} - before
print(sorted(m for m in new if m not in sys.stdlib_module_names and m != "ndsm_tpu"))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout
