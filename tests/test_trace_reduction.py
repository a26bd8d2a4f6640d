"""The trace-to-scope reduction of scripts/trace_smoother_share.py, on an
XLA dump of a small mixed-precision solve compiled for the CPU."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import trace_smoother_share as tss  # noqa: E402


def test_classify_rules():
    assert tss.classify(None) == "unattributed"
    assert tss.classify("") == "other"
    assert tss.classify("jit(f)/while/body/mg_smooth/add") == "mg_smooth"
    # the defect scope wraps a residual: the outer scope wins
    assert tss.classify("jit(f)/mg_defect/mg_residual/sub") == "mg_defect"
    assert tss.classify("jit(f)/mul") == "other"


def test_dump_names_every_multigrid_scope(tmp_path):
    code = r"""
import numpy as np
from ndsm_tpu import GridHierarchy, Options
from ndsm_tpu.mg.poisson import PoissonBVP
x = np.linspace(0, 1, 16)
h = GridHierarchy.from_mesh((x, x, x))
for cs in ("direct", "relax"):
    bvp = PoissonBVP(h, (("D", "D"), ("N", "N"), ("D", "N")),
                     Options(precision="mixed", coarse_solver=cs))
    bvp.solve(np.zeros((16,) * 3), np.ones((16,) * 3))
"""
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_dump_to={tmp_path} --xla_dump_hlo_as_text",
        PYTHONPATH=REPO,
    )
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    names = tss.hlo_op_names(str(tmp_path))
    scopes = {tss.classify(v) for v in names.values()}
    assert set(tss.SCOPES) <= scopes, scopes
