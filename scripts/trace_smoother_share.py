#!/usr/bin/env python3
"""Where the device time of a vector-potential solve goes, from one
profiler trace.

    python scripts/trace_smoother_share.py [--n 220] [--out DIR]

Runs vector_potential at n^3 with the default Options() once to compile,
then traces one warm solve with ``jax.profiler`` and dumps the optimized
HLO of every program.  Each device kernel event in the trace names its
HLO op (``hlo_op``) and program (``program_id``); the HLO dump maps that
op to its ``op_name`` metadata, which carries the multigrid named scopes
(``mg_smooth``, ``mg_residual``, ``mg_restrict``, ``mg_prolong``,
``mg_coarse``, ``mg_defect``; mg/engine.py).  Device time is summed per
scope, and the busy union of all kernels is compared with the traced
window and with the solve3d phase's wall.  Kernels XLA runs inside a
CUDA graph may show as one ``command_buffer`` event per launch; those are
reported as unattributed.  The persistent compile cache
is off in this process, so every program is compiled and dumped.  Needs
a GPU; writes the trace under DIR (default trace_out/).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import sys
import time

SCOPES = ("mg_defect", "mg_coarse", "mg_smooth", "mg_residual",
          "mg_restrict", "mg_prolong")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")
_BARE = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\S+\s+[\w\-]+\(")
_MODULE = re.compile(r"^HloModule\s+([\w.\-]+)")


def hlo_op_names(dump_dir: str) -> dict:
    """{(module_id, op): op_name} and {(module_name, op): op_name} from
    the ``*after_optimizations.txt`` files of an XLA dump; ops without
    op_name metadata map to ""."""
    table = {}
    for path in glob.glob(os.path.join(dump_dir, "*after_optimizations.txt")):
        m = re.match(r"module_(\d+)\.", os.path.basename(path))
        mod_id = int(m.group(1)) if m else None
        mod_name = None
        with open(path) as f:
            for line in f:
                if mod_name is None:
                    mm = _MODULE.match(line)
                    if mm:
                        mod_name = mm.group(1)
                    continue
                mi = _INSTR.match(line)
                if mi:
                    table[(mod_id, mi.group(1))] = mi.group(2)
                    table.setdefault((mod_name, mi.group(1)), mi.group(2))
                    continue
                # an op without metadata: known, but charged to no scope
                mo = _BARE.match(line)
                if mo:
                    table.setdefault((mod_id, mo.group(1)), "")
                    table.setdefault((mod_name, mo.group(1)), "")
    return table


def classify(op_name: str | None) -> str:
    if op_name is None:
        return "unattributed"  # not found in the dump
    if not op_name:
        return "other"  # an op XLA added, without op_name metadata
    for s in SCOPES:  # outermost match first: defect wraps a residual
        if s in op_name:
            return s
    return "other"


def reduce_trace(xplane: str, names: dict) -> dict:
    """Device time per scope, busy union and window of a trace."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane)
    per = {}
    per_module = {}
    unnamed = {}
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                op = st.get("hlo_op")
                if op is None:
                    continue
                pid = st.get("program_id")
                name = names.get((pid, op)) or names.get((st.get("hlo_module"), op))
                key = classify(name)
                dt = ev.duration_ns * 1e-9
                per[key] = per.get(key, 0.0) + dt
                pm = per_module.setdefault(st.get("hlo_module"), {})
                pm[key] = pm.get(key, 0.0) + dt
                if key in ("unattributed", "other"):
                    k = (key, st.get("hlo_module"), op)
                    unnamed[k] = unnamed.get(k, 0.0) + dt
                intervals.append((ev.start_ns, ev.end_ns))
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    return {"per_scope_s": per, "busy_s": busy * 1e-9,
            "kernel_span_s": window * 1e-9, "unnamed": unnamed,
            "per_module": per_module}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=220)
    ap.add_argument("--out", default="trace_out")
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    dump = os.path.join(out, "hlo")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(dump)
    # Must be set before JAX starts its backend.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_dump_to={dump} --xla_dump_hlo_as_text"
    ).strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax
    import numpy as np

    from ndsm_tpu import Options, vector_potential
    from ndsm_tpu.utils.device import gpu_identity, require_gpu
    from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case

    # Compile everything in this process: a program loaded from the
    # persistent cache is not dumped, and its ops could not be named.
    jax.config.update("jax_enable_compilation_cache", False)
    require_gpu()
    print(f"card (nvidia-smi name, power.limit): {gpu_identity()}", flush=True)
    x, y, z = build_test_mesh(args.n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    _, b = potential_field_case(X, Y, Z)
    opts = Options()
    vector_potential(x, y, z, b, options=opts)  # compile
    trace_dir = os.path.join(out, "xplane")
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        ierr, A, B, info = vector_potential(
            x, y, z, b, options=opts, full_output=True
        )
    wall = time.perf_counter() - t0
    print(f"traced solve: ierr={ierr} wall={wall:.4f} s (profiler on) phases: "
          + ", ".join(f"{k}={v:.4f}s" for k, v in info.phases.items()), flush=True)
    xplanes = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                               recursive=True))
    names = hlo_op_names(dump)
    r = reduce_trace(xplanes[-1], names)
    total = sum(r["per_scope_s"].values())
    print(f"HLO ops with names: {len(names)}; kernel time {total:.4f} s; "
          f"busy union {r['busy_s']:.4f} s over a kernel span of "
          f"{r['kernel_span_s']:.4f} s (idle share of span "
          f"{1 - r['busy_s'] / max(r['kernel_span_s'], 1e-12):.3f})")
    for k, v in sorted(r["per_scope_s"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:13s} {v:.4f} s  {100 * v / max(total, 1e-12):5.1f}% of kernel time")
    # The 3D component solves (the solve3d phase) run in this program.
    comp = r["per_module"].get("jit__solve_impl_zero_rhs", {})
    ctot = sum(comp.values())
    print(f"solve3d program (jit__solve_impl_zero_rhs): kernel time {ctot:.4f} s")
    for k, v in sorted(comp.items(), key=lambda kv: -kv[1]):
        print(f"  {k:13s} {v:.4f} s  {100 * v / max(ctot, 1e-12):5.1f}%")
    solve3d = info.phases.get("solve3d", 0.0)
    print(f"solve3d program mg_smooth / solve3d wall = {comp.get('mg_smooth', 0.0):.4f}"
          f" / {solve3d:.4f} s")
    top = sorted(r["unnamed"].items(), key=lambda kv: -kv[1])[:12]
    for (key, module, op), v in top:
        print(f"  {key} op {module}/{op}: {v:.4f} s")
    shutil.rmtree(dump, ignore_errors=True)  # large; the numbers are printed
    return 0


if __name__ == "__main__":
    sys.exit(main())
