#!/usr/bin/env python3
"""Headline benchmark + north-star metrics.

Primary: full Coulomb-gauge vector-potential solve at NDSM_BENCH_N^3
(default 220 — the reference's largest golden configuration,
results_test1.txt row 9: 174.06 s max-metric on its multicore CPU).

Needs a GPU: without one it exits non-zero.  Prints the platform,
device kind and count, and the card's name and power limit, on stderr
before the result, and ONE JSON line whose required keys are
  {"metric": ..., "value": <wall seconds>, "unit": "s", "vs_baseline": <x>}
plus diagnostics:
  solve_s           wall of the nine sub-solves,
  transfer_s        wall - sub-solve time (result download + glue),
  cycles            per-sub-solve V-cycle counts,
  smoother_gdof_s   smoother-phase throughput in 1e9 stencil point-updates
                    per second, measured from a single compiled K-sweep
                    loop program at 256^3 (and smoother512_gdof_s at
                    512^3, the north-star size, BASELINE.json).

The run is accepted only if the computed errors match the golden table
(or, for non-golden sizes, the h^2 trend fitted to it); otherwise
vs_baseline is 0.0.

Env: NDSM_BENCH_N (220), NDSM_BENCH_PRECISION (mixed), NDSM_BENCH_REPS
(2), NDSM_BENCH_TIMEOUT (2700 s watchdog), NDSM_BENCH_THROUGHPUT (1 —
set 0 to skip the smoother-phase measurement), NDSM_BENCH_HOST_CURL (0),
NDSM_BENCH_ENCODING (f64).
"""

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from ndsm_tpu import vector_potential  # noqa: E402
from ndsm_tpu.utils.device import (  # noqa: E402
    device_record,
    gpu_identity,
    require_gpu,
    setup_compile_cache,
)
from ndsm_tpu.utils.testing import (  # noqa: E402
    GOLDEN,
    accuracy_gate,
    build_test_mesh,
    golden_targets,
    potential_field_case,
)

_REF_T220 = GOLDEN[220][2]
# The reference's fitted runtime exponent t ~ N^2.66 (ndsm_notes.pdf
# 5.1.2 Fig. 2), for extrapolating vs_baseline beyond 220^3.
_REF_EXP = 2.66


def _arm_watchdog(seconds: float, metric: str):
    """Emit a failure JSON and hard-exit if the benchmark wedges, so a
    caller always gets one line."""

    def fire():
        print(
            json.dumps(
                {
                    "metric": metric,
                    "value": -1.0,
                    "unit": "s",
                    "vs_baseline": 0.0,
                }
            ),
            flush=True,
        )
        print("bench watchdog fired: run exceeded budget", file=sys.stderr)
        os._exit(3)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def smoother_throughput(m: int):
    """Measure the production smoother's phase throughput at an m^3
    shape: K sweeps inside ONE compiled program, result reduced to a
    scalar on device and fetched (forces completion), K-differenced to
    subtract the fixed launch and fetch cost."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ndsm_tpu.grids import GridHierarchy
    from ndsm_tpu.mg.poisson import PoissonBVP
    from ndsm_tpu.options import Options

    x = np.linspace(0.0, 1.0, m)
    h = GridHierarchy.from_mesh((x, x, x), ngrids=2)
    bcs = (("D", "D"), ("D", "D"), ("N", "N"))
    bvp = PoissonBVP(h, bcs, Options(precision="mixed"))
    eng = bvp._inner  # float32 engine: the production smoothing path

    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((m, m, m)), jnp.float32)
    r = jnp.asarray(rng.standard_normal((m, m, m)), jnp.float32)
    K = 12  # K * ms sweeps per timed program
    ms = bvp.options.ms

    def loop(K, u, r):
        return jnp.sum(
            lax.fori_loop(0, K, lambda _, v: eng.t_smooth(v, r, 0), u)
        )

    f = jax.jit(loop, static_argnums=0)
    K2 = 3 * K
    float(jax.device_get(f(K, u, r)))  # warm (compile)
    float(jax.device_get(f(K2, u, r)))
    t0 = time.perf_counter()
    float(jax.device_get(f(K, u, r)))
    d1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(jax.device_get(f(K2, u, r)))
    d2 = time.perf_counter() - t0
    dt = max(d2 - d1, 1e-9)
    sweeps = (K2 - K) * ms
    rate = m**3 * sweeps / dt
    return {
        "smoother_shape": m,
        "smoother_gdof_s": round(rate / 1e9, 2),
    }


def main():
    n = int(os.environ.get("NDSM_BENCH_N", "220"))
    precision = os.environ.get("NDSM_BENCH_PRECISION", "mixed")
    setup_compile_cache()
    require_gpu()
    print(f"device: {device_record()}", file=sys.stderr)
    print(f"card (nvidia-smi name, power.limit): {gpu_identity()}",
          file=sys.stderr)
    reps = int(os.environ.get("NDSM_BENCH_REPS", "2"))
    do_tp = os.environ.get("NDSM_BENCH_THROUGHPUT", "1") != "0"

    budget = float(os.environ.get("NDSM_BENCH_TIMEOUT", "2700"))
    watchdog = _arm_watchdog(budget, f"vector_potential_{n}^3_wall_clock")

    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)

    # host_curl (B = curl(A) on the host from the downloaded A) and the
    # split16 download format are library options, off by default; the
    # bench measures the library defaults unless asked otherwise.
    from ndsm_tpu import Options

    host_curl = os.environ.get("NDSM_BENCH_HOST_CURL", "0") != "0"
    encoding = os.environ.get("NDSM_BENCH_ENCODING", "f64")
    opts = Options(
        precision=precision, host_curl=host_curl, fetch_encoding=encoding
    )

    # Warmup (includes compilation)
    t0 = time.perf_counter()
    ierr, A2, b2, winfo = vector_potential(
        x, y, z, b1.copy(), options=opts, full_output=True
    )
    warm = time.perf_counter() - t0
    print(f"warmup (incl. compile): {warm:.2f}s ierr={ierr}", file=sys.stderr)

    times = []
    info = None
    for _ in range(reps):
        # b1 is passed WITHOUT a defensive copy: the API reads only the
        # boundary faces and never mutates its input (asserted by
        # tests/test_api.py), and a 256 MB host copy inside the timed
        # region is overhead the reference doesn't pay.
        t0 = time.perf_counter()
        ierr, A2, b2, info = vector_potential(
            x, y, z, b1, options=opts, full_output=True
        )
        times.append(time.perf_counter() - t0)
    wall = min(times)
    solve_s = 0.0
    cycles = {}
    if info is not None:
        seen_batches = set()
        for s in info.chi + info.components:
            cycles[s.name] = s.cycles
            # batched lanes share one program wall; count it once
            key = (s.wall_time, s.batch_size)
            if s.batch_size > 1 and key in seen_batches:
                continue
            seen_batches.add(key)
            solve_s += s.wall_time
            print(
                f"  {s.name}: {s.wall_time:.3f}s cycles={s.cycles} "
                f"du={s.du_last:.2e} batch={s.batch_size}",
                file=sys.stderr,
            )
    pipeline_s = info.wall_time if info is not None else wall
    transfer_s = max(0.0, wall - solve_s)

    Ea = np.linalg.norm(A1 - A2, axis=0)
    Eb = np.linalg.norm(b1 - b2, axis=0)
    ea_max, eb_max = float(Ea.max()), float(Eb.max())

    gate_ok, gate_desc = accuracy_gate(n, ea_max, eb_max)
    ok = ierr == 0 and gate_ok
    g_ea, g_eb, golden = golden_targets(n)
    ref_extrapolated = not golden
    ref_time = (
        GOLDEN[n][2] if golden else _REF_T220 * (n / 220.0) ** _REF_EXP
    )
    print(f"errors: {gate_desc} accuracy_ok={ok}", file=sys.stderr)
    vs = (ref_time / wall) if (ok and ref_time) else 0.0

    # float32-download mode: the result arrays leave the device as f32,
    # halving the dominant transfer (with host_curl only A is fetched).
    # Measured as a SECOND configuration with its own accuracy fields:
    # the digit gate (matching the f64 golden digits to 2e-3 relative)
    # may legitimately fail at f32 resolution even though the physical
    # errors (~1e-5, truncation-dominated) are unchanged — the trend
    # gate (20% of the fitted h^2 law) is the meaningful bound there.
    f32_fields = {}
    if os.environ.get("NDSM_BENCH_F32_OUT", "1") != "0":
        import dataclasses as _dc

        opts32 = _dc.replace(opts, output_dtype="float32")
        t0 = time.perf_counter()
        ierr32, A3, b3, _ = vector_potential(
            x, y, z, b1.copy(), options=opts32, full_output=True
        )
        _w = time.perf_counter() - t0  # cold (new output-stage programs)
        t0 = time.perf_counter()
        ierr32, A3, b3, _ = vector_potential(
            x, y, z, b1.copy(), options=opts32, full_output=True
        )
        wall32 = time.perf_counter() - t0
        ea32 = float(np.linalg.norm(A1 - A3, axis=0).max())
        eb32 = float(np.linalg.norm(b1 - b3, axis=0).max())
        digit_ok32 = (
            ierr32 == 0
            and abs(ea32 - g_ea) < 2e-3 * g_ea
            and abs(eb32 - g_eb) < 2e-3 * g_eb
        )
        trend_ok32 = (
            ierr32 == 0
            and abs(ea32 - g_ea) < 0.2 * g_ea
            and abs(eb32 - g_eb) < 0.2 * g_eb
        )
        f32_fields = {
            "wall_f32_out": round(wall32, 4),
            "ea_max_f32": ea32,
            "eb_max_f32": eb32,
            "accuracy_digits_ok_f32": digit_ok32,
            # digits_ok_f32=False is the EXPECTED outcome for the f32
            # download mode (outputs truncated to f32 cannot reproduce
            # the golden table's f64 digits); the gate that must hold
            # for it is trend_ok (errors within 20% of golden).  The
            # headline gate is the f64 accuracy_ok field above.
            "accuracy_digits_f32_expected": False,
            "accuracy_trend_ok_f32": trend_ok32,
        }
        print(
            f"f32-out: wall={wall32:.2f}s Ea={ea32:.5e} Eb={eb32:.5e} "
            f"digits_ok={digit_ok32} trend_ok={trend_ok32}",
            file=sys.stderr,
        )

    out = {
        "metric": f"vector_potential_{n}^3_wall_clock",
        "value": round(wall, 4),
        "unit": "s",
        "vs_baseline": round(vs, 2),
        "solve_s": round(solve_s, 3),
        "transfer_s": round(transfer_s, 3),
        "pipeline_s": round(pipeline_s, 3),
        "cycles": cycles,
        "accuracy_ok": ok,
        "ea_max": ea_max,
        "eb_max": eb_max,
        "precision": precision,
        "host_curl": host_curl,
        "fetch_encoding": encoding,
        "phases": {
            k: round(v, 3) for k, v in (info.phases or {}).items()
        } if info is not None else {},
        "ref_time_extrapolated": ref_extrapolated,
    }
    out.update(f32_fields)
    if do_tp:
        # 256^3 and 512^3 (the north-star size, BASELINE.json) —
        # independent programs, the second skippable via
        # NDSM_BENCH_THROUGHPUT_512=0.
        out.update(smoother_throughput(256))
        if os.environ.get("NDSM_BENCH_THROUGHPUT_512", "1") != "0":
            tp = smoother_throughput(512)
            out["smoother512_gdof_s"] = tp["smoother_gdof_s"]

    watchdog.cancel()
    print(json.dumps(out))


if __name__ == "__main__":
    try:
        main()
    except BaseException as e:  # noqa: BLE001 — a caller needs ONE JSON line
        if isinstance(e, SystemExit):
            raise
        import traceback

        traceback.print_exc()
        n = os.environ.get("NDSM_BENCH_N", "220")
        print(
            json.dumps(
                {
                    "metric": f"vector_potential_{n}^3_wall_clock",
                    "value": -1.0,
                    "unit": "s",
                    "vs_baseline": 0.0,
                    "error": f"{type(e).__name__}: {e}"[:300],
                }
            ),
            flush=True,
        )
        sys.exit(2)
