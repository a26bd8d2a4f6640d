#!/usr/bin/env python3
"""Smoke test of the vector-potential solve on a GPU, in one process.

    python chip_smoke.py          one card: phases 1-5 below
    python chip_smoke.py --four   four cards: the sharded paths, each
                                  against the same problem on device 0

Phases (one card):
  1. vector_potential at 220^3 with the default Options() (mixed on a
     GPU): golden gate, cold/warm wall, phases, cycles, peak memory.
  2. the same solve with precision="fp64", smoother="masked",
     coarse_solver="relax" (the plain-reference algorithm): golden gate,
     and the mixed-vs-fp64 agreement bound (MIXED_VS_FP64_FRAC below).
  3. vector_potential at 512^3: h^2-trend gate, warm wall, phases, peak.
  4. the color-compact sweep against the masked sweep after 5 sweeps at
     256^3 (f64 and f32), then the smoother's rate at 256^3 and 512^3 in
     f32 beside a device copy timed in the same process.
  5. PoissonBVP at 256^3 with mixed Dirichlet/Neumann BCs, mixed against
     fp64.

Everything runs on device 0 (and on devices 0-3 with --four).  A phase
whose gate fails raises, and the script exits non-zero without the
final line.  The last stdout line, printed only when every phase
passed, is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

The script refuses to run without a GPU: it has no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ONE_CARD_PHASES = ("vp_mixed", "vp_fp64", "vp_large", "smoother", "poisson")
FOUR_CARD_PHASES = ("four_vp", "four_sharded", "four_gspmd")

#: Problem sizes of the chip run.  Tests rehearse the phases at small
#: sizes on the CPU by passing their own table.
CHIP_SIZES = {
    "vp": 220,  # the reference's largest golden row
    "vp_large": 512,  # BASELINE config 4's size
    "smooth_check": 256,
    "smooth_rate": (256, 512),
    "poisson": 256,  # the size BASELINE.json names
    "four_vp": 220,
    "four_poisson": 256,
}

#: Mixed and fp64 solves both stop at du < vc_tol = 1e-10, so their
#: fields differ at the level of that tolerance (times 1/h for B), while
#: the golden Ea_max and Eb_max are truncation errors of O(h^2) ~ 1e-5
#: and 1e-3 at 220^3.  A bound of 1e-3 x the golden errors sits three
#: decades under the truncation error and far above vc_tol, so it fails
#: only if the two precisions converge to different discrete solutions.
MIXED_VS_FP64_FRAC = 1e-3

#: PoissonBVP solves in two precisions: each stops when the last V-cycle
#: changed u by < vc_tol; with a V-cycle contraction factor <= 1/2 each
#: iterate is then within vc_tol of the discrete solution, so the two
#: differ by <= 2 vc_tol.  10 vc_tol leaves a factor 5 of margin.
POISSON_MIXED_BOUND_VC = 10.0

#: Sharded against single-device fp64: the same arithmetic in another
#: order of summation, so agreement is at rounding level.
FP64_SHARDED_RTOL = 1e-12

#: The color-compact and masked sweeps compute the same expressions on
#: the same values; they differ only where the compiler contracts
#: multiply-adds (FMA) or orders sums differently.
COMPACT_VS_MASKED_RTOL = {"float64": 1e-12, "float32": 1e-5}

#: Bytes a point-sweep must move at least: read u, read rhs, write u.
SWEEP_FLOOR_BYTES_F32 = 12.0


class GateFailed(RuntimeError):
    """A phase's correctness gate did not hold."""


def say(msg: str) -> None:
    print(msg, flush=True)


def gate(ok: bool, msg: str) -> None:
    say(("  PASS " if ok else "  FAIL ") + msg)
    if not ok:
        raise GateFailed(msg)


def max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def rel_max_diff(a, b) -> float:
    """max|a - b| / max|b| (0 when both are all zero)."""
    scale = float(np.max(np.abs(np.asarray(b))))
    d = max_abs_diff(a, b)
    return d / scale if scale > 0 else d


def select_phases(four: bool) -> tuple:
    return FOUR_CARD_PHASES if four else ONE_CARD_PHASES


def final_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _fmt_peak() -> str:
    p = peak_bytes()
    return "not reported" if p is None else f"{p / 2**30:.3f} GiB"


# ----------------------------------------------------------------------
# Problem set-up
# ----------------------------------------------------------------------


def vp_case(n: int):
    """The reference's analytic potential-field case on its n^3 test mesh:
    ((x, y, z), A_exact, b)."""
    from ndsm_tpu.utils.testing import build_test_mesh, potential_field_case

    x, y, z = build_test_mesh(n)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    A1, b1 = potential_field_case(X, Y, Z)
    return (x, y, z), A1, b1


def vp_errors(A1, b1, A, B):
    ea = float(np.linalg.norm(A1 - A, axis=0).max())
    eb = float(np.linalg.norm(b1 - B, axis=0).max())
    return ea, eb


def timed_vp(mesh, b1, options, dist=None, reps: int = 2):
    """Run vector_potential ``reps`` times (the first compiles) and
    return (ierr, A, B, info, walls)."""
    from ndsm_tpu import vector_potential

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ierr, A, B, info = vector_potential(
            *mesh, b1, options=options, full_output=True, dist=dist
        )
        walls.append(time.perf_counter() - t0)
    return ierr, A, B, info, walls


def report_vp(label: str, n: int, ierr, info, walls, ea, eb) -> None:
    from ndsm_tpu.utils.testing import accuracy_gate

    say(f"  {label}: walls (cold, warm) = "
        + ", ".join(f"{w:.4f} s" for w in walls))
    say("  phases (warm): " + ", ".join(
        f"{k}={v:.4f}s" for k, v in (info.phases or {}).items()))
    say("  cycles: " + ", ".join(
        f"{s.name}={s.cycles}" for s in info.chi + info.components))
    say(f"  process peak device memory so far: {_fmt_peak()}")
    gate(ierr == 0, f"ierr == 0 (got {ierr})")
    ok, desc = accuracy_gate(n, ea, eb)
    gate(ok, desc)


def poisson_case(n: int):
    """A 3D Poisson problem with mixed Dirichlet/Neumann faces, smooth
    right-hand side and nonzero Dirichlet data carried in u0."""
    from ndsm_tpu import GridHierarchy

    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bcs = (("D", "N"), ("N", "D"), ("D", "D"))
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    rhs = np.sin(np.pi * X) * np.cos(2 * np.pi * Y) * (1.0 + Z)
    u0 = np.zeros((n, n, n))
    u0[0] = np.cos(np.pi * X[0]) * np.sin(np.pi * Y[0])
    u0[:, :, -1] = 0.5 * Z[:, :, -1]
    return h, bcs, u0, rhs


def timed_solve(bvp, u0, rhs, reps: int = 2):
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        u, info = bvp.solve(u0, rhs)
        u = np.asarray(u)
        walls.append(time.perf_counter() - t0)
    return u, info, walls


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------


def phase_vp_mixed(ctx) -> None:
    from ndsm_tpu import Options

    n = ctx.sizes["vp"]
    opts = Options()
    say(f"phase 1: vector_potential {n}^3, Options() -> "
        f"precision {opts.resolve_precision()!r}")
    mesh, A1, b1 = vp_case(n)
    ierr, A, B, info, walls = timed_vp(mesh, b1, opts)
    ea, eb = vp_errors(A1, b1, A, B)
    report_vp("default", n, ierr, info, walls, ea, eb)
    ctx.vp_default = (mesh, A1, b1, A, B)


def phase_vp_fp64(ctx) -> None:
    from ndsm_tpu import Options
    from ndsm_tpu.utils.testing import golden_targets

    n = ctx.sizes["vp"]
    say(f"phase 2: vector_potential {n}^3, fp64 + masked smoother + "
        "relax coarse solve")
    if ctx.vp_default is None:
        ctx.vp_default = (*vp_case(n), None, None)
    mesh, A1, b1, A_def, B_def = ctx.vp_default
    opts = Options(precision="fp64", smoother="masked", coarse_solver="relax")
    ierr, A, B, info, walls = timed_vp(mesh, b1, opts)
    ea, eb = vp_errors(A1, b1, A, B)
    report_vp("fp64", n, ierr, info, walls, ea, eb)
    if A_def is not None:
        g_ea, g_eb, _ = golden_targets(n)
        da, db = max_abs_diff(A_def, A), max_abs_diff(B_def, B)
        gate(da <= MIXED_VS_FP64_FRAC * g_ea,
             f"max|A_default - A_fp64| = {da:.3e} <= "
             f"{MIXED_VS_FP64_FRAC:g} x Ea_golden = {MIXED_VS_FP64_FRAC * g_ea:.3e}")
        gate(db <= MIXED_VS_FP64_FRAC * g_eb,
             f"max|B_default - B_fp64| = {db:.3e} <= "
             f"{MIXED_VS_FP64_FRAC:g} x Eb_golden = {MIXED_VS_FP64_FRAC * g_eb:.3e}")
    ctx.vp_default = None  # release the host arrays


def phase_vp_large(ctx) -> None:
    from ndsm_tpu import Options

    n = ctx.sizes["vp_large"]
    opts = Options()
    say(f"phase 3: vector_potential {n}^3, Options() -> "
        f"precision {opts.resolve_precision()!r}")
    mesh, A1, b1 = vp_case(n)
    ierr, A, B, info, walls = timed_vp(mesh, b1, opts)
    ea, eb = vp_errors(A1, b1, A, B)
    report_vp("default", n, ierr, info, walls, ea, eb)


def smoother_rate(m: int, K: int = 8) -> dict:
    """Rate of the production f32 smoother (``MGEngine.t_smooth``, ms
    sweeps per call, inside one compiled K-call loop) and of a device
    copy (negation: one read and one write per point) of an array of
    the same shape, both K-differenced (t(3K) - t(K)) so the fixed
    launch and fetch cost cancels."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ndsm_tpu import GridHierarchy, Options
    from ndsm_tpu.mg.poisson import PoissonBVP

    x = np.linspace(0.0, 1.0, m)
    h = GridHierarchy.from_mesh((x, x, x), ngrids=2)
    bcs = (("D", "D"), ("D", "D"), ("N", "N"))
    bvp = PoissonBVP(h, bcs, Options(precision="mixed"))
    eng = bvp._inner  # the f32 engine a mixed solve smooths with
    ms = eng.ms
    ka, kb = jax.random.split(jax.random.key(0))
    u = jax.random.normal(ka, (m, m, m), jnp.float32)
    r = jax.random.normal(kb, (m, m, m), jnp.float32)

    @jax.jit
    def smooth_loop(k, u, r):
        return jnp.sum(lax.fori_loop(0, k, lambda _, v: eng.t_smooth(v, r, 0), u))

    @jax.jit
    def copy_loop(k, u):
        return jnp.sum(lax.fori_loop(0, k, lambda _, v: -v, u))

    def k_diff(fn, *args):
        k1, k3 = jnp.int32(K), jnp.int32(3 * K)
        float(fn(k1, *args))  # compile + warm
        float(fn(k3, *args))
        t0 = time.perf_counter()
        float(fn(k1, *args))
        d1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(fn(k3, *args))
        d3 = time.perf_counter() - t0
        return max(d3 - d1, 1e-9)

    dt_s = k_diff(smooth_loop, u, r)
    dt_c = k_diff(copy_loop, u)
    pts = float(m) ** 3
    sweep_rate = pts * 2 * K * ms / dt_s
    copy_gbs = pts * 4.0 * 2.0 * 2 * K / dt_c / 1e9
    floor_gbs = sweep_rate * SWEEP_FLOOR_BYTES_F32 / 1e9
    return {
        "m": m,
        "gsweeps": sweep_rate / 1e9,
        "floor_gbs": floor_gbs,
        "copy_gbs": copy_gbs,
        "share_of_copy": floor_gbs / copy_gbs,
    }


def phase_smoother(ctx) -> None:
    import jax
    import jax.numpy as jnp

    from ndsm_tpu import GridHierarchy
    from ndsm_tpu.mg.engine import MGEngine

    n = ctx.sizes["smooth_check"]
    say(f"phase 4: color-compact vs masked sweep, 5 sweeps at {n}^3")
    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x), ngrids=2)
    bcs = (("D", "D"), ("N", "N"), ("D", "N"))
    for dtype in (jnp.float64, jnp.float32):
        name = jnp.dtype(dtype).name
        ka, kb = jax.random.split(jax.random.key(1))
        u = jax.random.normal(ka, (n, n, n), dtype)
        r = jax.random.normal(kb, (n, n, n), dtype)
        outs = []
        for compact in (True, False):
            eng = MGEngine(h, bcs, ms=5, du_max=True, dtype=dtype,
                           compact_smoother=compact)
            outs.append(jax.jit(lambda u, r, e=eng: e.t_smooth(u, r, 0))(u, r))
        rel = float(jnp.max(jnp.abs(outs[0] - outs[1])) / jnp.max(jnp.abs(outs[1])))
        tol = COMPACT_VS_MASKED_RTOL[name]
        gate(rel <= tol, f"{name}: max|compact - masked| / max|masked| = "
             f"{rel:.3e} <= {tol:g}")
    card = ctx.card
    for m in ctx.sizes["smooth_rate"]:
        s = smoother_rate(m)
        say(f"  smoother f32 {m}^3 on [{card}]: {s['gsweeps']:.3f} G point-sweeps/s"
            f" = {s['floor_gbs']:.1f} GB/s at {SWEEP_FLOOR_BYTES_F32:g} B/point-sweep;"
            f" device copy {s['copy_gbs']:.1f} GB/s; ratio {s['share_of_copy']:.3f}")
        gate(np.isfinite(s["gsweeps"]) and s["gsweeps"] > 0,
             f"smoother rate at {m}^3 is finite and positive")


def phase_poisson(ctx) -> None:
    from ndsm_tpu import Options
    from ndsm_tpu.mg.poisson import PoissonBVP

    n = ctx.sizes["poisson"]
    say(f"phase 5: PoissonBVP {n}^3, mixed D/N faces, mixed vs fp64")
    h, bcs, u0, rhs = poisson_case(n)
    res = {}
    for prec in ("mixed", "fp64"):
        opts = Options(precision=prec)
        u, info, walls = timed_solve(PoissonBVP(h, bcs, opts), u0, rhs)
        say(f"  {prec}: cycles={info.cycles} du={info.du_last:.3e} walls (cold, warm) = "
            + ", ".join(f"{w:.4f} s" for w in walls))
        gate(info.ierr == 0 and np.all(np.isfinite(u)),
             f"{prec}: ierr == 0 and finite (ierr {info.ierr})")
        res[prec] = (u, opts.vc_tol)
    d = max_abs_diff(res["mixed"][0], res["fp64"][0])
    bound = POISSON_MIXED_BOUND_VC * res["fp64"][1]
    gate(d <= bound, f"max|u_mixed - u_fp64| = {d:.3e} <= "
         f"{POISSON_MIXED_BOUND_VC:g} x vc_tol = {bound:.1e}")
    say(f"  process peak device memory so far: {_fmt_peak()}")


def phase_four_vp(ctx) -> None:
    from ndsm_tpu import Options
    from ndsm_tpu.parallel.shard import DistConfig, make_mesh
    from ndsm_tpu.utils.testing import golden_targets

    n = ctx.sizes["four_vp"]
    opts = Options(precision="mixed")
    say(f"four 1: vector_potential {n}^3 mixed, DistConfig over 4 devices "
        "('z',) against device 0")
    mesh, A1, b1 = vp_case(n)
    ierr0, A0, B0, info0, walls0 = timed_vp(mesh, b1, opts, reps=1)
    ea0, eb0 = vp_errors(A1, b1, A0, B0)
    report_vp("device 0", n, ierr0, info0, walls0, ea0, eb0)
    dist = DistConfig(mesh=make_mesh(4), axis_names=("z",))
    ierr, A, B, info, walls = timed_vp(mesh, b1, opts, dist=dist)
    ea, eb = vp_errors(A1, b1, A, B)
    report_vp("4 devices", n, ierr, info, walls, ea, eb)
    g_ea, g_eb, _ = golden_targets(n)
    da, db = max_abs_diff(A, A0), max_abs_diff(B, B0)
    gate(da <= MIXED_VS_FP64_FRAC * g_ea,
         f"max|A_4dev - A_dev0| = {da:.3e} <= {MIXED_VS_FP64_FRAC * g_ea:.3e}")
    gate(db <= MIXED_VS_FP64_FRAC * g_eb,
         f"max|B_4dev - B_dev0| = {db:.3e} <= {MIXED_VS_FP64_FRAC * g_eb:.3e}")


def _four_poisson(ctx, label: str, make_bvp) -> None:
    """Solve the phase-5 problem with ``make_bvp(h, bcs, opts)`` and with
    a device-0 PoissonBVP, in fp64 and in mixed, and compare."""
    from ndsm_tpu import Options
    from ndsm_tpu.mg.poisson import PoissonBVP

    n = ctx.sizes["four_poisson"]
    h, bcs, u0, rhs = poisson_case(n)
    for prec in ("fp64", "mixed"):
        # one coarse solver on both sides, so fp64 compares like with like
        opts = Options(precision=prec, coarse_solver="direct")
        u_ref, i_ref, _ = timed_solve(PoissonBVP(h, bcs, opts), u0, rhs, reps=1)
        u, info, walls = timed_solve(make_bvp(h, bcs, opts), u0, rhs)
        say(f"  {label} {prec}: cycles {info.cycles} (device 0: {i_ref.cycles}); "
            "walls (cold, warm) = " + ", ".join(f"{w:.4f} s" for w in walls))
        gate(info.ierr == 0 and i_ref.ierr == 0, f"{prec}: ierr == 0 on both")
        if prec == "fp64":
            rel = rel_max_diff(u, u_ref)
            gate(rel <= FP64_SHARDED_RTOL,
                 f"fp64: max|u - u_dev0| / max|u_dev0| = {rel:.3e} <= {FP64_SHARDED_RTOL:g}")
        else:
            d = max_abs_diff(u, u_ref)
            bound = POISSON_MIXED_BOUND_VC * opts.vc_tol
            gate(d <= bound, f"mixed: max|u - u_dev0| = {d:.3e} <= {bound:.1e}")


def phase_four_sharded(ctx) -> None:
    from ndsm_tpu.parallel.shard import make_mesh_nd
    from ndsm_tpu.parallel.sm_engine import ShardedPoissonBVP

    n = ctx.sizes["four_poisson"]
    say(f"four 2: ShardedPoissonBVP {n}^3 on a (2, 2) ('z', 'y') mesh")
    mesh = make_mesh_nd((2, 2), ("z", "y"))
    _four_poisson(ctx, "shard_map", lambda h, bcs, o: ShardedPoissonBVP(
        h, bcs, o, mesh=mesh, axis_names=("z", "y")))


def phase_four_gspmd(ctx) -> None:
    from ndsm_tpu.mg.poisson import PoissonBVP
    from ndsm_tpu.parallel.shard import ShardSpec, make_mesh

    n = ctx.sizes["four_poisson"]
    say(f"four 3: PoissonBVP {n}^3 with a GSPMD ShardSpec over 4 devices")
    spec = ShardSpec(mesh=make_mesh(4))
    _four_poisson(ctx, "gspmd", lambda h, bcs, o: PoissonBVP(
        h, bcs, o, shard_spec=spec))


PHASES = {
    "vp_mixed": phase_vp_mixed,
    "vp_fp64": phase_vp_fp64,
    "vp_large": phase_vp_large,
    "smoother": phase_smoother,
    "poisson": phase_poisson,
    "four_vp": phase_four_vp,
    "four_sharded": phase_four_sharded,
    "four_gspmd": phase_four_gspmd,
}


class Context:
    def __init__(self, sizes: dict, card: str):
        self.sizes = sizes
        self.card = card
        self.vp_default = None


def run_phases(names, sizes: dict, card: str = "") -> None:
    """Run the named phases in order; the first failing gate raises."""
    ctx = Context(sizes, card)
    for name in names:
        t0 = time.perf_counter()
        PHASES[name](ctx)
        say(f"  [{name} done in {time.perf_counter() - t0:.1f} s]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded phases only")
    args = ap.parse_args(argv)

    import jax

    import ndsm_tpu
    from ndsm_tpu.utils.device import (
        checkout_root,
        device_record,
        gpu_identity,
        require_gpu,
        setup_compile_cache,
    )

    here = os.path.dirname(os.path.abspath(__file__))
    if checkout_root() != here:
        # The smoke test is of this checkout, not of an installed copy.
        print(f"chip_smoke: ndsm_tpu comes from {ndsm_tpu.__file__}, "
              f"not from this checkout ({here})", file=sys.stderr)
        return 2

    cache = setup_compile_cache()
    try:
        require_gpu()
    except SystemExit as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2
    card = gpu_identity()
    dev = device_record()
    say(f"card (nvidia-smi name, power.limit): {card}")
    say(f"jax devices: {dev}; compile cache: {cache}")
    run_phases(select_phases(args.four), CHIP_SIZES, card)
    say(final_line(device_record()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
