"""Typed options and result records.

Replaces the reference's fixed-length ABI option vectors ``iopt``/``ropt``
(reference: fortran/ndsm_vector_potential.f90:40-57 and the getter functions
in fortran/ndsm_python_wrapper.f90:164-235) with a plain dataclass carrying
the same knobs and the same defaults (reference: ndsm.py:66).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

# Error codes (reference: fortran/ndsm_poisson.f90:46-47)
IERR_SUCCESS = 0  #: solve converged within ncycles_max
IERR_COVFAIL = 1  #: V-cycle iteration hit ncycles_max without du < vc_tol
#: invalid mesh (< 2 points along an axis).  The reference RETURNS a
#: nonzero flag for this instead of raising (ndsm_vector_potential.f90:
#: 212-215) but reuses the value 1 there; a distinct code keeps
#: convergence failure and input failure distinguishable (deliberate
#: fix, same no-exception contract).  Returned by vector_potential with
#: A = 0 and B = the input b, mirroring the reference's untouched
#: output buffers on this path.
IERR_BADMESH = 2


@dataclasses.dataclass(frozen=True)
class Options:
    """Solver options with the reference defaults (reference: ndsm.py:66).

    Attributes:
      ms: relaxation sweeps before/after each restriction/prolongation
        (reference IOPT_MS).
      ncycles_max: max V-cycles before declaring non-convergence
        (reference IOPT_NCYCLES).
      niterex_max: max relaxation iterations for the coarse "exact" solve
        (reference IOPT_NMAXEX).
      ex_tol: coarse-grid convergence tolerance on the inter-iteration
        change (reference ROPT_CTOL).
      vc_tol: V-cycle convergence tolerance on the inter-cycle change
        (reference ROPT_VTOL).
      mean: if True use the mean |change| as the convergence metric instead
        of the max (reference IOPT_DUMAX inverted; ndsm.py:196-199).
      debug: print per-phase / per-cycle diagnostics
        (reference IOPT_DEBUG; ndsm_root.f90:64).
      precision: "fp64" runs the whole algorithm in float64 (reference
        semantics); "mixed" runs each V-cycle in float32 inside an outer
        float64 defect-correction loop, which is algebraically equivalent
        for this linear problem and moves half the bytes per V-cycle;
        "fp32" runs everything in float32 (loose tolerances only).
        "auto" selects "fp64" on the CPU and "mixed" on any other device.
      flux_correction_order: 0 (default) adds the analytic flux-balance
        vector potential first and then takes the numerical curl;
        1 takes the curl first and adds both analytic corrections
        (reference IOPT_FLXCRL; ndsm_vector_potential.f90:453-477).
      host_curl: compute B = curl(A) on the HOST (numpy) from the
        downloaded A instead of on-device — same expressions, agreement
        at the 1-2 ulp level (XLA fuses FMAs; ~1e-14 relative, eight
        orders below the fields' h^2 truncation error) and HALF the
        result download.  Worth it only when the host<->device link is
        slow relative to host memory bandwidth, hence default off.
        Honored only for flux_correction_order=0 (the default, where B
        is a pure function of the returned A) and non-distributed runs;
        otherwise the device path is used.  Works for both output
        dtypes (float32 downloads are differenced in float64 on the
        host, exactly like the device path's f64-then-cast).
      per_face: solve the 3D BVPs one face at a time and sum (the
        reference's IOPT_FACE1 path is dead code due to a constant SELECT
        CASE — quirk Q1 in SURVEY.md; here the flag actually works).
      honor_ms_for_az: the reference hardcodes ms=5 for the Az solve
        (quirk Q3, ndsm_vector_potential.f90:685). True (default) uses
        ``ms`` uniformly; set False for bug-compatible behavior.
      reference_flux_quirk: the reference integrates every face's flux with
        the (dx, dy) spacings regardless of the face's in-plane axes
        (ndsm_vector_potential.f90:300-306), and differentiates chi with
        the face-normal axis spacing (ndsm_vector_potential.f90:394-397).
        For the cubic uniform meshes of all shipped tests this is
        immaterial. False (default) uses the correct per-axis spacings;
        True reproduces the reference bit patterns on anisotropic meshes.
    """

    ms: int = 5
    ncycles_max: int = 1024
    niterex_max: int = 10000
    #: Mixed precision: f32 V-cycles run against ONE f64 defect in
    #: deterministic groups of up to this many cycles (the group also
    #: stops when the per-cycle du drops under vc_tol), amortizing the
    #: f64 defect pass across the ~7 decades of convergence one f32
    #: solve supports.  1 recovers the strict one-V-cycle-per-defect
    #: iteration (used by checkpointed solves so chunking cannot split
    #: a group).
    mixed_inner_max: int = 6
    #: Coarsest-grid solver: "relax" iterates to ex_tol exactly like the
    #: reference (ndsm_multigrid_core.f90:728); "direct" applies a
    #: precomputed dense (pseudo)inverse in one matvec (same limit, no
    #: while_loop latency); "auto" = direct for mixed/fp32, relax for fp64.
    coarse_solver: str = "auto"
    #: Smoother formulation: "auto"/"compact" uses color-compact storage
    #: (half the memory traffic per sweep, rounding-identical results);
    #: "masked" uses the dense masked-update formulation.
    smoother: str = "auto"
    #: Solve the three 3D component problems (different BCs per lane) as
    #: ONE lane-masked program (mg/batched.MultiBCSolver) instead of
    #: sequentially: "on" batches; "auto" and "off" run them one after
    #: another.  Identical per-lane iterate sequences.
    batch_components: str = "auto"
    #: dtype of the returned A and B arrays. "float64" matches the
    #: reference ABI exactly; "float32" halves output memory/transfer —
    #: safe for production use since the outputs' truncation error is far
    #: above float32 resolution (the solve itself is unaffected).
    output_dtype: str = "float64"
    #: Wire format of the host-curl result download (float64 outputs
    #: only).  "f64" ships raw float64 (8 B/point, bit-exact).
    #: "split16" ships float32 + an int16 fixed-point correction
    #: (6 B/point, 25% less transfer); reconstruction error is bounded
    #: by max|A - f32(A)| / 32767 (~2e-13 for O(1) fields — five
    #: orders below the h^2 truncation error and below the printed
    #: golden-digit resolution; bench gates this on the golden tables).
    #: Ignored for float32 outputs and on the device-curl path.
    fetch_encoding: str = "f64"
    ex_tol: float = 1e-13
    vc_tol: float = 1e-10
    mean: bool = False
    debug: bool = False
    precision: str = "auto"
    flux_correction_order: int = 0
    host_curl: bool = False
    per_face: bool = False
    honor_ms_for_az: bool = True
    reference_flux_quirk: bool = False

    def __post_init__(self):
        _reject_removed_knobs()

    @property
    def du_max(self) -> bool:
        """True when the max-metric is in use (reference IOPT_DUMAX)."""
        return not self.mean

    def resolve_precision(self, platform: Optional[str] = None) -> str:
        if self.precision != "auto":
            return self.precision
        if platform is None:
            import jax

            platform = jax.devices()[0].platform
        return "fp64" if platform == "cpu" else "mixed"


#: Environment variables that once selected kernels, collectives or
#: precisions this package no longer has.  Setting one is an error, so
#: a configuration written for them cannot silently run something else.
REMOVED_ENV_KNOBS = (
    "NDSM_TPU_PALLAS",
    "NDSM_TPU_PALLAS_MIN_POINTS",
    "NDSM_TPU_PALLAS_NSWEEPS",
    "NDSM_TPU_PALLAS_2D",
    "NDSM_TPU_PALLAS2D_MIN_POINTS",
    "NDSM_TPU_ZC_VMEM",
    "NDSM_TPU_ZC_SCOPED",
    "NDSM_TPU_ZC_TILES",
    "NDSM_TPU_ZC_HALO_ARGS",
    "NDSM_TPU_ZC_EXT_OUT",
    "NDSM_TPU_PSUM_ONLY",
    "NDSM_TPU_NO_CALLBACKS",
    "NDSM_TPU_TRANSFER_PRECISION",
    "NDSM_TPU_HBM_BYTES",
)


def _reject_removed_knobs() -> None:
    found = [k for k in REMOVED_ENV_KNOBS if k in os.environ]
    if found:
        raise ValueError(
            f"environment variable(s) {', '.join(found)} no longer have "
            "any effect: the kernels, collectives and precisions they "
            "selected were removed; unset them"
        )


@dataclasses.dataclass
class SolveInfo:
    """Per-solve diagnostics.

    The reference only surfaces the ierr of the *last* 2D chi solve
    (quirk Q2, SURVEY.md); here every sub-solve reports its own status.
    """

    ierr: int = IERR_SUCCESS
    du_last: float = 0.0
    cycles: int = 0
    name: str = ""
    wall_time: float = 0.0
    #: True if ANY coarse-grid "exact" solve during this solve exhausted
    #: niterex_max without its inter-iterate change reaching ex_tol.  The
    #: reference only PRINTs a warning in this case and the flag is lost
    #: (ndsm_multigrid_core.f90:796-798); here it is carried first-class
    #: (and the warning is also printed, host-side, on every platform).
    coarse_noconv: bool = False
    #: Number of problems solved in the same compiled program as this one
    #: (solve_batch).  ``wall_time`` is the wall of that whole program —
    #: lanes run simultaneously, so no honest per-lane wall exists.
    batch_size: int = 1
    #: Per-cycle inter-iterate metric trace (the reference's debug-mode
    #: "Solution delta" lines, ndsm_poisson.f90:129-135), populated only
    #: by ``PoissonBVP.solve(..., history=True)``; length == cycles.
    du_history: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass
class VectorPotentialInfo:
    """Aggregate diagnostics for a full vector-potential solve."""

    ierr: int = IERR_SUCCESS
    chi: Tuple[SolveInfo, ...] = ()
    components: Tuple[SolveInfo, ...] = ()
    wall_time: float = 0.0
    #: per-phase wall seconds (keys: faces, chi, solve3d, post, fetch,
    #: curl — the last two only on the host-curl path).  The reference
    #: has a single whole-solve timer (ROPT_TIM); this decomposes it so
    #: transfer-bound and compute-bound time are distinguishable.
    phases: Optional[dict] = None
