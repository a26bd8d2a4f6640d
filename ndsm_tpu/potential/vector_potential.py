"""3D Coulomb-gauge vector-potential pipeline.

Given the normal component of B on the six faces of a Cartesian box,
computes the current-free (potential) field B and a vector potential A with
``B = curl(A)``, ``div(A) = 0`` (Yang, Wheatland & Gilchrist 2020).

Pipeline (reference: compute_vector_potential,
fortran/ndsm_vector_potential.f90:130-497; see SURVEY.md §3.1):

  1. extract Bn on the six faces (:283-293),
  2. trapezoid-rule fluxes per face (:300-306),
  3. six flux-balanced all-Neumann 2D Poisson solves for chi
     (laplace(chi) = Bn - Phi/Area) (:338-365),
  4. tangential vector-potential boundary data At = -grad(chi) x n with
     edge derivatives zeroed (:977-1031),
  5. three 3D mixed-BC vector-Laplace solves, one per component, with
     Neumann on the two faces normal to the component and Dirichlet (At
     data) on the other four (:598-691),
  6. analytic flux-balance correction fields (:880-950) and B = curl(A)
     (:759-811), in the order selected by ``flux_correction_order``
     (:453-477).

Deliberate fixes of reference quirks (SURVEY.md):
  Q1 — the per-face solve path is reachable here (``Options.per_face``);
  Q2 — every sub-solve's ierr is propagated (the reference returns only the
       last chi solve's flag);
  Q3 — ``ms`` is honored for the Az solve unless
       ``Options.honor_ms_for_az=False``.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..grids import GridHierarchy, mesh_uniformity_error
from ..options import Options, VectorPotentialInfo
from ..ops.deriv import curl
from ..ops.reduce import trapz_2d
from ..mg.poisson import get_poisson_bvp
from ..utils.msgs import debug_msg
from . import faces as F

__all__ = ["compute_vector_potential"]

_SUB = "compute_vector_potential"


def _dbg(options: Options, msg: str) -> None:
    """Host-side per-phase trace, mirroring the reference's debug_msg lines
    (ndsm_vector_potential.f90:257,337,385,405,451,487).  Pure Python — the
    pipeline is host-orchestrated, so no device callbacks are needed and
    the trace works identically on every platform."""
    if options.debug:
        debug_msg(_SUB, msg)


def _central_diff_zero_edges(c: jax.Array, h: float, axis: int) -> jax.Array:
    """Second-order central difference along ``axis`` with the derivative
    defined as zero on the first/last layer of that axis
    (reference compute_At_bcs, ndsm_vector_potential.f90:1006-1017)."""
    inv2h = jnp.asarray(0.5 / h, dtype=c.dtype)
    interior = (
        lax.slice_in_dim(c, 2, c.shape[axis], axis=axis)
        - lax.slice_in_dim(c, 0, c.shape[axis] - 2, axis=axis)
    ) * inv2h
    zshape = list(c.shape)
    zshape[axis] = 1
    z = jnp.zeros(zshape, dtype=c.dtype)
    return jnp.concatenate([z, interior, z], axis=axis)


def _dist_bvp(hierarchy, bcs, options, dist):
    """ShardedPoissonBVP for this sub-problem, or None if its shapes
    cannot be partitioned over the requested mesh (caller falls back to
    the single-device path).

    The cache key includes the full options tuple: ShardedPoissonBVP bakes
    tolerances/metric/precision/smoother into its compiled program, so two
    calls differing only in Options must not share a handle."""
    import dataclasses as _dc

    from ..parallel.sm_engine import ShardedPoissonBVP

    key = (hierarchy, tuple(tuple(x) for x in bcs), _dc.astuple(options), dist)
    cached = _DIST_BVP_CACHE.get(key)
    if cached is not None:
        return cached
    try:
        bvp = ShardedPoissonBVP(
            hierarchy,
            bcs,
            options,
            mesh=dist.mesh,
            axis_names=dist.axis_names[: hierarchy.ndim - 1],
            min_rows_per_shard=dist.min_rows_per_shard,
        )
    except ValueError:
        bvp = None
    _DIST_BVP_CACHE.put(key, bvp)
    return bvp


from ..utils.caching import BoundedCache as _BoundedCache

_DIST_BVP_CACHE: _BoundedCache = _BoundedCache(maxsize=32)
_MBS_CACHE: _BoundedCache = _BoundedCache(maxsize=16)
_SLAB_SPLIT_CACHE: _BoundedCache = _BoundedCache(maxsize=16)


def compute_vector_potential(
    meshes: Sequence[np.ndarray],
    b,
    options: Options = Options(),
    dist=None,
) -> Tuple[int, jax.Array, jax.Array, VectorPotentialInfo]:
    """Compute (ierr, A, B, info) from boundary Bn.

    Args:
      meshes: (x, y, z) 1-D coordinate vectors (uniform spacing each).
      b: (3, nz, ny, nx) array; only the normal components on the six
        boundary faces are read (quirk Q12) — B is recomputed in full.
      options: solver options.

    Returns:
      ierr: 0 on success; max over all nine sub-solves' flags.
      A: (3, nz, ny, nx) vector potential.
      B: (3, nz, ny, nx) magnetic field = curl(A) (+ corrections).
      info: per-solve diagnostics.
    """
    t0 = time.perf_counter()
    phases: dict = {}
    _t_last = [t0]

    def _mark(name, sync=None):
        """Record wall time since the previous mark under ``name``.
        Syncing on the phase's output keeps the attribution honest; the
        phases are serialized by data dependencies anyway, so the only
        added cost is one device round-trip per boundary."""
        if sync is not None:
            jax.block_until_ready(sync)
        now = time.perf_counter()
        phases[name] = phases.get(name, 0.0) + (now - _t_last[0])
        _t_last[0] = now

    mesh_in = tuple(np.asarray(m) for m in meshes)  # original dtype
    x, y, z = (np.asarray(m, dtype=np.float64) for m in meshes)
    mesh_xyz = (x, y, z)
    mode = options.resolve_precision()
    dtype = jnp.float32 if mode == "fp32" else jnp.float64

    def _badmesh_return():
        # The reference RETURNS a nonzero flag for a bad mesh instead
        # of raising (ndsm_vector_potential.f90:212-215, where it
        # reuses the value 1); IERR_BADMESH keeps input failure
        # distinguishable from convergence failure.  Output contract
        # mirrors the reference's untouched buffers: A = 0, B = the
        # input b — in the SAME dtype the normal path would return
        # (the error path must not widen f32 outputs).
        from ..options import IERR_BADMESH

        b_arr = np.asarray(b, dtype=np.dtype(dtype))
        A0 = np.zeros_like(b_arr)
        info = VectorPotentialInfo(
            ierr=IERR_BADMESH, wall_time=time.perf_counter() - t0
        )
        return IERR_BADMESH, A0, b_arr.copy(), info

    for i, m in enumerate(mesh_xyz):
        if m.ndim != 1:
            raise ValueError(f"mesh vector {i} must be 1-D")
        if m.size < 2:
            return _badmesh_return()
        # Non-uniform spacing is the one input error that corrupts
        # results instead of crashing (every dq below is m[1]-m[0]) —
        # flag it like the reference flags a too-small mesh.  Checked on the ORIGINAL input, whose dtype
        # sets the representable-jitter floor (f32 meshes are fine).
        if mesh_uniformity_error(mesh_in[i]) is not None:
            return _badmesh_return()
    # Narrow-dtype meshes (e.g. float32) pass validation but their f64
    # copies still carry ~eps(dtype)*|m| jitter; regenerate them as
    # exactly-uniform f64 over the same extent (identical within the
    # input's own precision; f64 inputs stay bit-identical — the
    # golden-digit paths).  GridHierarchy.from_mesh does the same.
    x, y, z = (
        m
        if mi.dtype == np.float64
        else np.linspace(float(m[0]), float(m[-1]), m.size)
        for mi, m in zip(mesh_in, mesh_xyz)
    )
    mesh_xyz = (x, y, z)
    b = np.asarray(b)
    nz, ny, nx = len(z), len(y), len(x)
    if b.shape != (3, nz, ny, nx):
        raise ValueError(f"b shape {b.shape} != (3, {nz}, {ny}, {nx})")

    # Mesh extents and (uniform) spacings
    # (reference: ndsm_vector_potential.f90:201-221).
    Lq = np.array([m.max() - m.min() for m in mesh_xyz])
    dq = np.array([m[1] - m[0] for m in mesh_xyz])

    # ------------------------------------------------------------------
    # Faces: extract Bn, fluxes, areas
    # ------------------------------------------------------------------
    # Only the six boundary-face normal components of b are read (quirk
    # Q12); extract them host-side so the full volume is never uploaded.
    _dbg(options, "Extract boundary conditions and face fluxes...")
    bn = []
    for f in range(6):
        comp = F.FACE_COMP[f]
        idx = F.face_volume_index(f, (nz, ny, nx))
        bn.append(jnp.asarray(np.ascontiguousarray(b[comp][idx]), dtype=dtype))

    spacings = []
    for f in range(6):
        d1, d2 = F.FACE_DIMS[f]
        if options.reference_flux_quirk:
            # Reference integrates every face with (dx, dy)
            # (ndsm_vector_potential.f90:300-306).
            spacings.append((float(dq[0]), float(dq[1])))
        else:
            spacings.append((float(dq[d2]), float(dq[d1])))
    areas = tuple(float(Lq[d1] * Lq[d2]) for (d1, d2) in F.FACE_DIMS)
    chi_rhs, phi = _phase_pre(tuple(bn), tuple(spacings), areas)
    _mark("faces", chi_rhs)

    # ------------------------------------------------------------------
    # Six all-Neumann 2D solves: laplace(chi) = Bn - Phi/Area
    # (reference: ndsm_vector_potential.f90:338-365)
    # ------------------------------------------------------------------
    # Group faces by identical 2D hierarchy (opposite faces always pair;
    # all six coincide for a cubic mesh) and solve each group as ONE
    # lane-masked batched program — semantics per face are unchanged, but
    # dispatch/latency cost drops from 6 solves to <= 3 (1 when cubic).
    _dbg(options, "Solve BVP on each boundary...")
    chi = [None] * 6
    chi_info = [None] * 6
    groups = {}
    for f in range(6):
        d1, d2 = F.FACE_DIMS[f]
        hierarchy = GridHierarchy.from_mesh((mesh_xyz[d2], mesh_xyz[d1]))
        groups.setdefault(hierarchy, []).append(f)
    for hierarchy, faces_in_group in groups.items():
        rhss = [chi_rhs[f] for f in faces_in_group]
        u0s = [jnp.zeros_like(r) for r in rhss]
        sbvp = (
            _dist_bvp(hierarchy, (("N", "N"), ("N", "N")), options, dist)
            if dist is not None
            else None
        )
        if sbvp is not None:
            # One lane-stacked sharded program per group (ppermute halo
            # volume and dispatch amortized over the faces), mirroring
            # the single-device batched path below.
            us, infos = sbvp.solve_batch(
                u0s,
                rhss,
                donate=True,
                names=[f"chi_face{f}" for f in faces_in_group],
            )
            for k, f in enumerate(faces_in_group):
                chi[f] = us[k]
                chi_info[f] = infos[k]
            continue
        bvp = get_poisson_bvp(hierarchy, (("N", "N"), ("N", "N")), options)
        us, infos = bvp.solve_batch(
            u0s,
            rhss,
            vc_tol=options.vc_tol,
            ex_tol=options.ex_tol,
            ncycles_max=options.ncycles_max,
            niterex_max=options.niterex_max,
            names=[f"chi_face{f}" for f in faces_in_group],
        )
        for k, f in enumerate(faces_in_group):
            chi[f] = us[k]
            chi_info[f] = infos[k]

    _mark("chi", chi)

    # ------------------------------------------------------------------
    # At = -grad(chi) x n, edge derivatives zeroed
    # (reference: ndsm_vector_potential.f90:387-399, 977-1031)
    # ------------------------------------------------------------------
    _dbg(options, "Compute vector potential boundary conditions...")
    hs = []
    for f in range(6):
        d1, d2 = F.FACE_DIMS[f]
        if options.reference_flux_quirk:
            # Reference differentiates with the *normal* axis' spacing
            # (ndsm_vector_potential.f90:394-397).
            hs.append((float(dq[F.FACE_COMP[f]]),) * 2)
        else:
            hs.append((float(dq[d1]), float(dq[d2])))
    signs = tuple(F.at_signs(f) for f in range(6))

    # ------------------------------------------------------------------
    # Three 3D mixed-BC solves (reference solve(), :598-691), or the
    # per-face superposition (reference solve_6faces(), :501-594).
    # ------------------------------------------------------------------
    comp_info = []

    def _solve_components(active_face: Optional[int]):
        u0s = _phase_at_u0(
            tuple(chi),
            tuple(hs),
            signs,
            (nz, ny, nx),
            active_face,
            jnp.zeros((), dtype=dtype),
        )
        comps = []
        for comp in range(3):
            # BCs per C axis (z, y, x): Neumann on the faces normal to
            # this component, Dirichlet elsewhere
            # (reference BC tables, :655,:671,:687).
            bcs = tuple(
                ("N", "N") if (2 - axis) == comp else ("D", "D") for axis in range(3)
            )
            u0 = u0s[comp]
            hierarchy = GridHierarchy.from_mesh((z, y, x))
            ms = options.ms
            if comp == 2 and not options.honor_ms_for_az:
                ms = 5  # reference hardcodes Az's ms (quirk Q3, :685)
            opts = options if ms == options.ms else __import__(
                "dataclasses"
            ).replace(options, ms=ms)
            nm = f"A{'xyz'[comp]}" + (
                "" if active_face is None else f"_face{active_face}"
            )
            sbvp = (
                _dist_bvp(hierarchy, bcs, opts, dist) if dist is not None else None
            )
            if sbvp is not None:
                u, info = sbvp.solve(
                    u0, None, zero_rhs=True, donate=True, name=nm
                )
            else:
                bvp = get_poisson_bvp(hierarchy, bcs, opts)
                u, info = bvp.solve(
                    u0,
                    None,
                    vc_tol=options.vc_tol,
                    ex_tol=options.ex_tol,
                    ncycles_max=options.ncycles_max,
                    niterex_max=options.niterex_max,
                    name=nm,
                    zero_rhs=True,
                    donate=True,  # u0 is pipeline-internal
                )
            comp_info.append(info)
            # Early downcast when float32 outputs are requested: frees the
            # f64 solution before the next component solves (the output
            # accuracy is truncation-dominated far above f32 resolution).
            if jnp.dtype(getattr(options, "output_dtype", "float64")) == jnp.float32:
                u = u.astype(jnp.float32)
            comps.append(u)
        return jnp.stack(comps)

    def _solve_components_batched():
        """All three component solves in ONE lane-masked program
        (mg/batched.MultiBCSolver) — per-lane iterate sequences identical
        to the sequential path."""
        from ..mg.batched import MultiBCSolver
        import dataclasses as _dc

        u0s = _phase_at_u0(
            tuple(chi), tuple(hs), signs, (nz, ny, nx), None,
            jnp.zeros((), dtype=dtype),
        )
        hierarchy = GridHierarchy.from_mesh((z, y, x))
        bcs_list = [
            tuple(("N", "N") if (2 - axis) == comp else ("D", "D") for axis in range(3))
            for comp in range(3)
        ]
        key = (hierarchy, tuple(bcs_list), _dc.astuple(options))
        mbs = _MBS_CACHE.get(key)
        if mbs is None:
            mbs = MultiBCSolver(hierarchy, bcs_list, options)
            _MBS_CACHE.put(key, mbs)
        u, infos = mbs.solve(jnp.stack(u0s), names=["Ax", "Ay", "Az"])
        comp_info.extend(infos)
        if jnp.dtype(getattr(options, "output_dtype", "float64")) == jnp.float32:
            u = u.astype(jnp.float32)
        return u

    _dbg(options, "Solve BVP 3D...")
    bc_mode = getattr(options, "batch_components", "auto")
    if bc_mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown batch_components {bc_mode!r}")
    # "auto" runs the components one after another; "on" runs them as
    # one lane-masked program where that is possible.
    batch_ok = (
        bc_mode == "on"
        and not options.per_face
        and dist is None
        and options.honor_ms_for_az  # per-lane ms differs otherwise (Q3)
    )
    if options.per_face:
        A = jnp.zeros((3, nz, ny, nx), dtype=dtype)
        for f in range(6):
            A = A + _solve_components(f)
    elif batch_ok:
        A = _solve_components_batched()
    else:
        A = _solve_components(None)
    _mark("solve3d", A)

    # ------------------------------------------------------------------
    # Flux-balance correction + curl (reference :453-477; default order:
    # analytic A correction first, then B = curl(A) numerically)
    # ------------------------------------------------------------------
    _dbg(options, "Compute B = curl(A) and flux correction...")
    out_dtype = jnp.dtype(getattr(options, "output_dtype", "float64")).name
    host_curl = (
        bool(getattr(options, "host_curl", False))
        and int(options.flux_correction_order) == 0
        and dist is None
    )
    if host_curl:
        # Order 0: B = curl(final A) exactly, so compute it on the host
        # from the A we download anyway — ulp-identical to the device
        # result (ops/deriv.curl_np_into) at HALF the result traffic
        # (Options.host_curl).
        A = _phase_post_acorr(
            A,
            phi,
            jnp.asarray(x, dtype=dtype),
            jnp.asarray(y, dtype=dtype),
            jnp.asarray(z, dtype=dtype),
            tuple(float(v) for v in Lq),
            out_dtype,
        )
        _mark("post", A)
        A, B = _fetch_and_curl_pipelined(
            A,
            tuple(float(v) for v in dq),
            out_dtype,
            _mark,
            encoding=str(getattr(options, "fetch_encoding", "f64")),
        )
    else:
        A, B = _phase_post(
            A,
            phi,
            jnp.asarray(x, dtype=dtype),
            jnp.asarray(y, dtype=dtype),
            jnp.asarray(z, dtype=dtype),
            tuple(float(v) for v in Lq),
            tuple(float(v) for v in dq),
            int(options.flux_correction_order),
            out_dtype,
        )
        _mark("post", (A, B))

    ierr = max([s.ierr for s in chi_info] + [s.ierr for s in comp_info])
    info = VectorPotentialInfo(
        ierr=ierr,
        chi=tuple(chi_info),
        components=tuple(comp_info),
        wall_time=time.perf_counter() - t0,
        phases=phases,
    )
    return ierr, A, B, info


def _fetch_and_curl_pipelined(A_dev, dq, out_dtype, _mark, encoding="f64"):
    """Download A on concurrent z-slab streams and compute B = curl(A)
    on the host, pipelined: each z chunk's curl runs as soon as its
    neighborhood (chunks k-1, k, k+1 of all three components) has
    landed, so the host curl hides behind the transfer instead of
    serializing after it.

    Stream count: NDSM_TPU_FETCH_STREAMS (default 6);
    chunk count per component is at least 8 (when nz allows) so curl
    work overlaps even with few streams.

    Bitwise-identical to the serial path: ops/deriv.curl_np_into
    computes the same per-row expressions (differencing in float64 even
    for float32 outputs — the download already rounded A; don't add
    differencing rounding on top).
    """
    import concurrent.futures as _cf
    import threading as _th

    from ..ops.deriv import curl_np_into

    nstreams = max(1, int(os.environ.get("NDSM_TPU_FETCH_STREAMS", "6")))
    nz0 = int(A_dev.shape[1])
    total_mb = (
        float(np.prod(tuple(A_dev.shape)))
        * jnp.dtype(A_dev.dtype).itemsize
        / 1e6
    )
    # >= 3 rows per chunk (the one-sided z stencils at the global faces
    # span 3 rows, and curl chunk k reads only chunks k-1..k+1); chunk
    # count scales with the transfer size — every fetch task costs a
    # device round-trip, so small results take few big chunks.
    per_comp = max(
        1,
        min(
            max(-(-nstreams // 3), 8),
            nz0 // 3,
            max(1, int(total_mb / 8.0)),
        ),
    )
    bounds = tuple(
        (k * nz0) // per_comp for k in range(per_comp)
    ) + (nz0,)
    # CHUNK-major order: curl chunk k becomes ready once chunks k-1..k+1
    # of ALL components have landed, so fetching all components' chunk k
    # together lets the curl start after ~2 chunks instead of after the
    # last component's download.
    tasks = [
        (i, k)
        for k in range(per_comp)
        for i in range(3)
        if bounds[k + 1] > bounds[k]
    ]
    host = np.empty(tuple(A_dev.shape), dtype=out_dtype)
    B = np.empty(tuple(A_dev.shape), dtype=out_dtype)
    # The encode program adds fixed dispatch cost; below the threshold
    # the raw download is faster (NDSM_TPU_SPLIT16_MIN_MB, default 16;
    # tests set 0 to exercise the encoding on small arrays).
    min_mb = float(os.environ.get("NDSM_TPU_SPLIT16_MIN_MB", "16"))
    split16 = (
        encoding == "split16" and jnp.dtype(out_dtype) == jnp.float64
        and total_mb >= min_mb
    )
    # ONE jitted program produces every slab: per-slab __getitem__ would
    # compile a separate XLA program per (component, range).  Cached by (shape, dtype, bounds,
    # encoding).  The split16 program additionally encodes: hi = f32(A),
    # q = int16 round of (A - f64(hi)) on a global fixed-point scale —
    # 6 B/point on the wire instead of 8 (Options.fetch_encoding).
    key = (tuple(A_dev.shape), jnp.dtype(A_dev.dtype).name, bounds, split16)
    split_fn = _SLAB_SPLIT_CACHE.get(key)
    if split_fn is None:
        if split16:

            def _split(a):
                hi = a.astype(jnp.float32)
                corr = a - hi.astype(jnp.float64)
                s = jnp.max(jnp.abs(corr))
                scale = jnp.where(s > 0, 32767.0 / s, 0.0)
                q = jnp.round(corr * scale).astype(jnp.int16)
                return (
                    s,
                    tuple(hi[i, bounds[k] : bounds[k + 1]] for (i, k) in tasks),
                    tuple(q[i, bounds[k] : bounds[k + 1]] for (i, k) in tasks),
                )

        else:

            def _split(a):
                return tuple(a[i, bounds[k] : bounds[k + 1]] for (i, k) in tasks)

        split_fn = jax.jit(_split)
        _SLAB_SPLIT_CACHE.put(key, split_fn)
    inv_scale = 0.0
    if split16:
        s_dev, hi_slabs, q_slabs = split_fn(A_dev)
        jax.block_until_ready((hi_slabs, q_slabs))
        inv_scale = float(s_dev) / 32767.0
        slabs = {(0,) + t: hi_slabs[n] for n, t in enumerate(tasks)}
        slabs.update({(1,) + t: q_slabs[n] for n, t in enumerate(tasks)})
        # chunk-major across BOTH halves: hi and q of a chunk must
        # co-arrive before its reconstruction (and then its curl)
        fetch_tasks = sorted(slabs.keys(), key=lambda t: (t[2], t[1], t[0]))
    else:
        slabs = dict(zip(tasks, split_fn(A_dev)))
        jax.block_until_ready(list(slabs.values()))
        fetch_tasks = tasks
    _mark("slab_split")

    done = np.zeros((3, per_comp), dtype=bool)
    arrived = {}  # (i, k) -> first-arrived half, split16 only
    curled = np.zeros(per_comp, dtype=bool)
    lock = _th.Lock()
    curl_ex = _cf.ThreadPoolExecutor(max_workers=3)
    curl_futs = []

    def _ready(j):
        ks = range(max(0, j - 1), min(per_comp, j + 2))
        return all(done[i, k] for i in range(3) for k in ks)

    def _submit_curl(j):
        # two half-chunk tasks: the post-fetch serial tail is then one
        # HALF-chunk of differencing.  Both halves stay
        # inside the ready neighborhood (rows bounds[j]-1..bounds[j+1]).
        z0, z1 = bounds[j], bounds[j + 1]
        zm = (z0 + z1) // 2
        for a, b in ((z0, zm), (zm, z1)):
            if b > a:
                curl_futs.append(
                    curl_ex.submit(curl_np_into, host, dq, B, a, b)
                )

    def _mark_done_locked(i, k):
        done[i, k] = True
        newly = []
        for j in range(max(0, k - 2), min(per_comp, k + 3)):
            if not curled[j] and _ready(j):
                curled[j] = True
                newly.append(j)
        return newly

    def _fetch(t):
        data = np.asarray(slabs[t])
        if split16:
            a, i, k = t
            with lock:
                other = arrived.pop((i, k), None)
                if other is None:
                    arrived[(i, k)] = data
                    return
            hi, q = (other, data) if a == 1 else (data, other)
            host[i, bounds[k] : bounds[k + 1]] = hi + q * inv_scale
        else:
            i, k = t
            host[i, bounds[k] : bounds[k + 1]] = data
        with lock:
            newly = _mark_done_locked(i, k)
        for j in newly:
            _submit_curl(j)

    # try/finally: if a fetch task raises, the curl pool must still be
    # joined before unwinding — its in-flight workers read `host`
    # (a bare shutdown after the `with` would leak them on the error
    # path).
    try:
        with _cf.ThreadPoolExecutor(min(nstreams, len(fetch_tasks))) as _ex:
            list(_ex.map(_fetch, fetch_tasks))
        _mark("fetch")
        for f in curl_futs:
            f.result()
    finally:
        curl_ex.shutdown(wait=True)
    assert bool(curled.all()), "curl pipeline missed a chunk"
    _mark("curl")
    return host, B



def _add_flux_balance_fields(mesh_xyz, Lq, phi, B, A):
    """Analytic flux-balance fields (reference add_flux_balance_fields,
    ndsm_vector_potential.f90:880-950): a linear-in-coordinates magnetic
    field absorbing any net face flux, plus the matching vector potential
    A_c + (A1_l + A2_l + A3_l)/3.  ``B=None`` skips the field correction
    (used when the curl will overwrite it anyway)."""
    dtype = A.dtype
    x = jnp.asarray(mesh_xyz[0], dtype=dtype)[None, None, :]
    y = jnp.asarray(mesh_xyz[1], dtype=dtype)[None, :, None]
    z = jnp.asarray(mesh_xyz[2], dtype=dtype)[:, None, None]
    V = float(np.prod(np.asarray(Lq)))
    g = jnp.stack(
        [(phi[1] - phi[0]) / V, (phi[3] - phi[2]) / V, (phi[5] - phi[4]) / V]
    ).astype(dtype)

    bc = None
    if B is not None:
        bc = jnp.stack(
            [
                g[0] * x + phi[0] * Lq[0] / V + 0.0 * (y + z),
                g[1] * y + phi[2] * Lq[1] / V + 0.0 * (x + z),
                g[2] * z + phi[4] * Lq[2] / V + 0.0 * (x + y),
            ]
        )

    # Sum of the three linear-term potentials (:932-934):
    # A1_l + A2_l + A3_l = [(g2-g3) y z, (g3-g1) x z, (g1-g2) x y]
    lin = jnp.stack(
        [
            (g[1] - g[2]) * y * z + 0.0 * x,
            (g[2] - g[0]) * x * z + 0.0 * y,
            (g[0] - g[1]) * x * y + 0.0 * z,
        ]
    )
    # Constant-term potential (:937-939)
    Ac = jnp.stack(
        [
            -phi[4] * Lq[2] * y / V + 0.0 * (x + z),
            -phi[0] * Lq[0] * z / V + 0.0 * (x + y),
            -phi[2] * Lq[1] * x / V + 0.0 * (y + z),
        ]
    )
    B_out = None if B is None else B + bc
    return B_out, A + Ac + lin / 3.0

# ----------------------------------------------------------------------
# Jitted glue phases: fusing the non-solve pipeline into three compiled
# functions removes a few hundred eager op dispatches per call.
# ----------------------------------------------------------------------

from functools import partial as _partial


@_partial(jax.jit, static_argnames=("spacings", "areas"))
def _phase_pre(bn, spacings, areas):
    """Fluxes + flux-balanced chi right-hand sides for all six faces."""
    phi = jnp.stack(
        [trapz_2d(bn[f], spacings[f][0], spacings[f][1]) for f in range(6)]
    )
    rhs = tuple(bn[f] - phi[f] / areas[f] for f in range(6))
    return rhs, phi


@_partial(jax.jit, static_argnames=("hs", "signs", "vol_shape", "active_face"))
def _phase_at_u0(chi, hs, signs, vol_shape, active_face, dtype):
    """At = -grad(chi) x n for all faces, scattered into the three
    component initial guesses (Dirichlet data)."""
    At1, At2 = [], []
    for f in range(6):
        h1, h2 = hs[f]
        dchi_d1 = _central_diff_zero_edges(chi[f], h1, axis=1)
        dchi_d2 = _central_diff_zero_edges(chi[f], h2, axis=0)
        s1, s2 = signs[f]
        At1.append(s1 * dchi_d2)
        At2.append(s2 * dchi_d1)
    u0s = []
    for comp in range(3):
        u0 = jnp.zeros(vol_shape, dtype=dtype.dtype)
        for f in range(6):
            if F.FACE_COMP[f] == comp:
                continue
            if active_face is not None and f != active_face:
                continue
            slot = F.face_at_component(f, comp)
            data = At1[f] if slot == 1 else At2[f]
            u0 = u0.at[F.face_volume_index(f, vol_shape)].set(data)
        u0s.append(u0)
    return tuple(u0s)


@_partial(jax.jit, static_argnames=("Lq", "out_dtype"))
def _phase_post_acorr(A, phi, xs, ys, zs, Lq, out_dtype):
    """Order-0 flux-balance A correction WITHOUT the curl — the device
    side of the host-curl split (Options.host_curl): B = curl(A) is then
    a pure host-side function of this A."""
    _, A = _add_flux_balance_fields((xs, ys, zs), Lq, phi, None, A)
    if out_dtype is not None:
        A = A.astype(out_dtype)
    return A


@_partial(jax.jit, static_argnames=("Lq", "dq", "order", "out_dtype"))
def _phase_post(A, phi, xs, ys, zs, Lq, dq, order, out_dtype):
    """Flux-balance correction + curl in one compiled pass."""
    dqj = jnp.asarray(dq, dtype=A.dtype)
    mesh_xyz = (xs, ys, zs)
    if order == 1:
        B = curl(A, dqj)
        B, A = _add_flux_balance_fields(mesh_xyz, Lq, phi, B, A)
    else:
        _, A = _add_flux_balance_fields(mesh_xyz, Lq, phi, None, A)
        B = curl(A, dqj)
    if out_dtype is not None:
        A = A.astype(out_dtype)
        B = B.astype(out_dtype)
    return A, B
