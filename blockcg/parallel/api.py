"""Distributed solver entry points (T-D2 + L4 surface, SURVEY.md §4.3).

The same jitted solver bodies (solvers/) run SPMD inside ``shard_map`` over a
1-D row mesh: the operator pytree is row-sharded, the RHS block lanes-major
row-sharded, and every reduction goes through the solvers' ``axis_name``
psum hook. Works identically on a multi-card mesh and on the fake CPU mesh
(``--xla_force_host_platform_device_count``, SURVEY.md §5.2 item 3).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from blockcg.types import SolverInfo
from blockcg.solvers.cg import _cg_impl
from blockcg.solvers.bcg import _bcg_impl
from blockcg.solvers.sbcgrq import _sbcgrq_impl
from blockcg.solvers.shifted_block import _shifted_sbcgrq_impl

shard_map = jax.shard_map


def row_mesh(num_devices: int | None = None, axis_name: str = "rows") -> Mesh:
    """1-D mesh over all (or the first N) devices (T-D2)."""
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return jax.make_mesh((len(devs),), (axis_name,), devices=devs)


def _info_specs(record_history: bool, per_rhs: bool = False,
                breakdown: bool = False):
    return SolverInfo(
        iterations=P(),
        relres=P(),
        converged=P(),
        matvecs=P(),
        history=P() if record_history else None,
        per_rhs_iters=P() if per_rhs else None,
        breakdown=P() if breakdown else None,
    )


def _field_pspec(dop, axis):
    fp = getattr(dop, "field_pspec", None)
    return fp() if fp is not None else P(None, axis)


def _put_field(dop, B, mesh, axis):
    """Global (n, k) RHS -> lanes-major internal field, sharded on sites.

    Operators partitioned with shard padding (non-dividing device counts;
    dist_ops._pad_validity) get their field's site axis zero-padded to the
    padded extent — the pad rows are inert (identity diag, zero RHS) and
    are truncated back off in _field_result."""
    Bt = B.T
    to_int = getattr(dop, "to_internal", None)
    if to_int is not None:
        Bt = to_int(Bt)
    pad = getattr(dop, "pad_sites", 0)
    if pad:
        widths = [(0, 0)] * (Bt.ndim - 1) + [(0, pad)]
        Bt = jnp.pad(Bt, widths)
    return jax.device_put(Bt, NamedSharding(mesh, _field_pspec(dop, axis)))


# shard_map closures are rebuilt per call; without caching every solve call
# would retrace and recompile, which can cost far more than the solve
# itself. Key on everything the closure bakes in: mesh, operator structure,
# solver statics and tol.
_SHARD_FN_CACHE: dict = {}


def _cached_jit(key, make):
    fn = _SHARD_FN_CACHE.get(key)
    if fn is None:
        fn = _SHARD_FN_CACHE[key] = jax.jit(make())
    return fn


def _dop_key(dop, mesh):
    return (
        mesh,
        jax.tree_util.tree_structure(dop),
        str(_field_pspec(dop, dop.axis_name)),
    )


def _sbcgrq_dist_fn(dop, mesh, tol, max_iter, qr_passes, replace_every,
                    record_history, replace_kappa, active_floor=0):
    """Cached shard_map-jitted SBCGrQ over INTERNAL sharded fields — the
    building block shared by the public entry point, the distributed
    refinement driver (which feeds sharded residuals straight back in,
    skipping the host-side field codecs between cycles), and the deflation
    driver (warm starts + active_floor stage exits). Call as
    ``fn(dop, Bt, X0t)``."""
    axis = dop.axis_name

    def body(op, bt, x0t, cap):
        return _sbcgrq_impl(
            op, bt, x0t, tol, max_iter,
            qr_passes=qr_passes, replace_every=replace_every,
            axis_name=axis, record_history=record_history,
            active_floor=active_floor, replace_kappa=replace_kappa,
            iter_cap=cap,
        )

    key = ("sbcgrq", _dop_key(dop, mesh), _tol_key(tol), max_iter, qr_passes,
           replace_every, record_history, replace_kappa, active_floor)
    fspec = _field_pspec(dop, axis)
    return _cached_jit(key, lambda: shard_map(
        body,
        mesh=mesh,
        in_specs=(dop.in_specs(), fspec, fspec, P()),
        out_specs=(fspec, _info_specs(record_history, per_rhs=True,
                                      breakdown=True)),
        check_vma=True,
    ))


def solve_sbcgrq_dist(
    dop,
    B: jax.Array,
    mesh: Mesh,
    X0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 1,
    replace_every: int = 0,
    record_history: bool = False,
    replace_kappa: float = 0.0,
    active_floor: int = 0,
    iter_cap=None,
) -> tuple[jax.Array, SolverInfo]:
    """Row-sharded SBCGrQ. ``dop`` is a Dist*Operator from parallel.dist_ops;
    ``B`` is (n, k) in the operator's distributed row ordering. Defaults
    mirror solve_sbcgrq: adaptive 1-pass QR; replacement opt-in; per-RHS
    (k,) vector ``tol`` accepted; ``active_floor`` is the deflation stage-
    exit rule; ``iter_cap`` is a TRACED budget <= max_iter (no recompile
    when it changes). The kappa/adaptive predicates are computed from
    post-psum k x k Grams, so every device takes the same lax.cond
    branch."""
    axis = dop.axis_name
    Bt = _put_field(dop, B, mesh, axis)
    X0t = (jnp.zeros_like(Bt) if X0 is None
           else _put_field(dop, X0, mesh, axis))
    fn = _sbcgrq_dist_fn(dop, mesh, tol, max_iter, qr_passes,
                         replace_every, record_history, float(replace_kappa),
                         int(active_floor))
    cap = jnp.int32(max_iter if iter_cap is None else iter_cap)
    Xt, info = fn(dop, Bt, X0t, cap)
    return _field_result(dop, mesh, Xt), info


def solve_sbcgrq_deflated_dist(
    dop,
    B: jax.Array,
    mesh: Mesh,
    X0: jax.Array | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 1,
    replace_every: int = 0,
    min_width: int = 8,
    width_quantum: int = 8,
    restart_overhead_s: float | None = None,
) -> tuple[jax.Array, SolverInfo]:
    """Row-sharded SBCGrQ with converged-column deflation (T-C4): the
    width-halving restart loop of solvers/deflate.py with each stage a
    fully distributed solve. Column subsetting happens on the (n, k)
    API-boundary arrays; each width compiles once per (dop, mesh)."""
    from blockcg.solvers.deflate import _deflated_driver

    def stage(Bs, X0s, budget, floor, tol_s):
        # max_iter stays FIXED (it is a static jit-cache key); the
        # shrinking per-stage budget rides the traced iter_cap, so each
        # width compiles once and later stages and re-solves hit the cache.
        X, info = solve_sbcgrq_dist(
            dop, Bs, mesh, X0s, tol=tol_s, max_iter=max_iter,
            iter_cap=budget, qr_passes=qr_passes,
            replace_every=replace_every, active_floor=floor,
        )
        # Replicate on-device at the stage boundary: the driver's column
        # scatter mixes this with its replicated accumulator
        # (ShardingTypeError inside .at[].set otherwise); a host
        # round-trip would break on multi-process meshes (non-addressable
        # shards).
        X = jax.device_put(X, NamedSharding(mesh, P(None, None)))
        return X, info

    return _deflated_driver(stage, jnp.asarray(B), X0, tol=tol,
                            max_iter=max_iter, min_width=min_width,
                            width_quantum=width_quantum,
                            restart_overhead_s=restart_overhead_s)


def _tol_key(tol):
    """Hashable jit-cache key for a scalar-or-(k,)-vector tolerance —
    solve_sbcgrq accepts both (deflation stages use vector tols), so the
    distributed mirror must too."""
    if np.ndim(tol) == 0:
        return float(tol)
    return tuple(np.asarray(tol, np.float64).ravel().tolist())


def solve_sbcgrq_cheb_dist(
    dop,
    B: jax.Array,
    mesh: Mesh,
    *,
    spectrum: tuple,
    degree: int = 4,
    tol: float = 1e-6,
    max_iter: int = 1000,
    max_cycles: int = 3,
    qr_passes: int = 1,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Row-sharded Chebyshev-preconditioned SBCGrQ — the communication-
    avoiding option in the regime it exists for (solvers/poly.py): each
    iteration of the preconditioned system (M A) with M = p_degree(A) does
    ``degree`` halo exchanges back-to-back but only ONE pair of k x k
    psum rounds and one QR, so latency-bound distributed solves trade
    d-fold fewer collective/latency rounds for extra (cheap, overlappable)
    SpMM bandwidth. ``spectrum=(lo, hi)`` is required: estimate it on a
    representative single-device operator (operators/cheb.py
    estimate_spectrum) or from problem analysis. Each outer cycle is ONE
    sharded program certifying the TRUE residual."""
    from blockcg.operators.cheb import ChebyshevOperator

    if max_cycles < 1:
        raise ValueError("max_cycles must be >= 1")
    axis = dop.axis_name
    rdt = jnp.real(jnp.zeros((), dop.dtype)).dtype
    lo = jnp.asarray(spectrum[0], rdt)
    hi = jnp.asarray(spectrum[1], rdt)

    def cycle(op, Bt, Xt, bnorm, lo, hi):
        pop = ChebyshevOperator(base=op, lo=lo, hi=hi, degree=degree)
        Rt = Bt - op.matmat_t(Xt)
        MRt = pop.apply_m_t(Rt)
        Dt, info = _sbcgrq_impl(
            pop, MRt, jnp.zeros_like(MRt), tol, max_iter, qr_passes, 0,
            axis, record_history,
        )
        Xt = Xt + Dt
        from blockcg.solvers.common import row_norms2_t

        relres = jnp.sqrt(
            row_norms2_t(Bt - op.matmat_t(Xt), axis, codec=op)) / bnorm
        return Xt, relres, info

    fspec = _field_pspec(dop, axis)
    key = ("cheb", _dop_key(dop, mesh), _tol_key(tol), max_iter, degree,
           qr_passes, record_history)
    fn = _cached_jit(key, lambda: shard_map(
        cycle,
        mesh=mesh,
        in_specs=(dop.in_specs(), fspec, fspec, P(), P(), P()),
        out_specs=(fspec, P(), _info_specs(record_history, per_rhs=True,
                                           breakdown=True)),
        check_vma=True,
    ))

    Bt = _put_field(dop, B, mesh, axis)
    Xt = jnp.zeros_like(Bt)
    # Column norms are row-order invariant: compute host-side once.
    bnorm = np.linalg.norm(np.asarray(B, np.float64), axis=0)
    bnorm = jnp.asarray(np.where(bnorm > 0, bnorm, 1.0), rdt)
    iters = 0
    matvecs = 0
    relres = None
    hists: list = []
    per_rhs = 0
    broke = False
    tol_arr = np.asarray(tol, np.float64)  # scalar OR (k,) per-column tol
    for _ in range(max_cycles):
        Xt, relres, info = fn(dop, Bt, Xt, bnorm, lo, hi)
        iters += int(info.iterations)
        matvecs += 2 + (degree - 1) + int(info.matvecs) * degree
        per_rhs = per_rhs + np.asarray(info.per_rhs_iters, np.int32)
        broke = broke or bool(info.breakdown)
        if info.history is not None:
            hists.append(info.history)
        if bool((np.asarray(relres) <= tol_arr).all()):
            break
    info = SolverInfo(
        iterations=jnp.int32(iters),
        relres=relres,
        converged=relres <= jnp.asarray(tol_arr, relres.dtype),
        matvecs=jnp.int32(matvecs),
        history=jnp.concatenate(hists) if hists else None,
        per_rhs_iters=jnp.asarray(per_rhs, jnp.int32),
        breakdown=jnp.asarray(broke),
    )
    return _field_result(dop, mesh, Xt), info


def _refine_cycle_dist_fn(dop64, mesh, compute_dtype):
    """Cached shard_map-jitted outer-refinement cycle (T-C5 distributed):
    apply the scaled correction, recompute the true residual with the f64
    operator (one distributed SpMM: halo exchange + boundary corrections),
    reduce per-RHS norms via psum, rescale, and cast the next inner RHS —
    ONE dispatch per cycle, all field traffic stays sharded on the mesh."""
    from blockcg.solvers.common import f_mm_update, row_norms2_t

    axis = dop64.axis_name

    def body(op64, Xt, Dt, scale, Bt64, bnorm):
        sc_m = jnp.diag(scale).astype(Xt.dtype)
        Xt = Xt + f_mm_update(sc_m, Dt.astype(Xt.dtype), codec=op64)
        Rt = Bt64 - op64.matmat_t(Xt)
        nrm = jnp.sqrt(row_norms2_t(Rt, axis, codec=op64))
        relres = nrm / bnorm
        sc = jnp.where(nrm > 0, nrm, jnp.ones_like(nrm))
        inv_m = jnp.diag(1.0 / sc).astype(Rt.dtype)
        Rn = f_mm_update(inv_m, Rt, codec=op64).astype(compute_dtype)
        return Xt, Rn, sc, relres

    fspec = _field_pspec(dop64, axis)
    key = ("refine_cycle", _dop_key(dop64, mesh), str(jnp.dtype(compute_dtype)))
    return _cached_jit(key, lambda: shard_map(
        body,
        mesh=mesh,
        in_specs=(dop64.in_specs(), fspec, fspec, P(), fspec, P()),
        out_specs=(fspec, fspec, P(), P()),
        check_vma=True,
    ))


def solve_refined_dist(
    dop,
    B: jax.Array,
    mesh: Mesh,
    *,
    tol: float = 1e-10,
    inner_tol: float = 1e-5,
    max_cycles: int = 8,
    inner_max_iter: int = 2000,
    qr_passes: int = 1,
    replace_every: int = 0,
    dop64=None,
    verbose: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Row-sharded mixed-precision refinement to below-f32 tolerances.

    The north-star composition (BASELINE.json: "<=1e-10 ... row-partitioned"):
    f32 SBCGrQ inner solves run fully distributed (halo ppermute + k x k
    psums), and the f64 outer true-residual cycle is ONE compiled sharded
    program per cycle (one distributed SpMM + psum'd column norms) — the
    n-sized data never leaves the mesh between cycles; only the k-sized
    relres vector is fetched to drive the stop rule.

    Mirrors solvers/refine.py:solve_refined (same per-RHS residual scaling
    so the f32 inner solver sees O(1) columns). ``dop64`` overrides the f64
    outer operator; default promotes ``dop`` (exact when the matrix data is
    f32-representable — see solve_refined's op64 note).
    """
    from blockcg.operators.base import astype as op_astype

    axis = dop.axis_name
    compute_dtype = dop.dtype
    cplx = jnp.issubdtype(jnp.dtype(B.dtype), jnp.complexfloating)
    f64 = jnp.complex128 if cplx else jnp.float64
    inner_fn = _sbcgrq_dist_fn(dop, mesh, float(inner_tol), inner_max_iter,
                               qr_passes, replace_every, False, 0.0)

    with jax.enable_x64(True):
        if dop64 is None:
            dop64 = op_astype(dop, f64)
        Bt64 = _put_field(dop64, B.astype(f64), mesh, axis)
        cycle = _refine_cycle_dist_fn(dop64, mesh, jnp.dtype(compute_dtype))
        rdt = jnp.float64
        k = B.shape[1]
        Xt = jnp.zeros_like(Bt64)
        zeros_d = jnp.zeros(Bt64.shape, compute_dtype)
        ones = jnp.ones((k,), rdt)
        # Cycle 0 (X = 0, D = 0, bnorm = 1): sc comes back as the per-RHS
        # ||B|| column norms — the normalization for every later cycle.
        # ``scale`` always carries the scaling that produced the Rt_in the
        # NEXT inner solve consumes (its correction is un-scaled by it).
        Xt, Rt_in, scale, nrm0 = cycle(dop64, Xt, zeros_d, ones, Bt64, ones)
        bnorm = scale
        # Cycle-0 convergence check (all-zero RHS columns; or a future warm
        # start): the cycle's relres output carries the RAW ||B - A X0||
        # column norms (its bnorm input was 1) — relative to ||B|| that is
        # 1 for every nonzero column, 0 for zero columns.
        relres = jnp.where(nrm0 > 0, 1.0, 0.0)

    matvecs = 1
    cycles = 0
    if float(np.max(np.asarray(relres))) <= tol:
        max_cycles = 0  # already converged: skip the inner solves entirely
    for cycles in range(1, max_cycles + 1):
        Dt, inner_info = inner_fn(dop, Rt_in, jnp.zeros_like(Rt_in),
                                  jnp.int32(inner_max_iter))
        matvecs += int(inner_info.matvecs)
        with jax.enable_x64(True):
            Xt, Rt_in, scale, relres = cycle(
                dop64, Xt, Dt, scale, Bt64, bnorm
            )
        matvecs += 1
        # The only per-cycle host fetch: the (k,)-sized relres vector. Use
        # numpy for the max so the f64 values aren't truncated when the
        # caller runs without global x64.
        worst = float(np.max(np.asarray(relres)))
        if verbose:
            print(f"[refine-dist] cycle {cycles}: max relres = {worst:.3e}")
        if worst <= tol:
            break

    with jax.enable_x64(True):
        info = SolverInfo(
            iterations=jnp.int32(cycles),
            relres=relres,
            converged=relres <= tol,
            matvecs=jnp.int32(matvecs),
        )
        return _field_result(dop64, mesh, Xt), info


def _field_result(dop, mesh, Xt):
    """Return X as (n, k). Internal block layouts (3D spin view, or the
    merged spin-major (m, ns) of the const-hop path) need their spin rows
    merged back into flat rows — not expressible as a sharded reshape, so
    single-process runs gather once at the API boundary. Multi-process
    runs cannot gather; the result comes back in DISTRIBUTED row
    order (shard-major, then the operator's local row order — convert with
    parallel.from_dist_order / the operator's host codec)."""
    import numpy as np

    conv = getattr(dop, "result_from_internal_np", None)
    # Shard-padding sites (non-dividing device counts) are truncated after
    # the single-process gather below — slicing the still-sharded array
    # would need a cross-shard gather (ShardingTypeError). Pod runs return
    # distributed order, pads included (documented).
    pad = getattr(dop, "pad_sites", 0)
    if Xt.ndim == 2 and conv is None:
        if pad and jax.process_count() == 1:
            return jnp.asarray(np.asarray(jax.device_get(Xt))[:, :-pad]).T
        return Xt.T
    if jax.process_count() > 1:
        axis = dop.axis_name
        key = ("flatten", _dop_key(dop, mesh))
        if conv is None:
            local = lambda x: x.reshape(x.shape[0], -1)
        else:
            local = dop.from_internal  # shard-local merge (reshape+swap)
        fn = _cached_jit(key, lambda: shard_map(
            local,
            mesh=mesh,
            in_specs=(_field_pspec(dop, axis),),
            out_specs=P(None, axis),
            check_vma=True,
        ))
        return fn(Xt).T
    Xn = np.asarray(jax.device_get(Xt))
    if pad:
        Xn = Xn[..., :-pad]
    if conv is not None:
        return jnp.asarray(conv(Xn)).T
    return jnp.asarray(Xn.reshape(Xn.shape[0], -1)).T


def solve_bcg_dist(
    dop,
    B: jax.Array,
    mesh: Mesh,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    axis = dop.axis_name
    Bt = _put_field(dop, B, mesh, axis)

    def body(op, bt):
        x0 = jnp.zeros_like(bt)
        return _bcg_impl(
            op, bt, x0, tol, max_iter, axis_name=axis,
            record_history=record_history,
        )

    key = ("bcg", _dop_key(dop, mesh), float(tol), max_iter, record_history)
    fn = _cached_jit(key, lambda: shard_map(
        body,
        mesh=mesh,
        in_specs=(dop.in_specs(), _field_pspec(dop, axis)),
        out_specs=(_field_pspec(dop, axis), _info_specs(record_history)),
        check_vma=True,
    ))
    Xt, info = fn(dop, Bt)
    return _field_result(dop, mesh, Xt), info


def solve_shifted_sbcgrq_dist(
    dop,
    B: jax.Array,
    sigmas,
    mesh: Mesh,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 2,
) -> tuple[jax.Array, SolverInfo]:
    """Row-sharded multi-shift block solve: (A + sigma_j I) X_j = B for all
    shifts with one distributed Krylov space (one halo exchange + the usual
    k x k psums per iteration, shared across every shift)."""
    axis = dop.axis_name
    sig = jnp.asarray(sigmas)
    Bt = _put_field(dop, B, mesh, axis)

    def body(op, bt, sg):
        return _shifted_sbcgrq_impl(
            op, bt, sg, tol, max_iter, qr_passes, axis
        )

    key = ("shifted_sbcgrq", _dop_key(dop, mesh), float(tol), max_iter,
           qr_passes, int(sig.shape[0]))
    fspec = _field_pspec(dop, axis)
    xs_spec = P(*((None,) + tuple(fspec)))  # leading shift axis replicatedly
    fn = _cached_jit(key, lambda: shard_map(
        body,
        mesh=mesh,
        in_specs=(dop.in_specs(), fspec, P()),
        out_specs=(xs_spec, _info_specs(False)),
        check_vma=True,
    ))
    Xs, info = fn(dop, Bt, sig)
    outs = [_field_result(dop, mesh, Xs[j]) for j in range(int(sig.shape[0]))]
    if jax.process_count() > 1:
        # Pod runs cannot gather: per-shift results stay distributed
        # (shard-major row order, see _field_result) — stack on device.
        return jnp.stack([jnp.asarray(o) for o in outs]), info
    return jnp.asarray(np.stack([np.asarray(o) for o in outs])), info


def solve_cg_dist(
    dop,
    b: jax.Array,
    mesh: Mesh,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    axis = dop.axis_name
    if (str(_field_pspec(dop, axis)) != str(P(None, axis))
            or getattr(dop, "result_from_internal_np", None) is not None):
        raise TypeError(
            "solve_cg_dist supports flat row-sharded operators only; block "
            "operators (spin field views) go through solve_bcg_dist/"
            "solve_sbcgrq_dist"
        )
    bl = jax.device_put(b, NamedSharding(mesh, P(axis)))

    def body(op, bv):
        bf = bv[None, :]  # lanes-major single-row field (_cg_impl convention)
        xf, info = _cg_impl(
            op, bf, jnp.zeros_like(bf), tol, max_iter, axis_name=axis,
            record_history=record_history,
        )
        return xf[0], info

    key = ("cg", _dop_key(dop, mesh), float(tol), max_iter, record_history)
    fn = _cached_jit(key, lambda: shard_map(
        body,
        mesh=mesh,
        in_specs=(dop.in_specs(), P(axis)),
        out_specs=(P(axis), _info_specs(record_history)),
        check_vma=True,
    ))
    return fn(dop, bl)


def solve_psbcgrq_dist(
    dop,
    B: jax.Array,
    M,
    mesh: Mesh,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 2,
    record_history: bool = False,
) -> tuple[jax.Array, SolverInfo]:
    """Row-sharded preconditioned SBCGrQ. ``M`` is a JacobiPreconditioner
    (its ``dinv_int`` rides sharded on the site axis) or any pytree
    operator applying shard-locally on the internal field view."""
    from blockcg.solvers.pbcg import JacobiPreconditioner, _psbcgrq_impl

    axis = dop.axis_name
    Bt = _put_field(dop, B, mesh, axis)

    def body(op, m_, bt):
        x0 = jnp.zeros_like(bt)
        return _psbcgrq_impl(
            op, m_, bt, x0, tol, max_iter, qr_passes, axis, record_history,
        )

    if isinstance(M, JacobiPreconditioner):
        m_specs = JacobiPreconditioner(
            dinv_int=P(None, axis) if M.dinv_int.ndim == 2 else P(axis)
        )
    else:
        m_specs = M.in_specs()
    key = ("psbcgrq", _dop_key(dop, mesh), float(tol), max_iter, qr_passes,
           record_history, jax.tree_util.tree_structure(M))
    fn = _cached_jit(key, lambda: shard_map(
        body,
        mesh=mesh,
        in_specs=(dop.in_specs(), m_specs, _field_pspec(dop, axis)),
        out_specs=(_field_pspec(dop, axis), _info_specs(record_history)),
        check_vma=True,
    ))
    Xt, info = fn(dop, M, Bt)
    return _field_result(dop, mesh, Xt), info
