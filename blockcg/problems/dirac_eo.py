"""Even-odd (red-black) Schur reduction of the lattice Dirac-like operator.

The nearest-neighbor operator A = c I - H couples only opposite parities
(reference R10 is an "even-odd-preconditioned Wilson"-shaped operator,
SURVEY.md §1). This module builds the half-lattice parity hops H_eo / H_oe
as ConstBlockDIAOperators — the structure (offsets + 0/1 masks per distinct
half-index offset) is DERIVED automatically from the coordinate maps, so
every const-hop path (the operator apply, distribution) applies
— and wires them into operators.schur.SchurEvenOperator:

    S_e x_e = b_e + H_eo b_o / c,   S_e = c I - H_eo H_oe / c   (half size)
    x_o     = (b_o + H_oe x_e) / c

Half-index convention: a site s = (t, z, y, x) of parity p has half-index
h = s // 2 within its parity class; the half lattice is an (L, L, L, L/2)
grid with strides (L^3/2, L^2/2, L/2, 1). Only x-hops depend on the row's
x-parity q = (t + z + y + p) % 2 — the derivation below just computes every
neighbor's half-index numerically and groups equal offsets into masked
diagonals, so no case analysis is hand-maintained.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from blockcg.operators.cbdia import ConstBlockDIAOperator
from blockcg.operators.schur import SchurEvenOperator
from blockcg.problems.dirac import BS, _NDIM, hopping_matrices

__all__ = ["dirac_eo", "dirac_gauged_eo", "dirac_gauged_matrix_eo",
           "eo_split", "eo_assemble",
           "solve_dirac_eo", "solve_dirac_eo_dist", "solve_dirac_eo_shifted",
           "EOContext"]


def _half_coords(L: int, parity: int):
    """Coordinates of the parity-class sites, indexed by half-index h."""
    ns2 = L**_NDIM // 2
    h = np.arange(ns2)
    l3h, l2h, lh = L**3 // 2, L**2 // 2, L // 2
    t = h // l3h
    z = (h // l2h) % L
    y = (h // lh) % L
    xh = h % lh
    q = (t + z + y + parity) % 2  # x-parity of the site
    x = 2 * xh + q
    return t, z, y, x


def _half_index(L: int, t, z, y, x):
    """Half-index of full-coordinate sites (whatever their parity)."""
    s = ((t * L + z) * L + y) * L + x
    return s // 2


def _parity_hop(L: int, H: np.ndarray, target_parity: int, bc: str,
                np_dtype, links: np.ndarray | None = None
                ) -> ConstBlockDIAOperator:
    """Half-lattice hop: Y[target-parity rows] = sum_mu (phi_mu H_mu X[.+mu]
    + phi'_mu H_mu^H X[.-mu]) over the opposite-parity half field.

    With ``links`` (per-axis per-full-site scalar link field, real), the
    masks carry LINK VALUES times the boundary gate — the gauged operator
    rides the same const-hop operator (see problems.dirac_gauged_cbdia).
    Without links, masks are 0/1 gates (translation-invariant case)."""
    ns2 = L**_NDIM // 2
    t, z, y, x = _half_coords(L, target_parity)
    coords = [t, z, y, x]
    s_full = ((t * L + z) * L + y) * L + x  # full site index per row h

    # (offset, block_key) -> accumulated value-mask (float) and gate
    diag_vals: dict = {}
    diag_blocks: dict = {}
    diag_gated: dict = {}  # True if any row gated off (mask required)

    def add(block: np.ndarray, hprime: np.ndarray, valid: np.ndarray,
            vals: np.ndarray | None):
        off_vec = (hprime - np.arange(ns2)) % ns2
        for off in np.unique(off_vec[valid]):
            mask = valid & (off_vec == off)
            soff = int(((off + ns2 // 2) % ns2) - ns2 // 2)  # near-zero rep
            key = (soff, block.tobytes())
            v = np.zeros(ns2)
            v[mask] = 1.0 if vals is None else vals[mask]
            if key in diag_vals:
                diag_vals[key] = diag_vals[key] + v
                diag_gated[key] |= not mask.all()
            else:
                diag_vals[key] = v
                diag_blocks[key] = block
                diag_gated[key] = not mask.all()

    cplx_links = links is not None and np.iscomplexobj(links)
    if cplx_links:
        # U(1) links: realified form phi*B = phi_r*K1(B) + phi_i*K2(B) —
        # two real value-masked diagonals per hop on doubled spin blocks
        # (canonical convention: operators/realify.py).
        from blockcg.operators.realify import k1k2_blocks, real_mask_dtype

        rdt_blocks = real_mask_dtype(np_dtype)

        def k1k2(B):
            return k1k2_blocks(B, rdt_blocks)

    for ax in range(_NDIM):
        for sgn, block in ((+1, H[ax]), (-1, H[ax].conj().T)):
            nc = [c.copy() for c in coords]
            nc[ax] = coords[ax] + sgn
            wrap = (nc[ax] < 0) | (nc[ax] >= L)
            nc[ax] = nc[ax] % L
            hprime = _half_index(L, *nc)
            valid = np.ones(ns2, bool) if bc == "periodic" else ~wrap
            if links is None:
                vals = None
            elif sgn > 0:
                vals = links[ax][s_full]  # link anchored at the row's site
            else:
                # -mu link is anchored at the NEIGHBOR site s - mu.
                nfull = ((nc[0] * L + nc[1]) * L + nc[2]) * L + nc[3]
                vals = np.conj(links[ax][nfull]) if cplx_links \
                    else links[ax][nfull]
            if cplx_links:
                K1, K2 = k1k2(block)
                add(np.ascontiguousarray(K1), hprime, valid, vals.real)
                add(np.ascontiguousarray(K2), hprime, valid, vals.imag)
            else:
                add(np.ascontiguousarray(block.astype(np_dtype)), hprime,
                    valid, vals)

    cplx = np.issubdtype(np_dtype, np.complexfloating)
    mask_dtype = (
        np_dtype if not cplx
        else np.float32 if np_dtype == np.complex64 else np.float64
    )
    # cplx_links (computed above): realified K1/K2 blocks are real scalars
    scal = float if cplx_links else (complex if cplx else float)
    gauged = links is not None

    offsets, hops, mask_slot, masks = [], [], [], []
    for key in sorted(diag_vals, key=lambda kv: kv[0]):
        soff, _ = key
        block = diag_blocks[key]
        vals = diag_vals[key]
        offsets.append(soff)
        hops.append(tuple(tuple(scal(v) for v in row) for row in block))
        if not gauged and not diag_gated[key]:
            mask_slot.append(-1)
        else:
            mask_slot.append(len(masks))
            masks.append(vals.astype(mask_dtype))

    op = ConstBlockDIAOperator(
        masks=jnp.asarray(np.stack(masks)) if masks else None,
        hops=tuple(hops),
        offsets=tuple(offsets),
        mask_slot=tuple(mask_slot),
        num_sites=ns2,
    )
    nnz = 0
    for d in range(len(offsets)):
        nz = int(np.count_nonzero(np.asarray(hops[d])))
        rows = ns2 if mask_slot[d] < 0 else int(
            np.count_nonzero(masks[mask_slot[d]])
        )
        nnz += nz * rows
    object.__setattr__(op, "_nnz", nnz)
    return op


@dataclasses.dataclass
class EOContext:
    """Schur operator + the site permutations to split/assemble full fields.

    ``cdtype`` is set for U(1)-gauged complex systems: the context then
    operates on the REALIFIED system (bs = 2 x complex spin blocks, fields
    are stacked re/im spin planes) and ``solve_dirac_eo`` converts complex
    right-hand sides at the boundary."""

    schur: SchurEvenOperator
    hop_eo: ConstBlockDIAOperator
    hop_oe: ConstBlockDIAOperator
    c: float
    even_sites: np.ndarray  # (ns/2,) full-lattice site index per half-index
    odd_sites: np.ndarray
    ns: int
    bs: int
    cdtype: object = None

    @property
    def n(self) -> int:
        return self.bs * self.ns

    def complex_to_real(self, B) -> jax.Array:
        """Complex (cbs*ns, k) -> realified (2*cbs*ns, k): re spins first."""
        cbs = self.bs // 2
        Bv = jnp.asarray(B).reshape(cbs, self.ns, -1)
        rdt = jnp.finfo(self.cdtype).dtype
        return jnp.concatenate([jnp.real(Bv), jnp.imag(Bv)], axis=0).reshape(
            self.n, -1).astype(rdt)

    def real_to_complex(self, X) -> jax.Array:
        cbs = self.bs // 2
        Xv = jnp.asarray(X).reshape(self.bs, self.ns, -1)
        return (Xv[:cbs] + 1j * Xv[cbs:]).reshape(
            cbs * self.ns, -1).astype(self.cdtype)


def dirac_eo(
    L: int, m: float = 0.5, bc: str = "periodic", dtype=jnp.float32,
    seed: int = 7,
) -> EOContext:
    """Even-odd Schur form of the dirac_cbdia/dirac_bdia matrix."""
    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    if L % 2:
        raise ValueError("even-odd reduction needs even L")
    if L < 4:
        # At L = 2 the +mu and -mu neighbors coincide; the diagonal grouping
        # below would merge the two (equal) hop contributions instead of
        # summing them — build the full operator instead.
        raise ValueError("even-odd reduction needs L >= 4")
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    c = float(m * m + 2.0 * _NDIM)
    # A couples row s to col s+mu with -H_mu: the hop operators carry +H_mu.
    hop_eo = _parity_hop(L, H, target_parity=0, bc=bc, np_dtype=np_dtype)
    hop_oe = _parity_hop(L, H, target_parity=1, bc=bc, np_dtype=np_dtype)
    schur = SchurEvenOperator(hop_eo=hop_eo, hop_oe=hop_oe, c=c)

    te, ze, ye, xe = _half_coords(L, 0)
    to, zo, yo, xo = _half_coords(L, 1)
    even_sites = ((te * L + ze) * L + ye) * L + xe
    odd_sites = ((to * L + zo) * L + yo) * L + xo
    return EOContext(
        schur=schur, hop_eo=hop_eo, hop_oe=hop_oe, c=c,
        even_sites=even_sites, odd_sites=odd_sites,
        ns=L**_NDIM, bs=BS,
    )


def dirac_gauged_eo(
    L: int, m: float = 0.5, bc: str = "periodic", dtype=jnp.float32,
    seed: int = 7, gauge_seed: int = 11,
) -> EOContext:
    """Even-odd Schur form of the GAUGED operator.

    Same half-lattice derivation as ``dirac_eo``; the parity hops carry
    link values in their masks, so the Schur solve runs the const-hop
    operator exactly like the ungauged case (matrix equality with
    ``dirac_gauged`` is unit-tested). Real dtypes carry Z2 links; complex
    dtypes U(1) phases via the realified K1/K2 form — the returned context
    then works on the realified system (``cdtype`` set, spin blocks
    doubled) and ``solve_dirac_eo`` handles complex RHS conversion."""
    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    if L % 2:
        raise ValueError("even-odd reduction needs even L")
    if L < 4:
        raise ValueError("even-odd reduction needs L >= 4")
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    grng = np.random.default_rng(gauge_seed)
    ns = L**_NDIM
    if cplx:
        links = np.exp(
            2j * np.pi * grng.random((_NDIM, ns))).astype(np_dtype)
    else:
        links = grng.choice([-1.0, 1.0], size=(_NDIM, ns)).astype(np_dtype)
    c = float(m * m + 2.0 * _NDIM)
    hop_eo = _parity_hop(L, H, 0, bc, np_dtype, links=links)
    hop_oe = _parity_hop(L, H, 1, bc, np_dtype, links=links)
    schur = SchurEvenOperator(hop_eo=hop_eo, hop_oe=hop_oe, c=c)

    te, ze, ye, xe = _half_coords(L, 0)
    to, zo, yo, xo = _half_coords(L, 1)
    even_sites = ((te * L + ze) * L + ye) * L + xe
    odd_sites = ((to * L + zo) * L + yo) * L + xo
    return EOContext(
        schur=schur, hop_eo=hop_eo, hop_oe=hop_oe, c=c,
        even_sites=even_sites, odd_sites=odd_sites,
        ns=ns, bs=2 * BS if cplx else BS,
        cdtype=(jnp.complex64 if np_dtype == np.complex64 else
                jnp.complex128) if cplx else None,
    )


def _parity_hop_matrix(L: int, H: np.ndarray, U: np.ndarray,
                       target_parity: int, bc: str, np_dtype):
    """Half-lattice hop with per-site MATRIX links — a BlockDIAOperator.

    The matrix-link (SU(N)-style) analog of ``_parity_hop``: link matrices
    cannot factor into (constant spin block) x (scalar mask), so the hops
    carry full per-site bs x bs blocks grouped by half-index offset. On the
    half lattice they ride the general block-stencil operator.

    Hop convention: A = c I - H_total, so the +mu hop block at row site s
    is +U_mu(s) H_mu and the -mu block is (U_mu(s-mu) H_mu)^H (the
    Hermitian pair anchored at the neighbor), matching
    problems.dirac.dirac_gauged_matrix's A-blocks up to the global sign."""
    ns2 = L**_NDIM // 2
    t, z, y, x = _half_coords(L, target_parity)
    coords = [t, z, y, x]
    s_full = ((t * L + z) * L + y) * L + x

    diag: dict = {}  # soff -> (BS, BS, ns2) accumulated per-site blocks
    for ax in range(_NDIM):
        for sgn in (+1, -1):
            nc = [c.copy() for c in coords]
            nc[ax] = coords[ax] + sgn
            wrap = (nc[ax] < 0) | (nc[ax] >= L)
            nc[ax] = nc[ax] % L
            hprime = _half_index(L, *nc)
            valid = np.ones(ns2, bool) if bc == "periodic" else ~wrap
            if sgn > 0:
                blk = np.einsum("sij,jk->sik", U[ax][s_full], H[ax])
            else:
                nfull = ((nc[0] * L + nc[1]) * L + nc[2]) * L + nc[3]
                blk = np.conj(
                    np.einsum("sij,jk->sik", U[ax][nfull], H[ax])
                ).transpose(0, 2, 1)
            off_vec = (hprime - np.arange(ns2)) % ns2
            for off in np.unique(off_vec[valid]):
                mask = valid & (off_vec == off)
                soff = int(((off + ns2 // 2) % ns2) - ns2 // 2)
                acc = diag.setdefault(
                    soff, np.zeros((BS, BS, ns2), np_dtype))
                acc[:, :, mask] += blk[mask].transpose(1, 2, 0)

    from blockcg.operators.bdia import BlockDIAOperator

    offsets = sorted(diag)
    blocks = np.stack([diag[o] for o in offsets])
    op = BlockDIAOperator(blocks=jnp.asarray(blocks), offsets=tuple(offsets))
    object.__setattr__(op, "_nnz", int(np.count_nonzero(blocks)))
    return op


def dirac_gauged_matrix_eo(
    L: int, m: float = 0.5, bc: str = "periodic", dtype=jnp.float32,
    seed: int = 7, gauge_seed: int = 11,
) -> EOContext:
    """Even-odd Schur form of the MATRIX-link (SU(N)-style) gauged operator.

    Matches ``problems.dirac_gauged_matrix(L, m, bc, dtype, seed,
    gauge_seed)`` exactly (same link-field RNG sequence). The parity hops
    are general BlockDIAOperators on the half lattice — the one gauged
    family whose hops cannot ride the const-hop operator — so the Schur
    solve runs the general block-stencil operator. Real dtypes carry
    orthogonal links; complex dtypes unitary links."""
    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    if L % 2:
        raise ValueError("even-odd reduction needs even L")
    if L < 4:
        raise ValueError("even-odd reduction needs L >= 4")
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    ns = L**_NDIM
    grng = np.random.default_rng(gauge_seed)
    g = grng.standard_normal((_NDIM, ns, BS, BS))
    if cplx:
        g = g + 1j * grng.standard_normal((_NDIM, ns, BS, BS))
    U, _ = np.linalg.qr(g)
    U = U.astype(np_dtype)

    c = float(m * m + 2.0 * _NDIM)
    hop_eo = _parity_hop_matrix(L, H, U, 0, bc, np_dtype)
    hop_oe = _parity_hop_matrix(L, H, U, 1, bc, np_dtype)
    schur = SchurEvenOperator(hop_eo=hop_eo, hop_oe=hop_oe, c=c)

    te, ze, ye, xe = _half_coords(L, 0)
    to, zo, yo, xo = _half_coords(L, 1)
    even_sites = ((te * L + ze) * L + ye) * L + xe
    odd_sites = ((to * L + zo) * L + yo) * L + xo
    return EOContext(
        schur=schur, hop_eo=hop_eo, hop_oe=hop_oe, c=c,
        even_sites=even_sites, odd_sites=odd_sites,
        ns=ns, bs=BS,
    )


def _q0(eo: EOContext) -> np.ndarray:
    """x-parity of the EVEN site in each consecutive site pair {2h, 2h+1}."""
    return (eo.even_sites % 2).astype(np.bool_)


def _split_pairs(Bv, q):
    """(bs, ns2, 2, k) pairs -> (even, odd) (bs, ns2, k) via masked select.

    Site 2h + q0(h) is even: no gather needed — a select streams the
    field once."""
    b0, b1 = Bv[..., 0, :], Bv[..., 1, :]
    qe = q[None, :, None]
    return jnp.where(qe, b1, b0), jnp.where(qe, b0, b1)


def _interleave_pairs(Ev, Ov, q):
    """Inverse of _split_pairs: (bs, ns2, k) halves -> (bs, ns2, 2, k)."""
    Ev = Ev[:, :, None, :]
    Ov = Ov[:, :, None, :]
    qe = q[None, :, None, None]
    slot0 = jnp.where(qe, Ov, Ev)
    slot1 = jnp.where(qe, Ev, Ov)
    return jnp.concatenate([slot0, slot1], axis=2)


def eo_split(eo: EOContext, B):
    """Full (n, k) field -> (even, odd) half fields, spin-major rows."""
    ns2 = eo.ns // 2
    B = jnp.asarray(B)
    k = B.shape[1]
    Bv = B.reshape(eo.bs, ns2, 2, k)  # leading-dim split: no relayout
    Be, Bo = _split_pairs(Bv, jnp.asarray(_q0(eo)))
    return Be.reshape(eo.bs * ns2, k), Bo.reshape(eo.bs * ns2, k)


def eo_assemble(eo: EOContext, Xe, Xo):
    """(even, odd) half fields -> full (n, k) field."""
    ns2 = eo.ns // 2
    Xe, Xo = jnp.asarray(Xe), jnp.asarray(Xo)
    k = Xe.shape[1]
    out = _interleave_pairs(
        Xe.reshape(eo.bs, ns2, k), Xo.reshape(eo.bs, ns2, k),
        jnp.asarray(_q0(eo)),
    )
    return out.reshape(eo.n, k)


_EO_PIPELINE_CACHE: dict = {}


def solve_dirac_eo(eo: EOContext, B, solver=None, *, tol: float = 1e-6,
                   max_iter: int = 1000, qr_passes: int = 1,
                   replace_every: int = 0, **kwargs):
    """Solve the FULL system A X = B through the half-size Schur system.

    The default (SBCGrQ) path runs split -> rhs -> Schur solve ->
    odd-reconstruction -> assemble as ONE jitted program (one dispatch
    instead of a chain of eager ones). Passing a custom
    ``solver(op, rhs, **kwargs) -> (X, info)`` uses the composable eager
    path instead. Returns (X (n, k), info) — info reports the Schur solve.
    Complex RHS on a U(1)-gauged context (``eo.cdtype``) are converted
    through the realified field codec."""
    from blockcg.solvers.sbcgrq import _sbcgrq_impl, solve_sbcgrq

    if eo.cdtype is not None and np.iscomplexobj(B):
        Xr, info = solve_dirac_eo(
            eo, eo.complex_to_real(B), solver, tol=tol, max_iter=max_iter,
            qr_passes=qr_passes, replace_every=replace_every, **kwargs,
        )
        return eo.real_to_complex(Xr), info

    if solver is not None or kwargs:
        if solver is None:
            solver = solve_sbcgrq
            kwargs = dict(kwargs, qr_passes=qr_passes,
                          replace_every=replace_every)
        be, bo = eo_split(eo, B)
        be_j = jnp.asarray(be)
        bo_j = jnp.asarray(bo)
        # rhs_e = b_e + H_eo b_o / c (hop takes lanes-major (k, n) blocks)
        rhs = be_j + eo.hop_eo.matmat_t(bo_j.T).T / eo.c
        Xe, info = solver(eo.schur, rhs, tol=tol, max_iter=max_iter, **kwargs)
        xo = (bo_j + eo.hop_oe.matmat_t(jnp.asarray(Xe).T).T) / eo.c
        return eo_assemble(eo, jnp.asarray(Xe), xo), info

    key = (
        jax.tree_util.tree_structure(eo.schur),
        max_iter, qr_passes, replace_every, eo.ns, eo.bs,
    )
    fn = _EO_PIPELINE_CACHE.get(key)
    if fn is None:
        import functools

        ns2 = eo.ns // 2
        bs = eo.bs

        @functools.partial(
            jax.jit,
            static_argnames=("max_iter", "qr_passes", "replace_every"),
        )
        def fn(schur, q, B, tol, max_iter, qr_passes, replace_every):
            c = jnp.asarray(schur.c, B.dtype)
            k = B.shape[1]
            Bv = B.reshape(bs, ns2, 2, k)
            Be, Bo = _split_pairs(Bv, q)
            be_t = Be.reshape(bs * ns2, k).T
            bo_t = Bo.reshape(bs * ns2, k).T
            rhs_t = schur.to_internal(be_t + schur.hop_eo.matmat_t(bo_t) / c)
            Xt, info = _sbcgrq_impl(
                schur, rhs_t, jnp.zeros_like(rhs_t), tol, max_iter,
                qr_passes, replace_every, None, False,
            )
            Xe_t = schur.from_internal(Xt)
            Xo_t = (bo_t + schur.hop_oe.matmat_t(Xe_t)) / c
            out = _interleave_pairs(
                Xe_t.T.reshape(bs, ns2, k), Xo_t.T.reshape(bs, ns2, k), q
            ).reshape(bs * eo.ns, k)
            return out, info

        _EO_PIPELINE_CACHE[key] = fn
    return fn(eo.schur, jnp.asarray(_q0(eo)), jnp.asarray(B), tol,
              max_iter, qr_passes, replace_every)


# Partition plans are rebuilt only when the (context, D) pair changes —
# host-side mask splitting + device uploads per call would dominate repeat
# solves (same rationale as parallel.api._SHARD_FN_CACHE). Keyed by id()
# with a weakref finalizer (EOContext dataclasses aren't hashable).
_EO_PARTITION_CACHE: dict = {}


def solve_dirac_eo_dist(eo: EOContext, B, mesh, D: int | None = None, *,
                        tol: float = 1e-6, max_iter: int = 1000,
                        qr_passes: int = 1, replace_every: int = 0,
                        record_history: bool = False, dschur=None):
    """Distributed even-odd solve: the half-size Schur system runs
    row-sharded over ``mesh`` (parallel.solve_sbcgrq_dist); the cheap
    boundary steps (split, rhs transform, odd reconstruction, assemble)
    stay single-device. Complex (U(1)) contexts convert at the host
    boundary like ``solve_dirac_eo``. Pass a prebuilt ``dschur``
    (parallel.partition_dirac_eo) to control partitioning; otherwise the
    plan is built once per (context, D) and cached. Returns
    (X (n, k), info)."""
    from blockcg.parallel import partition_dirac_eo, solve_sbcgrq_dist

    if eo.cdtype is not None and np.iscomplexobj(B):
        Xr, info = solve_dirac_eo_dist(
            eo, eo.complex_to_real(B), mesh, D, tol=tol, max_iter=max_iter,
            qr_passes=qr_passes, replace_every=replace_every,
            record_history=record_history, dschur=dschur,
        )
        return eo.real_to_complex(Xr), info

    D = D if D is not None else mesh.devices.size
    if dschur is None:
        import weakref

        key = (id(eo), D)
        dschur = _EO_PARTITION_CACHE.get(key)
        if dschur is None:
            dschur = partition_dirac_eo(eo, D)
            try:
                weakref.finalize(eo, _EO_PARTITION_CACHE.pop, key, None)
                _EO_PARTITION_CACHE[key] = dschur
            except TypeError:  # non-weakrefable: skip caching
                pass
    be, bo = eo_split(eo, B)
    be_j, bo_j = jnp.asarray(be), jnp.asarray(bo)
    rhs = be_j + eo.hop_eo.matmat_t(bo_j.T).T / eo.c
    Xe, info = solve_sbcgrq_dist(
        dschur, rhs, mesh, tol=tol, max_iter=max_iter, qr_passes=qr_passes,
        replace_every=replace_every, record_history=record_history,
    )
    Xe_j = jnp.asarray(Xe)
    xo = (bo_j + eo.hop_oe.matmat_t(Xe_j.T).T) / eo.c
    return eo_assemble(eo, Xe_j, xo), info


def solve_dirac_eo_shifted(eo: EOContext, B, sigmas, *, tol: float = 1e-6,
                           max_iter: int = 1000, qr_passes: int = 1):
    """Multi-shift solve of the FULL systems ``(A + sigma_j) X_j = B``
    through ONE even-odd-reduced block-Krylov space (the RHMC pattern:
    rational-approximation solves with even-odd preconditioning).

    Derivation: with f_j = c + sigma_j and K = H_eo H_oe, the even-site
    Schur systems are (f_j^2 - K) x_e = f_j b_e + H_eo b_o. Every shift
    shares K, so with base mu0 = (c + min sigma)^2 all systems are
    non-negative shifts (f_j^2 - mu0) of the SPD ``EONormalOperator``
    mu0 - K. The sigma-dependent RHS splits by linearity into a fixed
    2k-column block [b_e | H_eo b_o]: one multi-shift block solve yields
    Y1(sigma), Y2(sigma) and x_e = f Y1 + Y2; odd sites reconstruct as
    x_o = (b_o + H_oe x_e) / f. Costs one SpMM of K (= both parity hops)
    per iteration TOTAL across all shifts, at the even-odd-preconditioned
    iteration count."""
    from blockcg.operators.schur import EONormalOperator
    from blockcg.solvers.shifted_block import solve_shifted_sbcgrq

    if eo.cdtype is not None and np.iscomplexobj(B):
        Xr, info = solve_dirac_eo_shifted(
            eo, eo.complex_to_real(B), sigmas, tol=tol, max_iter=max_iter,
            qr_passes=qr_passes,
        )
        return np.stack(
            [np.asarray(eo.real_to_complex(Xr[j]))
             for j in range(Xr.shape[0])]
        ), info

    sig = np.atleast_1d(np.asarray(sigmas, dtype=np.float64))
    if (sig < 0).any():
        raise ValueError("shifts must be non-negative")
    f = eo.c + sig
    mu0 = float(f.min()) ** 2
    kop = EONormalOperator(hop_eo=eo.hop_eo, hop_oe=eo.hop_oe, mu=mu0)

    be, bo = eo_split(eo, B)
    be_j, bo_j = jnp.asarray(be), jnp.asarray(bo)
    k = be_j.shape[1]
    heo_bo = eo.hop_eo.matmat_t(bo_j.T).T
    B2 = jnp.concatenate([be_j, heo_bo], axis=1)  # (n_e, 2k)

    mus = [float(fj * fj - mu0) for fj in f]
    Ys, info = solve_shifted_sbcgrq(
        kop, B2, mus, tol=tol, max_iter=max_iter, qr_passes=qr_passes,
    )
    outs = []
    for j, fj in enumerate(f):
        Yj = jnp.asarray(Ys[j])
        xe = jnp.asarray(fj, Yj.dtype) * Yj[:, :k] + Yj[:, k:]
        xo = (bo_j + eo.hop_oe.matmat_t(xe.T).T) / jnp.asarray(fj, Yj.dtype)
        outs.append(np.asarray(jax.device_get(eo_assemble(eo, xe, xo))))
    return np.stack(outs), info
