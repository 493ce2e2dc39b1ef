"""Lattice-Dirac-like SPD block operator (T-P1, north-star config 4).

A 4x4-blocked SPD operator on a 4D lattice L^4 with nearest-neighbor
hopping — the sparsity/block structure of an even-odd-preconditioned Wilson
``D^H D + m^2`` lattice operator (SURVEY.md §1, R10):

    A[x, x]      = (m^2 + 8) * I_4
    A[x, x+mu]   = -H_mu          (mu = 0..3)
    A[x, x-mu]   = -H_mu^T

with fixed deterministic symmetric 4x4 hopping matrices ``H_mu`` of unit
spectral norm, so A is symmetric and block-Gershgorin SPD with
``lambda_min >= m^2``. Boundary conditions: ``periodic`` (lattice-QCD
standard; wraps become extra masked block diagonals) or ``open``.

Two container formats:
  - ``dirac_bdia``: BlockDIAOperator, spin-major rows — the block-stencil
    path (``dirac_cbdia`` is the same matrix with compile-time hops).
  - ``dirac_bell``: BSROperator in block-ELL layout, site-major rows — the
    generic BSR-format path.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from blockcg.operators import BSROperator
from blockcg.operators.bdia import BlockDIAOperator

BS = 4  # spin-block size
_NDIM = 4


def hopping_matrices(seed: int = 7, hermitian: bool = False) -> np.ndarray:
    """Four fixed 4x4 hopping matrices with unit spectral norm, (4, 4, 4).

    ``hermitian=False``: real symmetric (the default real SPD operator).
    ``hermitian=True``: complex Hermitian — the complex (lattice-QCD-like)
    flavor; the operator built from them is Hermitian positive-definite."""
    rng = np.random.default_rng(seed)
    hs = []
    for _ in range(_NDIM):
        if hermitian:
            g = rng.standard_normal((BS, BS)) + 1j * rng.standard_normal((BS, BS))
            h = 0.5 * (g + g.conj().T)
        else:
            g = rng.standard_normal((BS, BS))
            h = 0.5 * (g + g.T)
        h = h / np.abs(np.linalg.eigvalsh(h)).max()
        hs.append(h)
    return np.stack(hs)


def _coords(ns: int, L: int) -> tuple[list[np.ndarray], list[int]]:
    idx = np.arange(ns)
    strides = [L ** (_NDIM - 1 - ax) for ax in range(_NDIM)]
    return [(idx // strides[ax]) % L for ax in range(_NDIM)], strides


def dirac_bdia(
    L: int, m: float = 0.5, bc: str = "periodic", dtype=jnp.float32, seed: int = 7
) -> BlockDIAOperator:
    """Build the operator as a BlockDIAOperator (spin-major rows)."""
    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    ns = L**_NDIM
    coords, strides = _coords(ns, L)

    offsets: list[int] = [0]
    blocks: list[np.ndarray] = []
    diag = np.zeros((BS, BS, ns), dtype=np_dtype)
    diag[:, :, :] = ((m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype))[:, :, None]
    blocks.append(diag)

    def masked(block: np.ndarray, mask: np.ndarray) -> np.ndarray:
        out = np.zeros((BS, BS, ns), dtype=np_dtype)
        out[:, :, mask] = block[:, :, None]
        return out

    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        if bc == "periodic" and ax == 0:
            # Slowest axis: flat-index wraparound IS the lattice wraparound
            # ((s +/- L^3) mod ns), and BlockDIA semantics are toroidal —
            # one unmasked diagonal per direction covers hop + wrap.
            offsets.append(st)
            blocks.append(masked(-H[ax], np.ones(ns, bool)))
            offsets.append(-st)
            blocks.append(masked(-H[ax].conj().T, np.ones(ns, bool)))
            continue
        # +mu hop (interior rows)
        offsets.append(st)
        blocks.append(masked(-H[ax], c < L - 1))
        # -mu hop
        offsets.append(-st)
        blocks.append(masked(-H[ax].conj().T, c > 0))
        if bc == "periodic":
            # +mu wrap: rows with c == L-1 couple to site s - (L-1)*st
            offsets.append(-(L - 1) * st)
            blocks.append(masked(-H[ax], c == L - 1))
            # -mu wrap: rows with c == 0 couple to site s + (L-1)*st
            offsets.append((L - 1) * st)
            blocks.append(masked(-H[ax].conj().T, c == 0))

    blk = np.stack(blocks)  # (noff, bs, bs, ns)
    op = BlockDIAOperator(blocks=jnp.asarray(blk), offsets=tuple(offsets))
    object.__setattr__(op, "_nnz", int(np.count_nonzero(blk)))
    return op


def dirac_cbdia(
    L: int, m: float = 0.5, bc: str = "periodic", dtype=jnp.float32, seed: int = 7
):
    """Build the operator as a ConstBlockDIAOperator (spin-major rows).

    Same matrix as ``dirac_bdia`` (unit-tested equivalence) in the
    constant-hop container: hop blocks are compile-time scalars, only the
    per-axis boundary masks stream from HBM — the fast path for the
    translation-invariant config-4 operator (SURVEY.md R1/T-K1).
    """
    from blockcg.operators.cbdia import ConstBlockDIAOperator

    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    ns = L**_NDIM
    coords, strides = _coords(ns, L)
    scal = complex if cplx else float
    # Boundary masks are always real 0/1 gates.
    mask_dtype = (
        np_dtype if not cplx
        else np.float32 if np_dtype == np.complex64 else np.float64
    )

    def tup(block: np.ndarray) -> tuple:
        return tuple(tuple(scal(v) for v in row) for row in block)

    offsets: list[int] = [0]
    hops: list[tuple] = [tup((m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype))]
    mask_slot: list[int] = [-1]
    masks: list[np.ndarray] = []

    def add(o: int, block: np.ndarray, mask: np.ndarray | None):
        offsets.append(o)
        hops.append(tup(block))
        if mask is None:
            mask_slot.append(-1)
        else:
            mask_slot.append(len(masks))
            masks.append(mask.astype(mask_dtype))

    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        if bc == "periodic" and ax == 0:
            # Slowest axis: flat-index wraparound IS the lattice wraparound
            # (toroidal BlockDIA/stencil semantics) — unmasked diagonals.
            add(st, -H[ax], None)
            add(-st, -H[ax].conj().T, None)
            continue
        add(st, -H[ax], c < L - 1)
        add(-st, -H[ax].conj().T, c > 0)
        if bc == "periodic":
            add(-(L - 1) * st, -H[ax], c == L - 1)
            add((L - 1) * st, -H[ax].conj().T, c == 0)

    op = ConstBlockDIAOperator(
        masks=jnp.asarray(np.stack(masks)) if masks else None,
        hops=tuple(hops),
        offsets=tuple(offsets),
        mask_slot=tuple(mask_slot),
        num_sites=ns,
    )
    nnz = 0
    for d in range(len(offsets)):
        nz = int(np.count_nonzero(np.asarray(hops[d])))
        rows = ns if mask_slot[d] < 0 else int(masks[mask_slot[d]].sum())
        nnz += nz * rows
    object.__setattr__(op, "_nnz", nnz)
    return op


def dirac_gauged(
    L: int, m: float = 0.5, bc: str = "periodic", dtype=jnp.float32,
    seed: int = 7, gauge_seed: int = 11,
) -> BlockDIAOperator:
    """Gauged (site-dependent link) flavor of the Dirac-like operator.

    Real dtypes carry Z2 links (random +-1 per site and direction), complex
    dtypes U(1) phases e^{i theta} — the hopping blocks become genuinely
    site-dependent, as with a real gauge field, exercising the general
    per-site block-stencil path (BlockDIAOperator) rather than the
    constant-hop fast path. Hermiticity: A[x, x+mu] = -phi_mu(x) H_mu and
    A[x+mu, x] = -conj(phi_mu(x)) H_mu^H; |phi| = 1 keeps the block-
    Gershgorin SPD/HPD bound lambda_min >= m^2 intact."""
    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    ns = L**_NDIM
    coords, strides = _coords(ns, L)
    grng = np.random.default_rng(gauge_seed)
    if cplx:
        links = np.exp(2j * np.pi * grng.random((_NDIM, ns))).astype(np_dtype)
    else:
        links = grng.choice([-1.0, 1.0], size=(_NDIM, ns)).astype(np_dtype)

    offsets: list[int] = [0]
    blocks: list[np.ndarray] = []
    diag = np.zeros((BS, BS, ns), dtype=np_dtype)
    diag[:, :, :] = ((m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype))[:, :, None]
    blocks.append(diag)

    def fielded(block: np.ndarray, phi: np.ndarray, mask: np.ndarray):
        out = np.zeros((BS, BS, ns), dtype=np_dtype)
        out[:, :, mask] = block[:, :, None] * phi[mask][None, None, :]
        return out

    s = np.arange(ns)
    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        phi = links[ax]  # link from site s toward +mu
        # -mu coupling of row s uses the link anchored at the NEIGHBOR s-mu.
        dn = (s + st * np.where(c == 0, L - 1, -1)) % ns
        phi_dn = np.conj(links[ax][dn]) if cplx else links[ax][dn]
        if bc == "periodic" and ax == 0:
            offsets.append(st)
            blocks.append(fielded(-H[ax], phi, np.ones(ns, bool)))
            offsets.append(-st)
            blocks.append(fielded(-H[ax].conj().T, phi_dn, np.ones(ns, bool)))
            continue
        offsets.append(st)
        blocks.append(fielded(-H[ax], phi, c < L - 1))
        offsets.append(-st)
        blocks.append(fielded(-H[ax].conj().T, phi_dn, c > 0))
        if bc == "periodic":
            offsets.append(-(L - 1) * st)
            blocks.append(fielded(-H[ax], phi, c == L - 1))
            offsets.append((L - 1) * st)
            blocks.append(fielded(-H[ax].conj().T, phi_dn, c == 0))

    blk = np.stack(blocks)
    op = BlockDIAOperator(blocks=jnp.asarray(blk), offsets=tuple(offsets))
    object.__setattr__(op, "_nnz", int(np.count_nonzero(blk)))
    return op


def dirac_gauged_matrix(
    L: int, m: float = 0.5, bc: str = "periodic", dtype=jnp.float32,
    seed: int = 7, gauge_seed: int = 11,
) -> BlockDIAOperator:
    """MATRIX-valued-link (SU(N)-style) gauged Dirac-like operator.

    Per site and direction the link is a random ORTHOGONAL (real) /
    UNITARY (complex) bs x bs matrix U_mu(x) — the non-abelian analog the
    scalar-link factorization (dirac_gauged_cbdia) cannot express, so this
    is the problem family that genuinely requires the general per-site
    block-stencil operator (operators/bdia.py; PARITY.md matrix-link gap).

    Couplings: A[x, x+mu] = -U_mu(x) H_mu and A[x+mu, x] = A[x, x+mu]^H —
    symmetric (real) / Hermitian (complex) by construction. SPD: orthogonal
    U preserves the hop spectral norm (||U H|| = ||H|| = 1), so the
    block-Gershgorin bound lambda_min >= m^2 of the ungauged operator is
    unchanged."""
    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    ns = L**_NDIM
    coords, strides = _coords(ns, L)
    grng = np.random.default_rng(gauge_seed)
    g = grng.standard_normal((_NDIM, ns, BS, BS))
    if cplx:
        g = g + 1j * grng.standard_normal((_NDIM, ns, BS, BS))
    U, _ = np.linalg.qr(g)  # batched: orthogonal/unitary per site+direction
    U = U.astype(np_dtype)

    offsets: list[int] = [0]
    blocks: list[np.ndarray] = []
    diag = np.zeros((BS, BS, ns), dtype=np_dtype)
    diag[:, :, :] = ((m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype))[:, :, None]
    blocks.append(diag)

    s = np.arange(ns)
    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        # forward per-site blocks -U_mu(s) H_mu, laid out (BS, BS, ns)
        fwd = -np.einsum("sij,jk->iks", U[ax], H[ax])
        dn = (s + st * np.where(c == 0, L - 1, -1)) % ns
        # -mu coupling of row s: Hermitian pair of the neighbor's forward
        bwd = np.conj(np.transpose(fwd[:, :, dn], (1, 0, 2)))

        def masked(blk3, mask):
            out = np.zeros((BS, BS, ns), dtype=np_dtype)
            out[:, :, mask] = blk3[:, :, mask]
            return out

        if bc == "periodic" and ax == 0:
            offsets.append(st)
            blocks.append(fwd)
            offsets.append(-st)
            blocks.append(bwd)
            continue
        offsets.append(st)
        blocks.append(masked(fwd, c < L - 1))
        offsets.append(-st)
        blocks.append(masked(bwd, c > 0))
        if bc == "periodic":
            offsets.append(-(L - 1) * st)
            blocks.append(masked(fwd, c == L - 1))
            offsets.append((L - 1) * st)
            blocks.append(masked(bwd, c == 0))

    blk = np.stack(blocks)
    op = BlockDIAOperator(blocks=jnp.asarray(blk), offsets=tuple(offsets))
    object.__setattr__(op, "_nnz", int(np.count_nonzero(blk)))
    return op


def dirac_gauged_cbdia(
    L: int, m: float = 0.5, bc: str = "periodic", dtype=jnp.float32,
    seed: int = 7, gauge_seed: int = 11,
):
    """Gauged Dirac-like operator in the CONST-HOP container.

    A SCALAR link field factorizes every per-site hop block into (constant
    spin matrix) x (per-site scalar) — exactly the const-hop operator's
    masked-diagonal form, with masks carrying the LINK VALUES (times the
    boundary gate) instead of 0/1 gates. The gauged operator then streams
    one value per site and diagonal instead of a full per-site block.

    Real dtypes: Z2 links, one value-mask per hop diagonal
    (ConstBlockDIAOperator). Complex dtypes: U(1) phase links — the
    realified form phi*H = phi_r*K1 + phi_i*K2 (K1/K2 constant real
    2bs x 2bs blocks) gives TWO value-masked diagonals per hop, built
    directly as a RealifiedHermitianOperator over a const-hop real core.

    Same matrix as ``dirac_gauged`` (unit-tested equivalence). Matrix-valued
    links (e.g. SU(3)) do not factorize — those stay on the general
    BlockDIA path."""
    from blockcg.operators.cbdia import ConstBlockDIAOperator

    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    ns = L**_NDIM
    coords, strides = _coords(ns, L)
    grng = np.random.default_rng(gauge_seed)
    if cplx:
        links = np.exp(2j * np.pi * grng.random((_NDIM, ns))).astype(np_dtype)
        rdt = np.float32 if np_dtype == np.complex64 else np.float64
    else:
        links = grng.choice([-1.0, 1.0], size=(_NDIM, ns)).astype(np_dtype)
        rdt = np_dtype
    s = np.arange(ns)

    offsets: list[int] = [0]
    hops: list[tuple] = []
    mask_slot: list[int] = [-1]
    masks: list[np.ndarray] = []

    if cplx:
        bs_r = 2 * BS

        def tup_r(block: np.ndarray) -> tuple:
            return tuple(tuple(float(v) for v in row) for row in block)

        from blockcg.operators.realify import k1k2_blocks

        def k1k2(Hc: np.ndarray):
            return k1k2_blocks(Hc, rdt)  # canonical realified convention

        cdiag = (m * m + 2.0 * _NDIM) * np.eye(bs_r, dtype=rdt)
        hops.append(tup_r(cdiag))

        def add(o: int, Hc: np.ndarray, phi: np.ndarray, gate):
            K1, K2 = k1k2(Hc)
            g = np.ones(ns, rdt) if gate is None else gate.astype(rdt)
            for K, part in ((K1, phi.real), (K2, phi.imag)):
                vals = (part.astype(rdt)) * g
                if not np.any(vals):
                    continue
                offsets.append(o)
                hops.append(tup_r(-K))
                mask_slot.append(len(masks))
                masks.append(vals)
    else:
        def tup(block: np.ndarray) -> tuple:
            return tuple(tuple(float(v) for v in row) for row in block)

        hops.append(tup((m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype)))

        def add(o: int, Hc: np.ndarray, phi: np.ndarray, gate):
            g = np.ones(ns, rdt) if gate is None else gate.astype(rdt)
            vals = phi.astype(rdt) * g
            offsets.append(o)
            hops.append(tup(-Hc))
            mask_slot.append(len(masks))
            masks.append(vals)

    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        phi = links[ax]
        dn = (s + st * np.where(c == 0, L - 1, -1)) % ns
        phi_dn = np.conj(links[ax][dn]) if cplx else links[ax][dn]
        if bc == "periodic" and ax == 0:
            add(st, H[ax], phi, None)
            add(-st, H[ax].conj().T, phi_dn, None)
            continue
        add(st, H[ax], phi, c < L - 1)
        add(-st, H[ax].conj().T, phi_dn, c > 0)
        if bc == "periodic":
            add(-(L - 1) * st, H[ax], phi, c == L - 1)
            add((L - 1) * st, H[ax].conj().T, phi_dn, c == 0)

    core = ConstBlockDIAOperator(
        masks=jnp.asarray(np.stack(masks)),
        hops=tuple(hops),
        offsets=tuple(offsets),
        mask_slot=tuple(mask_slot),
        num_sites=ns,
    )
    nnz = 0
    for d in range(len(offsets)):
        nz = int(np.count_nonzero(np.asarray(hops[d])))
        rows = ns if mask_slot[d] < 0 else int(
            np.count_nonzero(masks[mask_slot[d]])
        )
        nnz += nz * rows
    if not cplx:
        object.__setattr__(core, "_nnz", nnz)
        return core
    from blockcg.operators.realify import RealifiedHermitianOperator

    cdt = jnp.complex64 if rdt == np.float32 else jnp.complex128
    w = RealifiedHermitianOperator(
        real_op=core, cbs=BS, num_sites=ns, cdtype=cdt
    )
    # Complex nnz of the underlying operator (the realified real core's nnz
    # quadruples it; keep the physical count for nnz/s metrics).
    object.__setattr__(w, "_nnz", nnz // 4 if nnz % 4 == 0 else nnz)
    return w


def bdia_scipy(op: BlockDIAOperator):
    """Generic BlockDIAOperator -> scipy CSR (small problems; test oracle)."""
    import scipy.sparse as sp

    bs, ns = op.bs, op.ns
    n = bs * ns
    import jax

    blocks = np.asarray(jax.device_get(op.blocks))
    blocks = blocks.astype(
        np.complex128 if np.iscomplexobj(blocks) else np.float64
    )
    rows, cols, data = [], [], []
    s = np.arange(ns)
    for d, o in enumerate(op.offsets):
        scol = (s + o) % ns  # toroidal semantics (operators/bdia.py)
        for a in range(bs):
            for b in range(bs):
                vals = blocks[d, a, b, :]
                nzm = vals != 0
                rows.append(a * ns + s[nzm])
                cols.append(b * ns + scol[nzm])
                data.append(vals[nzm])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = np.concatenate(data)
    return sp.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()


def dirac_bell(
    L: int, m: float = 0.5, dtype=jnp.float32, seed: int = 7, bc: str = "periodic"
) -> BSROperator:
    """Build the operator as a BSROperator (block-ELL, site-major rows)."""
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    n_sites = L**_NDIM
    wb = 1 + 2 * _NDIM

    idx = np.arange(n_sites)
    coords, strides = _coords(n_sites, L)

    cols = np.empty((n_sites, wb), dtype=np.int32)
    vals = np.empty((n_sites, wb, BS, BS), dtype=np_dtype)

    cols[:, 0] = idx
    vals[:, 0] = (m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype)
    slot = 1
    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        if bc == "periodic":
            up = idx + st * np.where(c == L - 1, 1 - L, 1)
            dn = idx + st * np.where(c == 0, L - 1, -1)
            up_mask = np.ones(n_sites, bool)
            dn_mask = np.ones(n_sites, bool)
        else:
            up = np.where(c < L - 1, idx + st, idx)
            dn = np.where(c > 0, idx - st, idx)
            up_mask = c < L - 1
            dn_mask = c > 0
        cols[:, slot] = up
        vals[:, slot] = np.where(up_mask[:, None, None], -H[ax], 0.0)
        cols[:, slot + 1] = dn
        vals[:, slot + 1] = np.where(dn_mask[:, None, None], -H[ax].conj().T, 0.0)
        slot += 2

    op = BSROperator(vals=jnp.asarray(vals), cols=jnp.asarray(cols))
    object.__setattr__(op, "_nnz", int(np.count_nonzero(vals)))
    return op


def dirac_scipy(L: int, m: float = 0.5, seed: int = 7, bc: str = "periodic"):
    """scipy CSR export of the BSR (site-major) form for small L (duplicates
    summed, which handles the L=2 wraparound where +mu and -mu coincide)."""
    import scipy.sparse as sp

    op = dirac_bell(L, m=m, dtype=jnp.float64, seed=seed, bc=bc)
    nbr, wb = op.cols.shape
    vals = np.asarray(op.vals, dtype=np.float64)
    cols = np.asarray(op.cols)
    n = nbr * BS
    br = np.repeat(np.arange(nbr), wb)
    bc_ = cols.reshape(-1)
    sub_r, sub_c = np.meshgrid(np.arange(BS), np.arange(BS), indexing="ij")
    rows = (br[:, None, None] * BS + sub_r[None]).reshape(-1)
    ccols = (bc_[:, None, None] * BS + sub_c[None]).reshape(-1)
    data = vals.reshape(-1)
    return sp.coo_matrix((data, (rows, ccols)), shape=(n, n)).tocsr()
