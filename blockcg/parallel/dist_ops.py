"""Row-sharded distributed operators (T-D1, SURVEY.md §4.3).

Each distributed operator is a pytree whose array fields are *globally*
shaped and annotated P(None, ..., 'rows') on the row/site axis; inside
``shard_map`` the same dataclass holds the local shard. ``matmat_t`` must run
inside ``shard_map`` (or on a 1-shard mesh).

Per apply:
  1. launch ring halo exchange of the boundary columns of Xt (ppermute),
  2. compute the *interior* SpMM — the local operator's apply on the local
     shard, with cross-shard slots zeroed out of the interior diagonals; this
     does not depend on the halos, so XLA's latency-hiding scheduler can
     overlap it with the ppermute,
  3. apply the small boundary corrections from the received halos
     (bw-wide slice FMAs).

This is the ring-attention-style overlap mechanism applied to stencil halos
(SURVEY.md §3.3). The n-sized data never moves: per iteration the only
cross-device traffic is 2 x (k x bw) halos + the k x k psums.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from blockcg.operators.base import MatmatMixin
from blockcg.operators.dia import DIAOperator
from blockcg.operators.bdia import BlockDIAOperator
from blockcg.parallel.halo import ring_halos


@dataclasses.dataclass
class DistDIAOperator(MatmatMixin):
    """Row-sharded DIA operator.

    diags_int: (ndiag, n) interior diagonals (cross-shard slots zeroed),
      shard as P(None, 'rows').
    diags_bl / diags_br: (ndiag, D*bw) boundary coefficients for rows within
      ``bw`` of the left/right shard edge, shard as P(None, 'rows').
    """

    diags_int: jax.Array
    diags_bl: jax.Array
    diags_br: jax.Array
    offsets: tuple[int, ...]
    bw: int
    axis_name: str
    # Rows appended to make n divisible by D (identity rows with zero RHS;
    # see _pad_validity). Static metadata: changes the API-boundary field
    # shapes, so it must be a registered meta field (pytree round-trips drop
    # side-band attributes).
    pad_sites: int = 0

    @property
    def nl(self) -> int:
        return self.diags_int.shape[1]  # local rows (inside shard_map)

    @property
    def dtype(self):
        return self.diags_int.dtype

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        bw = self.bw
        halo_l, halo_r = ring_halos(Xt, bw, self.axis_name)
        # Interior SpMM — independent of the halos (overlappable).
        Y = DIAOperator(diags=self.diags_int, offsets=self.offsets).matmat_t(Xt)
        nl = Xt.shape[1]
        for d, o in enumerate(self.offsets):  # boundary corrections
            if o < 0:
                m = -o
                c = self.diags_bl[d, :m][None, :]
                Y = Y.at[:, :m].add(c * halo_l[:, bw - m :])
            elif o > 0:
                c = self.diags_br[d, bw - o :][None, :]
                Y = Y.at[:, nl - o :].add(c * halo_r[:, :o])
        return Y

    def in_specs(self):
        from jax.sharding import PartitionSpec as P

        return DistDIAOperator(
            diags_int=P(None, self.axis_name),
            diags_bl=P(None, self.axis_name),
            diags_br=P(None, self.axis_name),
            offsets=self.offsets,
            bw=self.bw,
            axis_name=self.axis_name,
            pad_sites=self.pad_sites,
        )


jax.tree_util.register_dataclass(
    DistDIAOperator,
    data_fields=["diags_int", "diags_bl", "diags_br"],
    meta_fields=["offsets", "bw", "axis_name", "pad_sites"],
)


def _pad_validity(vals_by_diag, offsets, n, D, what: str) -> int:
    """Rows to append so D | n, after verifying padding preserves answers.

    Padding appends inert rows at the global end. That is answer-preserving
    iff no real row couples across the global boundary (toroidal wrap):
    for every diagonal, coefficients whose target ``i + o`` falls outside
    ``[0, n)`` must be exactly zero (true for open/Dirichlet stencils, where
    the out-of-domain slots are zero-filled by construction). Operators with
    live wraps (periodic lattices) must use a divisor D — the error lists
    the valid counts.
    """
    pad = (-n) % D
    if pad == 0:
        return 0
    i = np.arange(n)
    for vals, o in zip(vals_by_diag, offsets):
        wraps = (i + o < 0) | (i + o >= n)
        if np.any(vals[..., wraps] != 0):
            bw = max(abs(oo) for oo in offsets)
            valid = [d for d in range(1, min(D * 4, n) + 1)
                     if n % d == 0 and bw <= n // d]
            raise ValueError(
                f"D={D} does not divide {what}={n} and the operator has live "
                f"periodic wrap couplings (offset {o}), so shard padding "
                f"would change answers. Use a divisor of {n} with shard size "
                f">= bandwidth {bw}; valid D up to {min(D * 4, n)}: {valid}"
            )
    return pad


def partition_dia(op: DIAOperator, D: int, axis_name: str = "rows") -> DistDIAOperator:
    """Host-side partition plan (SURVEY.md T-D1 'halo-plan on host, once').

    Splits each diagonal into an interior part (target row in the same shard)
    and boundary parts (target in a ring neighbor's shard). When D does not
    divide n, the last shard is padded with inert identity rows (valid for
    open-boundary stencils — see _pad_validity; periodic operators get an
    error listing valid divisor counts). Requires bandwidth <= ceil(n/D).
    """
    diags = np.asarray(op.diags)
    offsets = op.offsets
    ndiag, n = diags.shape
    pad = _pad_validity([diags[d] for d in range(ndiag)], offsets, n, D,
                        "n")
    if pad:
        diags = np.pad(diags, ((0, 0), (0, pad)))
        if 0 in offsets:
            diags[offsets.index(0), n:] = 1.0  # inert identity rows
        n += pad
    nl = n // D
    bw = max(abs(o) for o in offsets)
    if bw > nl:
        raise ValueError(f"bandwidth {bw} exceeds shard size {nl}")

    j = np.arange(n) % nl  # position within shard
    diags_int = diags.copy()
    diags_bl = np.zeros((ndiag, D * bw), dtype=diags.dtype)
    diags_br = np.zeros((ndiag, D * bw), dtype=diags.dtype)
    s = np.arange(n) // nl
    for d, o in enumerate(offsets):
        crosses = (j + o < 0) | (j + o >= nl)
        diags_int[d, crosses] = 0.0
        if o < 0:
            sel = j + o < 0  # rows [0, -o) of each shard
            diags_bl[d, s[sel] * bw + j[sel]] = diags[d, sel]
        elif o > 0:
            sel = j + o >= nl  # rows [nl-o, nl) of each shard
            diags_br[d, s[sel] * bw + (j[sel] - (nl - bw))] = diags[d, sel]
    return DistDIAOperator(
        diags_int=jnp.asarray(diags_int),
        diags_bl=jnp.asarray(diags_bl),
        diags_br=jnp.asarray(diags_br),
        offsets=offsets,
        bw=bw,
        axis_name=axis_name,
        pad_sites=pad,
    )


@dataclasses.dataclass
class DistBlockDIAOperator(MatmatMixin):
    """Row(site)-sharded BlockDIA operator.

    Sharding is over *sites*; each local shard keeps all bs spin planes.
    The ``solve_*_dist`` entry points take B/X in NATURAL spin-major GLOBAL
    ordering (row = a*ns + s) — do NOT pre-permute. ``to_dist_order`` /
    ``from_dist_order`` exist only for interpreting raw flat (k, bs*ns_l)
    shard buffers from the low-level ``matmat_t`` convention.

    blocks_int: (noff, bs, bs, ns) with cross-shard slots zeroed,
      P(None, None, None, 'rows'); blocks_bl/br: (noff, bs, bs, D*bw).
    """

    blocks_int: jax.Array
    blocks_bl: jax.Array
    blocks_br: jax.Array
    offsets: tuple[int, ...]
    bw: int
    axis_name: str
    # Sites appended so D | ns (inert identity sites; see _pad_validity).
    pad_sites: int = 0

    @property
    def bs(self) -> int:
        return self.blocks_int.shape[1]

    @property
    def dtype(self):
        return self.blocks_int.dtype

    def to_internal(self, Xt: jax.Array) -> jax.Array:
        return Xt.reshape(Xt.shape[0], self.bs, Xt.shape[1] // self.bs)

    def from_internal(self, Xv: jax.Array) -> jax.Array:
        return Xv.reshape(Xv.shape[0], Xv.shape[1] * Xv.shape[2])

    def field_pspec(self):
        from jax.sharding import PartitionSpec as P

        return P(None, None, self.axis_name)

    def matmat_t(self, Xt: jax.Array) -> jax.Array:
        """Local apply: (k, bs, ns_l) internal field (preferred — no
        per-apply lane relayout), or flat (k, bs*ns_l) spin-major rows."""
        bs, bw = self.bs, self.bw
        flat = Xt.ndim == 2
        Xv = self.to_internal(Xt) if flat else Xt
        k, _, ns_l = Xv.shape
        halo_l, halo_r = ring_halos(Xv, bw, self.axis_name)
        # Interior SpMM — independent of the halos (overlappable).
        Yv = BlockDIAOperator(
            blocks=self.blocks_int, offsets=self.offsets
        ).matmat_t(Xv)
        for d, o in enumerate(self.offsets):  # boundary corrections
            if o == 0:
                continue
            for a in range(bs):
                for b in range(bs):
                    if o < 0:
                        m = -o
                        c = self.blocks_bl[d, a, b, :m][None, :]
                        Yv = Yv.at[:, a, :m].add(c * halo_l[:, b, bw - m :])
                    else:
                        c = self.blocks_br[d, a, b, bw - o :][None, :]
                        Yv = Yv.at[:, a, ns_l - o :].add(c * halo_r[:, b, :o])
        return self.from_internal(Yv) if flat else Yv

    def in_specs(self):
        from jax.sharding import PartitionSpec as P

        spec = P(None, None, None, self.axis_name)
        return DistBlockDIAOperator(
            blocks_int=spec,
            blocks_bl=spec,
            blocks_br=spec,
            offsets=self.offsets,
            bw=self.bw,
            axis_name=self.axis_name,
            pad_sites=self.pad_sites,
        )


jax.tree_util.register_dataclass(
    DistBlockDIAOperator,
    data_fields=["blocks_int", "blocks_bl", "blocks_br"],
    meta_fields=["offsets", "bw", "axis_name", "pad_sites"],
)


def partition_bdia(
    op: BlockDIAOperator, D: int, axis_name: str = "rows"
) -> DistBlockDIAOperator:
    blocks = np.asarray(op.blocks)
    offsets = op.offsets
    noff, bs, _, ns = blocks.shape
    pad = _pad_validity([blocks[d] for d in range(noff)], offsets, ns, D,
                        "ns")
    if pad:
        blocks = np.pad(blocks, ((0, 0), (0, 0), (0, 0), (0, pad)))
        if 0 in offsets:  # inert identity blocks on the padded sites
            blocks[offsets.index(0), :, :, ns:] = np.eye(
                bs, dtype=blocks.dtype)[:, :, None]
        ns += pad
    ns_l = ns // D
    bw = max(abs(o) for o in offsets)
    if bw > ns_l:
        raise ValueError(f"site bandwidth {bw} exceeds shard size {ns_l}")

    j = np.arange(ns) % ns_l
    s = np.arange(ns) // ns_l
    blocks_int = blocks.copy()
    blocks_bl = np.zeros((noff, bs, bs, D * bw), dtype=blocks.dtype)
    blocks_br = np.zeros((noff, bs, bs, D * bw), dtype=blocks.dtype)
    for d, o in enumerate(offsets):
        crosses = (j + o < 0) | (j + o >= ns_l)
        blocks_int[d][:, :, crosses] = 0.0
        if o < 0:
            sel = j + o < 0
            blocks_bl[d][:, :, s[sel] * bw + j[sel]] = blocks[d][:, :, sel]
        elif o > 0:
            sel = j + o >= ns_l
            blocks_br[d][:, :, s[sel] * bw + (j[sel] - (ns_l - bw))] = blocks[d][
                :, :, sel
            ]
    return DistBlockDIAOperator(
        blocks_int=jnp.asarray(blocks_int),
        blocks_bl=jnp.asarray(blocks_bl),
        blocks_br=jnp.asarray(blocks_br),
        offsets=offsets,
        bw=bw,
        axis_name=axis_name,
        pad_sites=pad,
    )


@dataclasses.dataclass
class DistConstBlockDIAOperator(MatmatMixin):
    """Site-sharded constant-hop BlockDIA operator — the distributed form of
    the config-4 fast path (ConstBlockDIAOperator).

    Fields ride the MERGED spin-major internal layout (m = bs*k, ns) of the
    local ConstBlockDIAOperator, sharded by a plain contiguous split of the
    site axis — NO row reordering. ``local`` is a ConstBlockDIAOperator
    over the local shard with its cross-shard slots zeroed. Crossing
    diagonals (|offset| <= shard length — the lattice t-hops;
    partition_cbdia raises otherwise) are applied as halo-sourced edge
    corrections after a ring exchange of the bw-site edge slabs, so the
    correction touches only boundary sites.
    """

    local: object  # ConstBlockDIAOperator (local shard)
    # per-crossing edge-value coefficients ((1, D*|o|) arrays sharded on
    # sites, or None for unit-valued crossings) — gauged link values
    cross_vals: tuple = ()
    # crossing corrections: (d_hop_index, o) per crossing diagonal
    crossings: tuple = ()
    bw: int = 0
    axis_name: str = "rows"

    @property
    def bs(self) -> int:
        return self.local.bs

    @property
    def dtype(self):
        return self.local.dtype

    def to_internal(self, Xt: jax.Array) -> jax.Array:
        """Flat global (k, bs*ns) spin-major rows -> merged (m, ns)."""
        k = Xt.shape[0]
        ns = Xt.shape[1] // self.bs
        Xv = Xt.reshape(k, self.bs, ns)
        return jnp.swapaxes(Xv, 0, 1).reshape(self.bs * k, ns)

    def from_internal(self, Xm: jax.Array) -> jax.Array:
        k = Xm.shape[0] // self.bs
        ns = Xm.shape[1]
        Xv = Xm.reshape(self.bs, k, ns)
        return jnp.swapaxes(Xv, 0, 1).reshape(k, self.bs * ns)

    def coeff_expand(self, C):
        return self.local.coeff_expand(C)

    def gram_contract(self, G):
        return self.local.gram_contract(G)

    def norms2_contract(self, v):
        return self.local.norms2_contract(v)

    def matmat_t(self, Xm: jax.Array) -> jax.Array:
        """Xm: (m, ns_l) merged local internal field."""
        halo_l, halo_r = ring_halos(Xm, self.bw, self.axis_name)
        # Interior: the local const-hop apply (independent of the halos —
        # XLA overlaps it with the ppermute).
        Ym = self.local.matmat_t(Xm)
        ns_l = Xm.shape[1]
        m = Xm.shape[0]
        k = m // self.bs
        for ci, (d, o) in enumerate(self.crossings):
            h = jnp.asarray(self.local.hops[d], dtype=Xm.dtype)
            vals = self.cross_vals[ci] if self.cross_vals else None
            if o > 0:  # rows [ns_l - o, ns_l) <- right neighbour's first o
                dst0, src0, src = ns_l - o, 0, halo_r
            else:  # rows [0, -o) <- left neighbour's last -o (halo holds bw)
                dst0, src0, src = 0, self.bw + o, halo_l
            w = src[:, src0 : src0 + abs(o)].reshape(self.bs, k, abs(o))
            contrib = jnp.einsum(
                "ab,bki->aki", h, w, precision=jax.lax.Precision.HIGHEST
            ).reshape(m, abs(o))
            if vals is not None:
                contrib = contrib * vals.astype(contrib.dtype)
            Ym = Ym.at[:, dst0 : dst0 + abs(o)].add(contrib)
        return Ym

    def in_specs(self):
        from jax.sharding import PartitionSpec as P

        import dataclasses as _dc

        local_spec = _dc.replace(
            self.local,
            masks=None if self.local.masks is None else P(None, self.axis_name),
        )
        return DistConstBlockDIAOperator(
            local=local_spec,
            cross_vals=tuple(
                None if v is None else P(None, self.axis_name)
                for v in self.cross_vals
            ),
            crossings=self.crossings,
            bw=self.bw,
            axis_name=self.axis_name,
        )

    def field_pspec(self):
        from jax.sharding import PartitionSpec as P

        return P(None, self.axis_name)

    def result_from_internal_np(self, Xm: np.ndarray) -> np.ndarray:
        """Host-side merged (m, ns) -> flat (k, bs*ns) spin-major rows."""
        k = Xm.shape[0] // self.bs
        ns = Xm.shape[1]
        return (
            Xm.reshape(self.bs, k, ns).transpose(1, 0, 2).reshape(k, -1)
        )


jax.tree_util.register_dataclass(
    DistConstBlockDIAOperator,
    data_fields=["local", "cross_vals"],
    meta_fields=["crossings", "bw", "axis_name"],
)


def partition_cbdia(op, D: int, axis_name: str = "rows"):
    """Partition a ConstBlockDIAOperator over D site-contiguous shards.

    Requirements: D | ns and every crossing diagonal within one shard
    (|offset| <= ns/D — the lattice t-hops). Crossing diagonals may be
    VALUE-masked (gauged operators: per-site link values): the edge values
    ride along as per-crossing coefficient arrays multiplying the
    halo-sourced edge correction.
    """
    from blockcg.operators.cbdia import ConstBlockDIAOperator

    ns = op.num_sites
    if ns % D:
        # Periodic lattice wraps are live couplings: shard padding would
        # change answers (see _pad_validity), so const-hop partitioning
        # requires a divisor shard count. List the valid ones.
        bw_all = max(abs(o) for o in op.offsets)
        valid = [d for d in range(1, min(4 * D, ns) + 1)
                 if ns % d == 0 and bw_all <= ns // d]
        raise ValueError(
            f"ns={ns} not divisible by D={D}; const-hop (periodic-lattice) "
            f"operators cannot be shard-padded. Valid D up to "
            f"{min(4 * D, ns)}: {valid} (need shard size >= max offset "
            f"{bw_all}); or use partition_bdia on an open-boundary operator."
        )
    ns_l = ns // D
    masks_np = (
        None if op.masks is None else np.asarray(jax.device_get(op.masks))
    )
    j = np.arange(ns) % ns_l

    new_masks: list[np.ndarray] = []
    new_slot: list[int] = []
    crossings = []
    cross_vals: list = []
    dtype = np.float32 if masks_np is None else masks_np.dtype
    for d, o in enumerate(op.offsets):
        ms = op.mask_slot[d]
        crosses = (j + o < 0) | (j + o >= ns_l)
        base = np.ones(ns, dtype=dtype) if ms < 0 else masks_np[ms]
        # Effective crossing = rows whose (masked) coupling actually leaves
        # the shard. Lattice hops masked off at their own axis boundary
        # often "cross" only where the mask is already zero.
        eff = crosses & (base != 0)
        if not eff.any():
            if ms < 0 and not crosses.any():
                new_slot.append(-1)
            else:
                interior = np.where(crosses, 0.0, base).astype(dtype)
                new_slot.append(len(new_masks))
                new_masks.append(interior)
            continue
        # Crossing diagonal: local part masked off at the boundary...
        interior = np.where(crosses, 0.0, base).astype(dtype)
        new_slot.append(len(new_masks))
        new_masks.append(interior)
        # ...and a halo-sourced boundary correction over the edge slab
        # (crossing rows ARE the edge slab whenever |o| <= ns_l). Value
        # masks (gauged links) ride along as edge-value coefficients.
        edge = (j >= ns_l - o) if o > 0 else (j < -o)
        if abs(o) > ns_l:
            raise ValueError(
                f"offset {o} reaches past the neighbouring shard "
                f"(shard length {ns_l}) — use fewer shards or partition_bdia"
            )
        if np.all(base[edge] == 1.0):
            vals = None
        else:
            eb = base.reshape(D, ns_l)
            ev = eb[:, ns_l - o :] if o > 0 else eb[:, : -o]
            vals = jnp.asarray(ev.reshape(1, D * abs(o)).astype(dtype))
        crossings.append((d, o))
        cross_vals.append(vals)

    if not crossings:
        raise ValueError("no crossing diagonals; use the operator directly")
    bw = max(abs(o) for _, o in crossings)

    # num_sites is the LOCAL shard length: the operator is only applied
    # inside shard_map, where its mask arrays carry the local slice.
    local = ConstBlockDIAOperator(
        masks=jnp.asarray(np.stack(new_masks)) if new_masks else None,
        hops=op.hops,
        offsets=op.offsets,
        mask_slot=tuple(new_slot),
        num_sites=ns_l,
    )
    return DistConstBlockDIAOperator(
        local=local,
        cross_vals=tuple(cross_vals),
        crossings=tuple(crossings),
        bw=bw,
        axis_name=axis_name,
    )


def to_dist_order(X: np.ndarray, bs: int, D: int) -> np.ndarray:
    """Reorder an (n, k) block from global spin-major rows (a*ns + s) to the
    distributed ordering (shard-major, spin, site-within-shard)."""
    n = X.shape[0]
    ns = n // bs
    ns_l = ns // D
    Xv = X.reshape(bs, D, ns_l, -1)  # (a, shard, site_l, k)
    return np.transpose(Xv, (1, 0, 2, 3)).reshape(n, -1)


def from_dist_order(X: np.ndarray, bs: int, D: int) -> np.ndarray:
    n = X.shape[0]
    ns = n // bs
    ns_l = ns // D
    Xv = X.reshape(D, bs, ns_l, -1)
    return np.transpose(Xv, (1, 0, 2, 3)).reshape(n, -1)


from blockcg.operators.schur import SchurEvenOperator


@dataclasses.dataclass
class DistSchurEvenOperator(SchurEvenOperator):
    """Site-sharded Schur-complement operator S_e = c I - H_eo H_oe / c on
    even-parity merged half fields — the distributed form of
    operators.schur.SchurEvenOperator (whose apply formula and field/codec
    delegations are INHERITED; each parity hop is a
    DistConstBlockDIAOperator doing its own ring halo exchange, so one
    Schur apply costs two halo rounds — inherent to the composition; all
    other traffic is local)."""

    @property
    def axis_name(self) -> str:
        return self.hop_oe.axis_name

    def field_pspec(self):
        return self.hop_oe.field_pspec()

    def result_from_internal_np(self, Xm):
        return self.hop_oe.result_from_internal_np(Xm)

    def in_specs(self):
        return DistSchurEvenOperator(
            hop_eo=self.hop_eo.in_specs(),
            hop_oe=self.hop_oe.in_specs(),
            c=self.c,
        )


jax.tree_util.register_dataclass(
    DistSchurEvenOperator,
    data_fields=["hop_eo", "hop_oe"],
    meta_fields=["c"],
)


def partition_dirac_eo(eo, D: int,
                       axis_name: str = "rows") -> DistSchurEvenOperator:
    """Partition an EOContext's Schur system over D site-contiguous shards
    of the half lattice (both parity hops via ``partition_cbdia``; gauged
    value-masked crossings supported). Solve with
    ``parallel.solve_sbcgrq_dist(dist_schur, rhs_e, mesh)`` — the rhs/odd
    reconstruction steps (eo_split / eo_assemble and the two single-hop
    applies) stay host-side or single-device as in ``solve_dirac_eo``."""
    return DistSchurEvenOperator(
        hop_eo=partition_cbdia(eo.hop_eo, D, axis_name=axis_name),
        hop_oe=partition_cbdia(eo.hop_oe, D, axis_name=axis_name),
        c=eo.c,
    )


@dataclasses.dataclass
class DistEONormalOperator(MatmatMixin):
    """Site-sharded ``mu I - H_eo H_oe`` (multi-shift even-odd base
    operator; see operators.schur.EONormalOperator) over distributed
    parity hops — two halo rounds per apply."""

    hop_eo: object  # DistConstBlockDIAOperator
    hop_oe: object
    mu: float

    @property
    def axis_name(self) -> str:
        return self.hop_oe.axis_name

    @property
    def bs(self) -> int:
        return self.hop_oe.bs

    @property
    def dtype(self):
        return self.hop_oe.dtype

    def to_internal(self, Xt):
        return self.hop_oe.to_internal(Xt)

    def from_internal(self, Xm):
        return self.hop_oe.from_internal(Xm)

    def result_from_internal_np(self, Xm):
        return self.hop_oe.result_from_internal_np(Xm)

    def coeff_expand(self, C):
        return self.hop_oe.coeff_expand(C)

    def gram_contract(self, G):
        return self.hop_oe.gram_contract(G)

    def norms2_contract(self, v):
        return self.hop_oe.norms2_contract(v)

    def field_pspec(self):
        return self.hop_oe.field_pspec()

    def matmat_t(self, Xm: jax.Array) -> jax.Array:
        mu = jnp.asarray(self.mu, dtype=jnp.real(Xm).dtype)
        return mu * Xm - self.hop_eo.matmat_t(self.hop_oe.matmat_t(Xm))

    def in_specs(self):
        return DistEONormalOperator(
            hop_eo=self.hop_eo.in_specs(),
            hop_oe=self.hop_oe.in_specs(),
            mu=self.mu,
        )


jax.tree_util.register_dataclass(
    DistEONormalOperator,
    data_fields=["hop_eo", "hop_oe"],
    meta_fields=["mu"],
)
