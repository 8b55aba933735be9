"""Uniform voxel grid with 3-D DDA traversal (the primary accel structure).

A batched rebuild of ``Voxel_Grid`` (``Voxel_Grid.cs:27-792``, "concept
based on Amanatides" — Amanatides & Woo 1987) plus the empty-space-skip idea
of ``Voxel_Grid_Adaptive`` (``Voxel_Grid - alt.cs``), redesigned as
whole-batch array programs:

Build (host, vectorized NumPy — replaces the thread-per-core fill with
100 ms sleep-join polling, ``Voxel_Grid.cs:92-120``):
  - fixed ``domain^3`` grid over the padded model AABB (``:48-121``), or the
    adaptive ctor's criterion: keep doubling per-axis resolution until the
    average triangle count per *occupied* voxel drops below ``avg_polys`` or
    ``max_doublings`` is reached (``:128-254``).
  - membership by the same SAT triangle/box test (``AABB_Tri_Int.cs``) with
    the reference's 0.1% voxel padding (``Voxel_Grid.cs:283-285``).

Device layout — everything the traversal touches is packed so that one
gather of one wide row fetches a whole candidate window, instead of four
narrow gathers of the same data (the row width was tuned on the earlier
accelerator, not yet measured on the H100):

  - ``win_data`` (n_windows, 12*win) f32: each row is one win-triangle
    *window* of a cell's triangle list (win = 16 by default; see
    ``accel/common.WIN``) — lanes [0:9*win] hold win x [v0|e1|e2]
    Möller–Trumbore operands component-major, lanes [9*win:12*win] the
    triangle / polygon / topology ids bitcast to f32.  The test phase
    fetches whole rows; the row width is the bandwidth knob (the phase
    reads the gathered bytes from device memory).
  - ``cell_meta`` (n_cells, 2) i32: [window start | n_windows << 8 | dist],
    where ``dist`` is the chebyshev distance to the nearest occupied cell —
    the principled form of the reference's six directional ``UInt16`` step
    tables (``Voxel_Grid - alt.cs:44, 242-251``, whose skip arithmetic
    SURVEY.md flags as dubious): from a cell with dist D >= 2 the ray can
    jump D-1 cell boundaries in one parametric step.

Traversal (device): ALL rays march in lockstep inside one
``lax.while_loop`` — no vmapped scalar loops.  Each iteration issues
exactly two independent gathers (current cell's meta + one window row) and
one fused 8-wide MT test; empty regions are crossed in a single parametric
jump.  Mailboxing is dropped: min-t reduction makes duplicate tests
idempotent (vs ``Voxel_Grid.cs:29-32, 334-343, 478-480``, whose global
``assign_id()`` lock would serialize all rays).  A hit is accepted only
before the next cell boundary (the "hit point inside the current voxel"
rule, ``:496-499``, in t-form).

Unlike the reference's grid fast path (t-only, returns ``u=v=0``,
``:481-498``), real barycentrics are always returned (recomputed
differentiably in ``finalize_hits`` at the fixed hit triangle).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from ..geom.intersect import DET_EPS, MIN_T, ray_aabb
from ..geom.primitives import HitRecord, Ray
from ..geom.tribox import tri_box_overlap
from ..mesh.scene import Scene
from ..mesh.topology import Topology
from .common import (
    finalize_hits,
    pack_windows,
    straggler_tiers,
    test_windows,
)

__all__ = ["VoxelGrid", "build_voxel_grid", "shoot_grid"]

# Voxel padding factor for the SAT fill (Voxel_Grid.cs:283-285: +-0.001 voxel).
FILL_PAD = 1.001
# Epsilon nudge (in units of char_step) applied when clipping an outside ray
# to the grid entry (Voxel_Grid.cs:367-377 uses 1e-6 absolute; we scale).
ENTRY_EPS = 1e-4
# Distance-field cap (cells); larger empty regions are crossed in several
# hops.  The cell_meta packing gives the field a full 8 bits, so the cap is
# 255 (a cap of 63 made a 256^3 config-5 grid cross its biggest empty
# megaregions in 4+ hops instead of 1 — the macro-cell effect for free at
# any dims <= 256; grids wider than 256 per axis still hop).
DIST_CAP = 255


@partial(
    jax.tree_util.register_dataclass,
    data_fields=(
        "cell_meta",
        "win_data",
        "grid_min",
        "voxel_size",
    ),
    meta_fields=("dims", "char_step", "max_cell_wins", "n_tris"),
)
@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Device voxel grid: per-cell meta + packed window rows.
    ``dims``/``char_step``/``max_cell_wins`` are static."""

    cell_meta: jnp.ndarray  # (nx*ny*nz, 2) i32 [win_start, n_wins<<8 | dist]
    win_data: jnp.ndarray  # (n_windows + 1, 128) f32 packed rows; last = null
    grid_min: jnp.ndarray  # (3,) f32
    voxel_size: jnp.ndarray  # (3,) f32
    dims: Tuple[int, int, int]
    char_step: float  # min voxel dimension (Spatial_Partition.Char_Step)
    max_cell_wins: int  # max windows in any one cell
    n_tris: int

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz


def _fill(
    tri: np.ndarray, gmin: np.ndarray, vox: np.ndarray, dims: Tuple[int, int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized voxel fill: CSR (cell_start, cell_tris).

    For each triangle, candidate voxels come from its AABB footprint; a
    single batched SAT call prunes to true overlaps.  O(sum of footprint
    sizes) work with no Python-per-voxel loops.
    """
    T = len(tri)
    nx, ny, nz = dims
    i_lo, i_hi = _footprint(tri, gmin, vox, dims)
    counts = np.prod(i_hi - i_lo + 1, axis=1)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(nx * ny * nz + 1, np.int32), np.zeros(0, np.int32)

    tri_ids = np.repeat(np.arange(T), counts)
    # Enumerate each triangle's (ix, iy, iz) footprint without Python loops:
    # local linear index within the footprint box, decomposed per triangle.
    ends = np.cumsum(counts)
    local = np.arange(total) - np.repeat(ends - counts, counts)
    span = i_hi - i_lo + 1  # (T, 3)
    sy = span[tri_ids, 1]
    sz = span[tri_ids, 2]
    iz = local % sz
    iy = (local // sz) % sy
    ix = local // (sz * sy)
    cell_ijk = np.stack(
        [i_lo[tri_ids, 0] + ix, i_lo[tri_ids, 1] + iy, i_lo[tri_ids, 2] + iz], axis=1
    )

    center = gmin + (cell_ijk + 0.5) * vox
    half = np.broadcast_to(0.5 * vox * FILL_PAD, center.shape)
    keep = tri_box_overlap(tri[tri_ids], center, half)

    tri_ids = tri_ids[keep]
    cell_ijk = cell_ijk[keep]
    return _pack_csr(tri_ids, cell_ijk, dims)


def _pack_csr(
    tri_ids: np.ndarray, cell_ijk: np.ndarray, dims: Tuple[int, int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    nx, ny, nz = dims
    lin = (cell_ijk[:, 0] * ny + cell_ijk[:, 1]) * nz + cell_ijk[:, 2]
    order = np.argsort(lin, kind="stable")
    lin, tri_ids = lin[order], tri_ids[order]
    cell_counts = np.bincount(lin, minlength=nx * ny * nz)
    cell_start = np.concatenate([[0], np.cumsum(cell_counts)]).astype(np.int32)
    return cell_start, tri_ids.astype(np.int32)


def _footprint(
    tri: np.ndarray, gmin: np.ndarray, vox: np.ndarray, dims
) -> Tuple[np.ndarray, np.ndarray]:
    lo = tri.min(axis=1)
    hi = tri.max(axis=1)
    i_lo = np.clip(
        np.floor((lo - gmin) / vox - 1e-9).astype(np.int64), 0, np.array(dims) - 1
    )
    i_hi = np.clip(
        np.floor((hi - gmin) / vox + 1e-9).astype(np.int64), 0, np.array(dims) - 1
    )
    return i_lo, i_hi


def _refine_fill(
    tri: np.ndarray,
    gmin: np.ndarray,
    vox: np.ndarray,
    dims: Tuple[int, int, int],
    p_start: np.ndarray,
    p_tris: np.ndarray,
    p_dims: Tuple[int, int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Parent-membership-pruned fill for one 2x-per-axis doubling.

    Candidate (triangle, child-cell) pairs come only from the previous
    level's (triangle, parent-cell) members, each parent spawning its <= 8
    children intersected with the triangle's fine-level AABB footprint —
    the reference's adaptive ctor does exactly this (each child tested
    against the PARENT's member polys, ``Voxel_Grid.cs:208-215``); re-running
    the full footprint fill per doubling instead would be an O(doublings)
    constant-factor loss on big scenes.  Pruning is exact:
    the padded child box (pad 0.1% of the CHILD voxel) nests strictly
    inside the padded parent box (pad 0.1% of the 2x parent voxel), so
    SAT(child) implies SAT(parent) and no membership can appear at the
    fine level that was absent at the coarse one.  Each fine cell has
    exactly one parent, so no duplicate pairs arise.
    """
    i_lo, i_hi = _footprint(tri, gmin, vox, dims)
    p_counts = np.diff(p_start)
    par_lin = np.repeat(np.arange(len(p_counts), dtype=np.int64), p_counts)
    t_par = p_tris.astype(np.int64)
    pny, pnz = p_dims[1], p_dims[2]
    pc = np.stack(
        [par_lin // (pnz * pny), (par_lin // pnz) % pny, par_lin % pnz], axis=1
    )
    c_lo = np.maximum(i_lo[t_par], pc * 2)
    c_hi = np.minimum(i_hi[t_par], pc * 2 + 1)
    span = c_hi - c_lo + 1
    ok = (span > 0).all(axis=1)
    t_par, c_lo, span = t_par[ok], c_lo[ok], span[ok]
    counts = np.prod(span, axis=1)
    total = int(counts.sum())
    nx, ny, nz = dims
    if total == 0:
        return np.zeros(nx * ny * nz + 1, np.int32), np.zeros(0, np.int32)
    pair_ids = np.repeat(np.arange(len(counts)), counts)
    ends = np.cumsum(counts)
    local = np.arange(total) - np.repeat(ends - counts, counts)
    sy, sz = span[pair_ids, 1], span[pair_ids, 2]
    iz = local % sz
    iy = (local // sz) % sy
    ix = local // (sz * sy)
    cell_ijk = np.stack(
        [c_lo[pair_ids, 0] + ix, c_lo[pair_ids, 1] + iy, c_lo[pair_ids, 2] + iz],
        axis=1,
    )
    tri_ids = t_par[pair_ids]
    center = gmin + (cell_ijk + 0.5) * vox
    half = np.broadcast_to(0.5 * vox * FILL_PAD, center.shape)
    keep = tri_box_overlap(tri[tri_ids], center, half)
    return _pack_csr(tri_ids[keep], cell_ijk[keep], dims)


def _chebyshev_distance(occ: np.ndarray, cap: int = DIST_CAP) -> np.ndarray:
    """Chebyshev distance-to-occupied over a 3-D bool grid, capped.

    The skip rule is provably safe: from anywhere inside a cell with dist
    D, the ray crosses at least D-1 more cell boundaries before it can
    enter an occupied cell.

    scipy's two-pass chamfer transform is exact for the chessboard metric
    and linear in cells (256^3 grids at config-5 scale would need ~cap
    full-grid erosion sweeps otherwise); the iterative 3^3 min-erosion is
    kept as a dependency-free fallback.
    """
    if not occ.any():
        return np.full(occ.shape, cap, np.int32)
    try:
        from scipy import ndimage

        dist = ndimage.distance_transform_cdt(~occ, metric="chessboard")
        return np.minimum(dist, cap).astype(np.int32)
    except ImportError:
        pass
    dist = np.where(occ, 0, cap).astype(np.int32)
    for _ in range(cap):
        m = dist.copy()
        # 6-neighbour + diagonal erosion via padded min-shift (27-stencil).
        p = np.pad(dist, 1, constant_values=cap)
        view = np.lib.stride_tricks.sliding_window_view(p, (3, 3, 3))
        m = np.minimum(m, view.min(axis=(3, 4, 5)) + 1)
        if np.array_equal(m, dist):
            break
        dist = m
    return np.minimum(dist, cap)


def build_voxel_grid(
    source: Union[Topology, Sequence[Topology], Scene],
    domain: Optional[int] = None,
    max_doublings: int = 6,
    avg_polys: float = 10.0,
    pad: float = 1e-3,
    win: Optional[int] = None,
    only_top: Optional[int] = None,
) -> VoxelGrid:
    """Build the grid.  ``domain`` given -> fixed ``domain^3`` resolution
    (``Voxel_Grid.cs:48``); ``domain=None`` -> adaptive doubling until the
    mean triangles per occupied voxel < ``avg_polys`` or ``max_doublings``
    (``:128-254``).

    ``only_top``: restrict the grid to ONE topology's triangles (window
    rows still carry the GLOBAL triangle/polygon ids, so hits finalize
    against the shared multi-topology Scene).  This is the reference's 4-D
    ``Voxel_Inv`` per-topology candidate lists (``Voxel_Grid.cs:83``):
    ``Shoot(R, top_index)`` walks only that topology's occupancy instead
    of collecting every topology's rows and filtering at test time —
    strictly less traversal AND test work on interleaved models.
    """
    if isinstance(source, Scene):
        # NB: pulls arrays off the device — prefer the Topology path.
        real = np.asarray(source.tri_poly) != -2
        tri = np.asarray(jnp.stack(source.tri_vertices(), axis=1), np.float64)[real]
        tri_poly = np.asarray(source.tri_poly)[real]
        tri_top = np.asarray(source.tri_top)[real]
    elif isinstance(source, Topology):
        tri = source.vertices[source.tri_v]
        tri_poly = source.tri_poly
        tri_top = np.zeros(len(tri), np.int32)
    else:
        parts, pp, tt = [], [], []
        p_off = 0
        for ti, t in enumerate(source):
            parts.append(t.vertices[t.tri_v])
            pp.append(t.tri_poly + p_off)  # same offsets as build_scene
            tt.append(np.full(t.n_tris, ti, np.int32))
            p_off += t.n_polys
        tri = np.concatenate(parts, axis=0)
        tri_poly = np.concatenate(pp)
        tri_top = np.concatenate(tt)

    # Per-topology restriction: fill over the selected triangles only, but
    # keep GLOBAL ids in the packed rows (global_ids remap below).
    global_ids = None
    if only_top is not None:
        sel = tri_top == only_top
        if not sel.any():
            raise ValueError(f"topology {only_top} has no triangles")
        global_ids = np.nonzero(sel)[0].astype(np.int64)
        tri_all, poly_all, top_all = tri, tri_poly, tri_top
        tri = tri[sel]

    gmin = tri.reshape(-1, 3).min(axis=0) - pad
    gmax = tri.reshape(-1, 3).max(axis=0) + pad
    extent = gmax - gmin

    if domain is not None:
        dims = (domain, domain, domain)
        vox = extent / np.array(dims)
        cell_start, cell_tris = _fill(tri, gmin, vox, dims)
    else:
        dims = (1, 1, 1)
        cell_start, cell_tris = None, None
        prev = None
        for _ in range(max_doublings + 1):
            vox = extent / np.array(dims)
            if prev is None:
                cell_start, cell_tris = _fill(tri, gmin, vox, dims)
            else:
                # Parent-membership pruning (Voxel_Grid.cs:208-215): each
                # doubling tests only the previous level's member pairs.
                cell_start, cell_tris = _refine_fill(
                    tri, gmin, vox, dims, *prev
                )
            counts = np.diff(cell_start)
            occ = counts[counts > 0]
            if len(occ) and occ.mean() < avg_polys:
                break
            if np.prod(dims) >= 2 ** (3 * max_doublings):
                break
            prev = (cell_start, cell_tris, dims)
            dims = tuple(d * 2 for d in dims)
        vox = extent / np.array(dims)

    counts = np.diff(cell_start)
    n_cells = int(np.prod(dims))

    if global_ids is not None:
        # Remap local fill ids to global; pack against the FULL arrays so
        # the stored triangle/polygon/topology ids match the shared Scene.
        cell_tris = global_ids[cell_tris]
        tri, tri_poly, tri_top = tri_all, poly_all, top_all

    # ---- pack per-cell lists into the shared window-row layout.
    win_data, win_start, n_wins_per_cell = pack_windows(
        tri, tri_poly, tri_top, cell_start[:-1].astype(np.int64), counts,
        cell_tris, **({} if win is None else {"win": win}),
    )
    if n_wins_per_cell.max(initial=0) >= (1 << 8):
        raise ValueError(
            "a cell holds >=256 window rows — raise the grid resolution "
            "(domain/max_doublings) or avg_polys; the traversal packs "
            "(win_start, n_wins) runs into one i32 (8-bit width field)"
        )
    if len(win_data) - 1 >= (1 << 23):
        raise ValueError(
            "window table exceeds 2^23 rows; the traversal packs "
            "(win_start, n_wins) runs into one i32 (23-bit start field)"
        )

    dist = _chebyshev_distance((counts > 0).reshape(dims))
    cell_meta = np.empty((n_cells, 2), np.int32)
    cell_meta[:, 0] = win_start
    cell_meta[:, 1] = (n_wins_per_cell.astype(np.int64) << 8) | dist.ravel()

    return VoxelGrid(
        cell_meta=jnp.asarray(cell_meta),
        win_data=jnp.asarray(win_data),
        grid_min=jnp.asarray(gmin, jnp.float32),
        voxel_size=jnp.asarray(vox, jnp.float32),
        dims=tuple(int(d) for d in dims),
        char_step=float(vox.min()),
        max_cell_wins=int(n_wins_per_cell.max(initial=0)),
        n_tris=len(tri),
    )


@partial(
    jax.jit,
    static_argnames=("kernel", "top_index", "with_stats", "cap", "soft",
                     "tier", "cap_s"),
)
def shoot_grid(
    scene: Scene,
    rays: Ray,
    grid: VoxelGrid,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    with_stats: bool = False,
    cap: int = 16,
    soft: Optional[int] = None,
    tier: Optional[int] = None,
    cap_s: Optional[int] = None,
):
    """Nearest-hit query: collect-then-test 3-D DDA with empty-space skip.

    The traversal is split so that the marching loop touches only a small
    table, and the big geometry table is hit by one large batched gather
    per ray batch, not per step:

      phase 1 — *collect*: a lockstep ``lax.while_loop`` marches the DDA
        touching ONLY ``cell_meta`` (a few bytes per cell).  Occupied cells
        append their window-row ids to a per-ray candidate buffer of
        ``cap`` slots; empty runs are crossed with distance-field jumps.
        A ray stops when it leaves the grid or its buffer is full
        (overflow, with the parametric coverage limit ``t_cap`` recorded).
      phase 2 — *test*: ONE gather of all candidate rows (N x cap x 128)
        fused into a batched Möller–Trumbore + min-t reduction.

    Overflowed rays (coverage incomplete and no hit before ``t_cap``)
    resume from the overflow cell in another round of the same two phases;
    the outer loop runs until every ray is resolved — results are exact,
    not truncated.  Duplicate tests across cells/rounds are idempotent
    under the min-t reduction (this replaces the reference's mailboxing,
    ``Voxel_Grid.cs:29-32, 334-343``, whose global ``assign_id()`` lock
    would serialize all rays).

    With ``with_stats=True`` returns the 4-tuple ``(HitRecord, iters,
    rounds, nrows)`` — per-ray phase-1 iteration counts, the scalar number
    of collect+test rounds, and per-ray window-row counts tested
    (SURVEY.md §5 observability).
    """
    nx, ny, nz = grid.dims
    dims = jnp.array(grid.dims, jnp.int32)
    null_row = grid.win_data.shape[0] - 1
    # Buffer must hold at least the fattest single cell, else it can never
    # make progress through that cell.
    C = max(int(cap), grid.max_cell_wins, 1)
    # Soft test threshold: rays pause for a test pass once >= ``soft``
    # window rows are buffered (an EMPTY buffer still accepts any single
    # cell up to C, so progress is guaranteed).  Per-ray row counts are
    # small but the slab test pays for every slot of every ray, so testing
    # early at a low ``soft`` and resuming the few unresolved rays through
    # the COMPACTED straggler rounds avoids hauling a deep buffer for all N
    # rays.  None = C (no early pause).
    soft_eff = C if soft is None else max(1, min(int(soft), C))
    # Straggler rounds can take a DEEPER buffer (``cap_s``): the config-5
    # grazing tail carries up to 161 candidate rows, and refilling a C=16
    # buffer serializes it through many resume rounds (13 -> 4 rounds with
    # cap_s=64).  Default stays C: on scenes whose tails are shallow (bench:
    # rows max 6) the deep buffer's expand/test cost in the small tiers buys
    # nothing.
    C_S = C if cap_s is None else max(C, int(cap_s))
    # Phase-1 march bound: the 3(n-1)+3 DDA walk.
    p1_steps_max = nx + ny + nz + 3
    # Sub-steps per while iteration (see p1_body); tuned on the earlier
    # accelerator, not yet measured on the H100.
    UNROLL = 4
    # Outer bound: every two rounds progress at least one cell.
    max_rounds = 2 * p1_steps_max

    dtype = grid.win_data.dtype
    inf = jnp.asarray(jnp.inf, dtype)

    o = jax.lax.stop_gradient(rays.origin)  # (N, 3)
    d = jax.lax.stop_gradient(rays.direction)
    ex = rays.exclude_poly  # (N, 2)
    N = o.shape[0]

    # ---- clip to grid if outside (AABB advance, Voxel_Grid.cs:367-377)
    gmax = grid.grid_min + grid.voxel_size * dims.astype(dtype)
    inside = jnp.all((o >= grid.grid_min) & (o <= gmax), axis=-1)
    bhit, t_near, _ = ray_aabb(o, d, grid.grid_min, gmax)
    t0 = jnp.where(
        inside,
        0.0,
        jnp.where(bhit, jnp.maximum(t_near, 0.0) + ENTRY_EPS * grid.char_step, inf),
    )
    valid_ray = jnp.isfinite(t0)

    # ---- DDA setup (Voxel_Grid.cs:379-422), as SoA (N,) components.
    # All loop state is (N,) per axis rather than (N, 3), so no elementwise
    # op in the marching loop works on a 3-wide minor dimension (a layout
    # tuned on the earlier accelerator, not yet measured on the H100).
    ocmp = (o[:, 0], o[:, 1], o[:, 2])
    dcmp = (d[:, 0], d[:, 1], d[:, 2])
    gmin_c = [grid.grid_min[c] for c in range(3)]
    vox_c = [grid.voxel_size[c] for c in range(3)]
    dims_c = grid.dims

    safe_d = tuple(jnp.where(dc == 0, 1.0, dc) for dc in dcmp)
    # Reciprocals hoisted out of the march loop: a divide costs several
    # multiplies and the body divides 3-6x per step otherwise.
    inv_sd = tuple(1.0 / sd for sd in safe_d)
    inv_vox_c = [1.0 / v for v in vox_c]
    step_c = tuple(
        jnp.where(dc > 0, 1, jnp.where(dc < 0, -1, 0)).astype(jnp.int32)
        for dc in dcmp
    )
    t_delta = tuple(
        jnp.where(dc == 0, inf, vox_c[c] * jnp.abs(inv_sd[c]))
        for c, dc in enumerate(dcmp)
    )
    min_delta = jnp.minimum(jnp.minimum(t_delta[0], t_delta[1]), t_delta[2])

    # Per-ray context: every per-ray constant phase 1/2 reads.  Bundled so
    # the straggler rounds can GATHER a compacted copy (see below).
    rctx = (ocmp, dcmp, safe_d, inv_sd, step_c, t_delta, min_delta, o, d, ex)

    def locate(t_at):
        """Per-axis cell index + t_max for the position at parameter t."""
        cell, t_max = [], []
        for c in range(3):
            pos = ocmp[c] + t_at * dcmp[c]
            cl = jnp.clip(
                jnp.floor((pos - gmin_c[c]) * inv_vox_c[c]).astype(jnp.int32),
                0,
                dims_c[c] - 1,
            )
            nxt = gmin_c[c] + (cl + (dcmp[c] > 0)) * vox_c[c]
            t_max.append(
                jnp.where(dcmp[c] == 0, inf, (nxt - ocmp[c]) * inv_sd[c])
            )
            cell.append(cl)
        return tuple(cell), tuple(t_max)

    cell0, t_max0 = locate(jnp.where(valid_ray, t0, 0.0))

    # Varying-zero seeds: under shard_map the carries must have the same
    # "varying over mesh axis" type as the per-ray updates.
    vzero = jnp.sum(o, axis=-1) * 0.0  # (N,)
    izero_v = vzero.astype(jnp.int32)
    izero = jnp.sum(izero_v)

    # ======== phase 1: meta-only DDA march collecting candidate windows ====
    # The body is kept to a handful of (N,)-wide fusions and exactly ONE
    # gather — no argmin/one_hot/take_along_axis (extra gathers/relayouts),
    # no (N, 3) arrays.  Occupied cells append only their (row_start,
    # n_rows) RUN into K narrow buffers — the (n, C) window-row expansion
    # happens ONCE per round after the loop, not as an (N, C) select in
    # every step.  ``make_collect`` instantiates the loop for a given buffer
    # depth: the full-width round runs lean (C slots), the compacted
    # straggler rounds deep (C_S slots — see C_S above).
    def make_collect(C_, K_, soft_):
     lanes = jnp.arange(C_, dtype=jnp.int32)[None, :]  # (1, C_)

     def collect(ctx, cell, t_max, t_enter, active, best_t, steps_cap,
                 min_active=0):
        """March until off-grid, buffer full, past best_t, or steps_cap.

        ``min_active > 0``: also stop once at most that many rays are still
        collecting — the adaptive handoff from the full-width round to the
        compacted straggler rounds (lockstep cost is per-lane-step; marching
        N lanes for a sub-NS straggler set wastes N/NS of the work).
        """
        (ocmp, dcmp, safe_d, inv_sd, step_c, t_delta, min_delta,
         _, _, _) = ctx
        izv = cell[0] * 0  # varying zero at this width
        n = cell[0].shape[0]

        def p1_cond(s):
            n_coll = jnp.sum(s[3].astype(jnp.int32))
            return (n_coll > min_active) & (s[8] < steps_cap)

        def p1_body(s):
            # UNROLL sub-steps per while iteration: the loop-exit check is a
            # reduction to a scalar read by the loop, and each iteration is
            # a fusion boundary, so both are paid once per UNROLL steps.
            # Every state update below is masked by ``collecting``/``move``,
            # so running the step body on a finished ray is the identity and
            # the overshoot (at most UNROLL-1 steps past the handoff/cap) is
            # harmless.
            for _ in range(UNROLL):
                s = p1_step(s)
            return s

        def p1_step(s):
            (cell, t_max, t_enter, collecting, runs, cnt_c, cnt_w,
             iters, steps, paused) = s
            cx, cy, cz = cell
            tmx, tmy, tmz = t_max
            lin = (cx * ny + cy) * nz + cz
            meta = grid.cell_meta[lin]  # the ONLY in-loop gather
            ws = meta[:, 0]
            w = jax.lax.shift_right_logical(meta[:, 1], 8)
            dist = meta[:, 1] & 0xFF

            # Append this occupied cell's window RUN to the per-ray list —
            # (start, width) packed into one i32 (ws < 2^23 checked at build
            # time).  ``runs`` is K separate (n,) arrays, NOT an (n, K)
            # array, so no op in the loop has a narrow minor dimension (the
            # same layout choice as the SoA loop state; tuned on the earlier
            # accelerator, not yet measured on the H100).
            need = w > 0
            fits = ((cnt_w + w <= soft_) | ((cnt_w == 0) & (w <= C_))) & (
                cnt_c < K_
            )
            take = collecting & need & fits
            packed = (ws << 8) | w
            runs = tuple(
                jnp.where(take & (cnt_c == k), packed, runs[k])
                for k in range(K_)
            )
            cnt_c = cnt_c + take.astype(jnp.int32)
            cnt_w = cnt_w + jnp.where(take, w, 0)

            # Buffer overflow: pause HERE (coverage ends at this cell's
            # entry); the ray resumes from this very cell next round.
            pause = collecting & need & ~fits
            paused = paused | pause

            # Advance via DDA step (mask form: ties advance several axes at
            # once — a legal diagonal step) or distance-field jump (>= 2).
            t_exit = jnp.minimum(jnp.minimum(tmx, tmy), tmz)
            do_jump = dist >= 2
            move = collecting & ~pause
            stepping = move & ~do_jump
            jumping = move & do_jump
            t_jump = t_exit + (dist.astype(dtype) - 1.0) * min_delta
            t_land = t_jump + 1e-4 * min_delta

            new_cell, new_tmax, off = [], [], jnp.zeros_like(move)
            for c, (cl, tm) in enumerate(
                zip((cx, cy, cz), (tmx, tmy, tmz))
            ):
                adv = stepping & (tm <= t_exit)
                cl_s = cl + jnp.where(adv, step_c[c], 0)
                tm_s = tm + jnp.where(adv, t_delta[c], 0.0)
                pos_j = ocmp[c] + t_land * dcmp[c]
                cl_j = jnp.floor(
                    (pos_j - gmin_c[c]) * inv_vox_c[c]
                ).astype(jnp.int32)
                cl = jnp.where(jumping, cl_j, cl_s)
                off = off | ((cl < 0) | (cl >= dims_c[c]))
                cl = jnp.clip(cl, 0, dims_c[c] - 1)
                nxt = gmin_c[c] + (cl + (dcmp[c] > 0)) * vox_c[c]
                tm_j = jnp.where(
                    dcmp[c] == 0, inf, (nxt - ocmp[c]) * inv_sd[c]
                )
                new_cell.append(cl)
                new_tmax.append(jnp.where(jumping, tm_j, tm_s))
            off = off & move
            t_enter = jnp.where(
                move, jnp.where(do_jump, t_jump, t_exit), t_enter
            )

            # Keep marching only while the uncovered region can still beat
            # the best hit found in earlier rounds (t-pruning).
            collecting = move & ~off & (t_enter <= best_t)
            iters = iters + collecting.astype(jnp.int32)
            return (tuple(new_cell), tuple(new_tmax), t_enter, collecting,
                    runs, cnt_c, cnt_w, iters, steps + 1, paused)

        init = (
            cell, t_max, t_enter, active,
            tuple(izv for _ in range(K_)),  # runs (ws<<8 | w), K_ x (n,)
            izv,  # cnt_c (occupied cells collected)
            izv,  # cnt_w (window rows collected)
            izv,  # iters
            jnp.sum(izv),  # steps (scalar)
            active & False,  # paused (buffer overflow)
        )
        out = jax.lax.while_loop(p1_cond, p1_body, init)
        (cell, t_max, t_enter, collecting, runs, _, _, iters, _,
         paused) = out
        # Rays stopped by the steps cap (still `collecting`) also pause.
        paused = paused | collecting
        # Coverage is complete strictly below the entry of the pause cell.
        t_cap = jnp.where(paused, t_enter, jnp.inf)

        # Expand the (run_start, run_width) pairs into the (n, C_) window-row
        # buffer — once per round, not once per DDA step.
        buf = jnp.full((n, C_), null_row, jnp.int32) + izv[:, None]
        off = izv
        for k in range(K_):
            wk = runs[k] & 0xFF
            wsk = jax.lax.shift_right_logical(runs[k], 8)
            sel = (lanes >= off[:, None]) & (lanes < (off + wk)[:, None])
            buf = jnp.where(sel, wsk[:, None] + (lanes - off[:, None]), buf)
            off = off + wk
        return cell, t_max, t_enter, buf, paused, t_cap, iters

     return collect

    # ======== phase 2: shared batched window test (accel/common.py) =======
    def test(ctx, buf, active, best_t, best_tri):
        o_, d_, ex_ = ctx[7], ctx[8], ctx[9]
        return test_windows(
            grid.win_data, buf, o_, d_, ex_, active, best_t, best_tri,
            min_t, top_index, kernel=kernel,
        )

    # Always-tested low slots (TIER); higher slots are tested only for the
    # rays that actually used them, at COMPACTED width.  At config-5 scale,
    # TIER = C//2 = 8 with a full-width cond arm gathers 8-16M window rows
    # per 1M-ray round against a mean of 4.6 useful rows/ray.  Mean rows
    # are ~1.9-4.6 across scenes; the default C//2 keeps shallow scenes on
    # the single always-on gather (bench rows max 6 never wake the high
    # arm), while ``tier=4`` + the compacted high arm targets deep-tail
    # scenes (config 5).  The default was tuned on the earlier accelerator,
    # not yet measured on the H100.
    TIER_DEFAULT = C // 2 if soft is None else soft_eff
    if tier is not None:
        TIER_DEFAULT = int(tier)
    NS = min(N, max(2048, -(-N // 8)))  # compacted straggler width

    def make_run_round(C_, K_, soft_, TIER_):
        collect_ = make_collect(C_, K_, soft_)
        TIER_ = min(max(1, TIER_), C_)

        def run_round(ctx, cell, t_max, t_enter, active, best_t, best_tri,
                      steps_cap, min_active=0):
            """One collect+test round at whatever width ctx/state are."""
            cell, t_max, t_enter, buf, paused, t_cap, it1 = collect_(
                ctx, cell, t_max, t_enter, active, best_t, steps_cap,
                min_active,
            )
            nrows = jnp.sum((buf != null_row).astype(jnp.int32), axis=1)
            best_t, best_tri = test(
                ctx, buf[:, :TIER_], active, best_t, best_tri
            )
            if C_ > TIER_ and not compact_high:
                # Default structure: one cond, full-width high arm — fires
                # only when some ray used the high slots.  The nested compact
                # machinery below adds a cond chain around best_t even when
                # never taken, so it is opt-in via ``tier=``.
                best_t, best_tri = jax.lax.cond(
                    jnp.any(buf[:, TIER_] != null_row),
                    lambda bt, btr: test(ctx, buf[:, TIER_:], active, bt, btr),
                    lambda bt, btr: (bt, btr),
                    best_t,
                    best_tri,
                )
            elif C_ > TIER_:
                n_ = buf.shape[0]
                used = buf[:, TIER_] != null_row  # ray has high-slot rows
                n_used = jnp.sum(used.astype(jnp.int32))
                # Compacted-test width: n/2 covers the deep-tail scenes
                # this opt-in path exists for (config 5: ~30-40% of rays
                # exceed tier=4), halving the high-slot gather; more used
                # rays than NH fall back to the full-width arm.
                NH = max(2048, n_ // 2)
                izv = buf[:, 0] * 0
                rid = jnp.arange(n_, dtype=jnp.int32) + izv

                def full_arm(bt, btr):
                    return test(ctx, buf[:, TIER_:], active, bt, btr)

                def skip_arm(bt, btr):
                    return bt, btr

                if NH >= n_:
                    best_t, best_tri = jax.lax.cond(
                        n_used > 0, full_arm, skip_arm, best_t, best_tri
                    )
                else:
                    def compact_arm(bt, btr):
                        pos = jnp.cumsum(used.astype(jnp.int32)) - 1
                        sel = used & (pos < NH)
                        sidx = (jnp.zeros((NH,), jnp.int32) + izv[:NH]).at[
                            jnp.where(sel, pos, NH)
                        ].set(rid, mode="drop")
                        msk = (
                            jnp.arange(NH, dtype=jnp.int32) + izv[:NH]
                        ) < n_used
                        o_, d_, ex_ = (
                            ctx[7][sidx], ctx[8][sidx], ctx[9][sidx]
                        )
                        bt_s, btr_s = test_windows(
                            grid.win_data, buf[:, TIER_:][sidx], o_, d_,
                            ex_, msk, bt[sidx], btr[sidx], min_t,
                            top_index, kernel=kernel,
                        )
                        wi = jnp.where(msk, sidx, n_)
                        return (
                            bt.at[wi].set(bt_s, mode="drop"),
                            btr.at[wi].set(btr_s, mode="drop"),
                        )

                    best_t, best_tri = jax.lax.cond(
                        n_used == 0,
                        skip_arm,
                        lambda bt, btr: jax.lax.cond(
                            n_used <= NH, compact_arm, full_arm, bt, btr
                        ),
                        best_t,
                        best_tri,
                    )
            # Resolved: full path covered, or a hit before the coverage
            # limit.
            resolved = ~paused | (best_t <= t_cap)
            return (cell, t_max, t_enter, resolved, best_t, best_tri, it1,
                    nrows)

        return run_round

    compact_high = tier is not None
    run_round = make_run_round(C, max(C // 2, 1), soft_eff, TIER_DEFAULT)
    soft_s = C_S if soft is None else max(1, min(int(soft), C_S))
    run_round_s = make_run_round(
        C_S, max(C_S // 2, 1), soft_s, TIER_DEFAULT
    )

    # ======== round 1: full width ==========================================
    # The bulk of rays (coherent, short paths) resolve here in one pass; the
    # round hands off as soon as at most NS rays are still marching (or the
    # first buffer-full wave needs a test pass).
    cell, t_max = cell0, t_max0
    t_enter = t0 + vzero
    done = jnp.logical_not(valid_ray)
    best_t = jnp.full((N,), jnp.inf, dtype) + vzero
    best_tri = jnp.full((N,), -1, jnp.int32) + izero_v
    cell, t_max, t_enter, resolved, best_t, best_tri, iters, nrows = run_round(
        rctx, cell, t_max, t_enter, ~done, best_t, best_tri,
        p1_steps_max, NS if NS < N else 0,
    )
    done = done | resolved

    # ======== straggler rounds: COMPACTED width (shared machinery) =========
    # Lockstep traversal pays for the worst lane: unresolved rays are
    # compacted into chained narrower tiers and marched there — see
    # accel/common.straggler_tiers.  The deeper
    # C_S buffer rides only in these rounds.
    def round_s(ctx_s, st, msk, bt, btr):
        cell_s, tmax_s, te_s = st
        cell_s, tmax_s, te_s, res_s, bt, btr, it_s, nr_s = run_round_s(
            ctx_s, cell_s, tmax_s, te_s, msk, bt, btr, p1_steps_max
        )
        return (cell_s, tmax_s, te_s), res_s, bt, btr, (it_s, nr_s)

    state, done, best_t, best_tri, rounds, (iters, nrows) = straggler_tiers(
        round_s, rctx, (cell, t_max, t_enter), done, best_t, best_tri,
        (iters, nrows), NS, max_rounds,
    )
    hits = finalize_hits(scene, rays, best_t, best_tri, kernel)
    if with_stats:
        return hits, iters, rounds, nrows
    return hits
