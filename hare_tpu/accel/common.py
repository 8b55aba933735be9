"""Shared accel helpers: differentiable hit finalization.

Traversal (DDA / tree descent) runs inside ``lax.while_loop``, which JAX
cannot reverse-differentiate.  But the only discrete decision that matters is
*which triangle* was hit — so each backend returns the winning ``tri_id``
(an integer, gradient-free by nature), and the hit quantities (t, u, v,
point) are recomputed OUTSIDE the loop from the live ``scene.vertices`` by
one differentiable Möller–Trumbore evaluation per ray.

This is exactly the fixed-hit-topology differentiation regime (SURVEY.md §7
L5): gradients of hit distance / point w.r.t. vertex positions are the
implicit-function derivatives of the MT system at the frozen triangle
assignment, and they flow through gather-transpose scatter-adds onto shared
welded vertices.  Traversal decisions get straight-through (zero) gradient.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..geom.intersect import kernel_components
from ..geom.primitives import NO_POLY, HitRecord, Ray
from ..mesh.scene import Scene

__all__ = [
    "finalize_hits",
    "kernel_components",
    "pack_windows",
    "straggler_tiers",
    "test_windows",
    "WIN",
]

# Default triangles per window row.  Row width = 12*win lanes (9 geometry
# components + 3 id lanes per triangle).  The test phase reads the
# materialized gather result, (N*C, 12*win) rows, from device memory, so
# row BYTES are what matters — and with typical cell occupancies of ~10-30
# triangles, 32-wide rows are mostly padding.  16 halves the traffic at
# equal coverage for all but the fattest cells (tuned on the earlier
# accelerator, not yet measured on the H100); builders may pass ``win=`` to
# pack_windows to override (test_windows infers the width from
# ``win_data.shape[1]``).
WIN = 16


def pack_windows(
    tri: np.ndarray,
    tri_poly: np.ndarray,
    tri_top: np.ndarray,
    start: np.ndarray,
    counts: np.ndarray,
    items: np.ndarray,
    win: int = WIN,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-group triangle lists into 12*win-lane window rows (host side).

    Shared device layout for every accel structure (grid cells, octree and
    KD-tree leaves): each row holds a WIN-triangle *window* of one group's
    list, geometry COMPONENT-MAJOR — lane ``c*WIN+k`` is component c
    (v0x..e2z) of instance k — so the test kernel consumes static WIN-lane
    slices with no cross-lane reshapes; triangle / polygon / topology ids
    ride bitcast in lanes 9*WIN:12*WIN.  Row ``n_windows`` is all-null.

    Args:
      tri: (T, 3, 3) triangle vertices. tri_poly/tri_top: (T,) ids.
      start/counts: (G,) CSR offsets into ``items`` per group.
      items: (total,) triangle ids, group-major.
    Returns:
      (win_data (NW+1, 12*win) f32, win_start (G,) i64, n_wins (G,) i64)
    """
    n_wins_per = -(-counts // win)
    win_start = np.concatenate([[0], np.cumsum(n_wins_per)]).astype(np.int64)
    n_windows = int(win_start[-1])
    win_data = np.zeros((n_windows + 1, 12 * win), np.float32)
    if n_windows:
        occ = np.nonzero(counts)[0]
        win_grp = np.repeat(occ, n_wins_per[occ])
        win_local = np.arange(n_windows) - win_start[win_grp]
        lane = np.arange(win)
        pos = start[win_grp][:, None] + (win_local[:, None] * win + lane)
        in_range = pos < (start[win_grp] + counts[win_grp])[:, None]
        pos_c = np.minimum(pos, len(items) - 1)
        t_ids = np.where(in_range, items[pos_c], -1)
        safe = np.maximum(t_ids, 0)
        g = tri[safe]  # (n_windows, win, 3, 3)
        v0 = g[:, :, 0, :]
        ops = np.concatenate(
            [v0, g[:, :, 1, :] - v0, g[:, :, 2, :] - v0], axis=-1
        )
        ops = np.where(in_range[:, :, None], ops, 0.0)
        win_data[:n_windows, 0 : 9 * win] = ops.transpose(0, 2, 1).reshape(
            n_windows, 9 * win
        )
        win_data[:n_windows, 9 * win : 10 * win] = np.where(
            in_range, t_ids, -1
        ).astype(np.int32).view(np.float32)
        win_data[:n_windows, 10 * win : 11 * win] = np.where(
            in_range, tri_poly[safe], -2
        ).astype(np.int32).view(np.float32)
        win_data[:n_windows, 11 * win : 12 * win] = np.where(
            in_range, tri_top[safe], -1
        ).astype(np.int32).view(np.float32)
    win_data[n_windows, 9 * win : 10 * win] = (
        np.full(win, -1, np.int32).view(np.float32)
    )
    win_data[n_windows, 10 * win : 11 * win] = (
        np.full(win, -2, np.int32).view(np.float32)
    )
    win_data[n_windows, 11 * win : 12 * win] = (
        np.full(win, -1, np.int32).view(np.float32)
    )
    return win_data, win_start[:-1], n_wins_per.astype(np.int64)


# Rays per internal test chunk: bounds the materialized gather result to
# ~C * 12*win * 4 * CHUNK bytes (~800 MB at C=16, win=16) so million-ray
# batches don't materialize a 13 GB full-width gather (config-5 scale).
# Tuned on the earlier accelerator, not yet measured on the H100.
TEST_CHUNK = 1 << 16


def test_windows(
    win_data: jnp.ndarray,
    buf: jnp.ndarray,
    o: jnp.ndarray,
    d: jnp.ndarray,
    ex: jnp.ndarray,
    active: jnp.ndarray,
    best_t: jnp.ndarray,
    best_tri: jnp.ndarray,
    min_t: float,
    top_index: Optional[int] = None,
    kernel: str = "watertight",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    N = buf.shape[0]
    n_chunks = -(-N // TEST_CHUNK)
    if n_chunks > 1:
        # Pad N up to a multiple of n_chunks (padding lanes are inactive, so
        # they contribute nothing); without this, non-divisible ray counts
        # (65537, any non-power-of-two million-ray batch) would silently fall
        # back to the full-width gather this chunking exists to prevent.
        nc = -(-N // n_chunks)
        Np = n_chunks * nc

        def padded(a, fill):
            if Np == N:
                return a
            pw = ((0, Np - N),) + ((0, 0),) * (a.ndim - 1)
            return jnp.pad(a, pw, constant_values=fill)

        rs = lambda a: a.reshape((n_chunks, nc) + a.shape[1:])

        def one(args):
            return _test_windows(
                win_data, *args, min_t=min_t, top_index=top_index,
                kernel=kernel,
            )

        bt, btr = jax.lax.map(
            one,
            (rs(padded(buf, 0)), rs(padded(o, 0.0)), rs(padded(d, 1.0)),
             rs(padded(ex, 0)), rs(padded(active, False)),
             rs(padded(best_t, jnp.inf)), rs(padded(best_tri, -1))),
        )
        return bt.reshape(Np)[:N], btr.reshape(Np)[:N]
    return _test_windows(
        win_data, buf, o, d, ex, active, best_t, best_tri,
        min_t=min_t, top_index=top_index, kernel=kernel,
    )


def _test_windows(
    win_data: jnp.ndarray,
    buf: jnp.ndarray,
    o: jnp.ndarray,
    d: jnp.ndarray,
    ex: jnp.ndarray,
    active: jnp.ndarray,
    best_t: jnp.ndarray,
    best_tri: jnp.ndarray,
    min_t: float,
    top_index: Optional[int] = None,
    kernel: str = "watertight",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched candidate test: ONE gather + fused component-major test + min-t.

    ``kernel="mt"``: Möller–Trumbore in scalar-component form over the window
    rows' WIN-lane blocks (zero cross-lane reshapes); acceptance matches the
    reference (two-sided, det cutoff 1e-6,
    ``Hare_Geometry_Polygons.cs:406,417``; ``t > min_t`` and origin-polygon
    exclusion applied by the traversal layer exactly as
    ``Voxel_Grid.cs:477-491``).

    ``kernel="watertight"``: Woop/Benthin/Wald 2013 watertight variant in the
    same component-major form — per-ray shear constants computed once, edge
    functions whose signs agree across shared edges, so f32 rays through
    shared edges of adjacent triangles cannot fall through cracks (the
    reference relies on f64 everywhere instead).

    Args:
      buf: (N, C) i32 window-row ids (null rows are self-masking).
    Returns: updated (best_t, best_tri).
    """
    N, C = buf.shape
    win = win_data.shape[1] // 12  # static: row width encodes the packing
    inf = jnp.asarray(jnp.inf, win_data.dtype)
    # Per-SLOT (N, 12*win) processing rather than one flat (N*C, 12*win)
    # form: each slot's rows gather into their natural row-major tiling
    # (same total rows), and the per-ray quantities — the watertight shear
    # constants, origin components, exclusion ids — stay at (N, 1) shapes
    # that XLA computes ONCE and CSEs across all C slots, instead of being
    # jnp.repeat-expanded to (N*C, 1) arrays re-evaluated per candidate row.
    d_cmp = tuple(d[:, c : c + 1] for c in range(3))
    o_cmp = tuple(o[:, c : c + 1] for c in range(3))
    act_c = active[:, None]
    ex0, ex1 = ex[:, 0:1], ex[:, 1:2]
    big = jnp.int32(2**31 - 1)

    def tree_min(t_, i_):
        # Lane-halving (t, tid) min tree instead of axis reduces:
        # jnp.min(axis=1) made XLA pick a column-major layout for the whole
        # gathered operand and insert a 200 MB transpose copy.  Ties pick
        # the smallest triangle id — deterministic, and coinciding for the
        # common duplicate-test case.
        w = t_.shape[1]
        if w & (w - 1):  # pad to the next power of two with +inf lanes
            p = 1 << w.bit_length()
            t_ = jnp.pad(t_, ((0, 0), (0, p - w)), constant_values=jnp.inf)
            i_ = jnp.pad(i_, ((0, 0), (0, p - w)), constant_values=big)
        while t_.shape[1] > 1:
            h = t_.shape[1] // 2
            ta, ia = t_[:, :h], i_[:, :h]
            tb, ib = t_[:, h:], i_[:, h:]
            lt = (tb < ta) | ((tb == ta) & (ib < ia))
            t_ = jnp.where(lt, tb, ta)
            i_ = jnp.where(lt, ib, ia)
        return t_[:, 0], i_[:, 0]

    t_slots, tid_slots = [], []
    for c in range(C):
        g = win_data[buf[:, c]]  # (N, 12*win)
        cmp = [g[:, win * i : win * (i + 1)] for i in range(9)]
        valid, t, _, _ = kernel_components(kernel, o_cmp, d_cmp, cmp)
        tid = jax.lax.bitcast_convert_type(g[:, 9 * win : 10 * win], jnp.int32)
        tp = jax.lax.bitcast_convert_type(g[:, 10 * win : 11 * win], jnp.int32)
        acc = (
            act_c
            & valid
            & (t > min_t)
            & (tid >= 0)
            & (tp != ex0)
            & (tp != ex1)
        )
        if top_index is not None:
            ttop = jax.lax.bitcast_convert_type(
                g[:, 11 * win : 12 * win], jnp.int32
            )
            acc &= ttop == top_index
        t_c, tid_c = tree_min(jnp.where(acc, t, inf), tid)  # (N,)
        t_slots.append(t_c)
        tid_slots.append(tid_c)
    t_min, tri_cand = tree_min(
        jnp.stack(t_slots, axis=1), jnp.stack(tid_slots, axis=1)
    )
    better = t_min < best_t
    return (
        jnp.where(better, t_min, best_t),
        jnp.where(better, tri_cand, best_tri),
    )


def straggler_tiers(
    round_fn,
    rctx,
    state,
    done: jnp.ndarray,
    best_t: jnp.ndarray,
    best_tri: jnp.ndarray,
    counters: Tuple[jnp.ndarray, ...],
    NS: int,
    max_rounds: int,
):
    """Chained-width compacted straggler rounds — shared by every lockstep
    traversal (grid DDA, tree stack walk, KD rope walk).

    Lockstep cost is per-lane-step and per-ray work is long-tailed, so
    unresolved rays are compacted (cumsum + scatter) into a narrower state
    and marched there; the loop runs as up to three width TIERS, each
    handing off to a 4x narrower one when the active count drops below the
    next width, so the long tail is not paid at the full compaction width
    (shared by the grid DDA, the tree stack walk and the rope walk).

    Args:
      round_fn: ``(ctx_s, state_s, active_mask, best_t_s, best_tri_s) ->
        (state_s, resolved_s, best_t_s, best_tri_s, counter_deltas)`` —
        one collect+test round at the compacted width; ``counter_deltas``
        is a tuple matching ``counters`` (per-ray i32 increments).
      rctx: pytree of (N, ...) per-ray constants, gathered per tier.
      state: pytree of (N, ...) per-ray RESUME state (cells/stacks/nodes).
      done / best_t / best_tri: (N,) round-1 outputs.
      counters: tuple of (N,) i32 accumulators (iters, nrows, ...).
      NS: first-tier width (narrower tiers follow at /4 steps, >= 2048).
      max_rounds: per-tier round bound is ``max_rounds * (N // ns)``.
    Returns: ``(state, done, best_t, best_tri, rounds, counters)``.
    """
    N = best_t.shape[0]
    izero_v = best_tri * 0
    ray_ids = jnp.arange(N, dtype=jnp.int32) + izero_v

    def one_tier(carry, ns, stop_below):
        ns_lanes = jnp.arange(ns, dtype=jnp.int32) + izero_v[:ns]
        max_small_rounds = max_rounds * max(1, N // ns)

        def s_cond(c):
            n_active = jnp.sum((~c[1]).astype(jnp.int32))
            return (n_active > stop_below) & (c[4] < max_small_rounds)

        def s_body(c):
            state, done, best_t, best_tri, rounds, counters = c
            active = ~done
            pos = jnp.cumsum(active.astype(jnp.int32)) - 1
            sel = active & (pos < ns)
            sidx = (jnp.zeros((ns,), jnp.int32) + izero_v[:ns]).at[
                jnp.where(sel, pos, ns)
            ].set(ray_ids, mode="drop")
            msk = ns_lanes < jnp.sum(sel.astype(jnp.int32))

            gath = lambda a: a[sidx]
            state_s, res_s, bt_s, btr_s, deltas = round_fn(
                jax.tree.map(gath, rctx), jax.tree.map(gath, state), msk,
                gath(best_t), gath(best_tri),
            )
            wi = jnp.where(msk, sidx, N)  # padding lanes dropped on scatter
            put = lambda full, small: full.at[wi].set(small, mode="drop")
            return (
                jax.tree.map(put, state, state_s),
                put(done, res_s),
                put(best_t, bt_s),
                put(best_tri, btr_s),
                rounds + 1,
                tuple(
                    acc.at[wi].add(jnp.where(msk, dl, 0), mode="drop")
                    for acc, dl in zip(counters, deltas)
                ),
            )

        return jax.lax.while_loop(s_cond, s_body, carry)

    rounds0 = jnp.sum(izero_v) + 1
    carry = (state, done, best_t, best_tri, rounds0, tuple(counters))
    tiers = [NS]
    while tiers[-1] > 2048:
        tiers.append(max(2048, tiers[-1] // 4))
    tiers = tiers[:3]  # compile-size cap; 3 tiers span 16x in width
    for i, ns in enumerate(tiers):
        nxt = tiers[i + 1] if i + 1 < len(tiers) else 0
        carry = one_tier(carry, ns, stop_below=nxt)
    return carry


def _vals_from_comps(kernel, o, d, tri_cmp):
    """(t, u, v, nx, ny, nz) of the frozen triangle from component tuples.

    UNMASKED evaluation (raw ray/plane solution): under a vertex update the
    frozen triangle's barycentric bounds may no longer contain the ray —
    the true hit slid to a neighboring triangle — but the fixed-topology
    value/derivative is the supporting-plane solution.  The masked form
    returned t = +inf there, which poisoned live-vertex losses."""
    o_cmp = tuple(o[..., c] for c in range(3))
    d_cmp = tuple(d[..., c] for c in range(3))
    _, t, u, v = kernel_components(kernel, o_cmp, d_cmp, tri_cmp,
                                   unmasked=True)
    e1x, e1y, e1z, e2x, e2y, e2z = tri_cmp[3:9]
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    return t, u, v, nx, ny, nz


def _vals_live(kernel, vertices, iv, o, d):
    """The LIVE recompute: gather current vertices of the frozen triangle
    and evaluate the hit values — the differentiable reference path."""
    v0, v1, v2 = vertices[iv[:, 0]], vertices[iv[:, 1]], vertices[iv[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    tri_cmp = (
        tuple(v0[..., c] for c in range(3))
        + tuple(e1[..., c] for c in range(3))
        + tuple(e2[..., c] for c in range(3))
    )
    return _vals_from_comps(kernel, o, d, tri_cmp)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def _hit_vals(kernel, vertices, iv, o, d, row):
    """Hit values of the frozen triangle: (t, u, v, nx, ny, nz).

    Forward: computed from ``row`` — the geometry lanes of
    ``Scene.tri_geom`` (ONE gathered row; zero narrow vertex gathers).  The
    rows track the current ``scene.vertices``: ``Scene.with_vertices``
    refreshes them, so the forward is LIVE under vertex updates.  Backward: the exact VJP of the live recompute,
    evaluated at the current ``vertices`` (the gathers run only under
    differentiation); the ``row`` cotangent is zeroed so the gradient
    reaches ``vertices`` exactly once even though the rows are themselves
    a function of the vertices.
    """
    tri_cmp = tuple(row[:, c] for c in range(9))
    return _vals_from_comps(kernel, o, d, tri_cmp)


def _hit_vals_fwd(kernel, vertices, iv, o, d, row):
    out = _hit_vals(kernel, vertices, iv, o, d, row)
    return out, (vertices, iv, o, d, row)


def _hit_vals_bwd(kernel, res, ct):
    vertices, iv, o, d, row = res
    _, vjp = jax.vjp(
        lambda vv, oo, dd: _vals_live(kernel, vv, iv, oo, dd), vertices, o, d
    )
    dv, do, dd = vjp(ct)
    f0 = np.zeros(iv.shape, dtype=jax.dtypes.float0)
    return (dv, f0, do, dd, jnp.zeros_like(row))


_hit_vals.defvjp(_hit_vals_fwd, _hit_vals_bwd)


def finalize_hits(
    scene: Scene,
    rays: Ray,
    best_t: jnp.ndarray,
    best_tri: jnp.ndarray,
    kernel: str = "watertight",
) -> HitRecord:
    """Build a differentiable HitRecord from traversal winners.

    best_t is used only for the hit mask (isfinite); the returned values are
    the frozen-hit-topology evaluation at ``best_tri`` — forward from the
    packed ``Scene.tri_geom`` row (one gather), gradients via
    :func:`_hit_vals`'s live-vertex backward.
    """
    hit = jnp.isfinite(jax.lax.stop_gradient(best_t))
    tri = jax.lax.stop_gradient(jnp.maximum(best_tri, 0))

    row = scene.tri_geom[tri]  # ONE packed row: v0|e1|e2|poly|nbrs|tri_v
    iv = jax.lax.bitcast_convert_type(row[:, 13:16], jnp.int32)
    poly_r = jax.lax.bitcast_convert_type(row[:, 9], jnp.int32)
    t, u, vv, nx, ny, nz = _hit_vals(
        kernel, scene.vertices, iv, rays.origin, rays.direction, row
    )
    t = jnp.where(hit, t, 0.0)  # keep grads NaN-free on misses

    point = rays.origin + t[..., None] * rays.direction
    poly = jnp.where(hit, poly_r, NO_POLY)
    return HitRecord(
        hit=hit,
        t=jnp.where(hit, t, jnp.inf),
        u=jnp.where(hit, u, 0.0),
        v=jnp.where(hit, vv, 0.0),
        point=jnp.where(hit[..., None], point, 0.0),
        poly_id=poly.astype(jnp.int32),
        tri_id=jnp.where(hit, tri, NO_POLY).astype(jnp.int32),
        normal=jnp.stack([nx, ny, nz], axis=-1),
    )
