"""The public query facade: ``SpatialPartition`` (reference L4 contract).

Mirrors the reference's abstract base (``Spatial_Partition.cs:27-35``):
``Model`` (the topologies), ``Char_Step`` (characteristic step — the min
voxel dimension, used by consumers to epsilon-offset reflected rays), and
``Shoot`` with and without origin-polygon exclusion (exclusion rides on
``Ray.exclude_poly`` here).  The accel structure is chosen by name, and
``shoot_fn`` returns a closed-over ``(scene, rays) -> HitRecord`` suitable
for :func:`hare_tpu.trace.trace_rays`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence, Union

import numpy as np

from ..geom.primitives import HitRecord, Ray
from ..mesh.scene import Scene
from ..mesh.topology import Topology, build_scene
from .brute import shoot_brute
from .kdtree import build_kdtree, shoot_kdtree
from .octree import build_octree, shoot_octree
from .ropes import build_kdtree_ropes, shoot_kdtree_ropes
from .voxel import build_voxel_grid, shoot_grid

__all__ = ["SpatialPartition"]


class SpatialPartition:
    """Scene + acceleration structure, behind one ``shoot`` API.

    accel: ``"brute" | "grid" | "octree" | "kdtree" | "kdtree_ropes"``; structure build
    parameters pass through (``domain/avg_polys`` for the grid a la
    ``Voxel_Grid.cs:48,128``; ``max_depth/max_tris_per_node`` for trees a la
    ``Octree - alt.cs:45`` / ``KDTree.cs:51``).

    kernel: ``"watertight"`` (default — the f32 device tracer needs the
    Woop/Benthin/Wald edge tests to avoid cracks along shared edges; the f64
    reference never did) or ``"mt"`` (classic Möller–Trumbore with the
    reference's exact det-cutoff acceptance, for parity studies).
    """

    def __init__(
        self,
        model: Union[Topology, Sequence[Topology]],
        accel: str = "grid",
        kernel: str = "watertight",
        cap: Optional[int] = None,
        march: Optional[int] = None,
        soft: Optional[int] = None,
        tier: Optional[int] = None,
        cap_s: Optional[int] = None,
        **params,
    ):
        if isinstance(model, Topology):
            model = [model]
        self.model = list(model)
        self.scene: Scene = build_scene(self.model)
        self.accel_name = accel
        self.kernel = kernel
        # Shoot-time traversal knobs (HareConfig.cap/march route here):
        # grid takes ``cap`` candidate-buffer slots, trees take ``march``
        # steps per traversal round.  None = the shoot function's default.
        self._shoot_kw = {"kernel": kernel}
        if accel == "grid":
            # Deep-tail knobs: ``tier`` (always-tested slots + compacted
            # high-slot arm) and ``cap_s`` (deeper straggler buffer) — see
            # shoot_grid; worthwhile on scenes whose per-ray candidate-row
            # tails are long (config-5 scale), no help on shallow ones, so
            # both default off.
            for name, val in (("cap", cap), ("soft", soft), ("tier", tier),
                              ("cap_s", cap_s)):
                if val is not None:
                    self._shoot_kw[name] = val
        if accel in ("octree", "kdtree", "kdtree_ropes") and march is not None:
            self._shoot_kw["march"] = march

        if accel == "brute":
            self.struct = None
            self._shoot = partial(shoot_brute, **self._shoot_kw, **params)
            # Char_Step analog for brute force: smallest triangle edge.
            tri = np.concatenate([t.vertices[t.tri_v] for t in self.model])
            e = np.linalg.norm(tri - np.roll(tri, 1, axis=1), axis=2)
            self.char_step = float(e[e > 0].min()) if (e > 0).any() else 1.0
        elif accel == "grid":
            # Build from host-side topologies: extracting triangles back off
            # the device Scene costs a full device->host transfer.
            self.struct = build_voxel_grid(self.model, **params)
            self._shoot = partial(shoot_grid, grid=self.struct, **self._shoot_kw)
            self.char_step = self.struct.char_step
            self._build_params = dict(params)
            self._top_grids = {}  # per-topology grids (Voxel_Inv analog)
        elif accel == "octree":
            self.struct = build_octree(self.model, **params)
            self._shoot = partial(shoot_octree, tree=self.struct, **self._shoot_kw)
            ext = np.asarray(self.struct.root_max - self.struct.root_min)
            self.char_step = float(ext.min()) / (2 ** self.struct.max_depth)
        elif accel == "kdtree":
            self.struct = build_kdtree(self.model, **params)
            self._shoot = partial(shoot_kdtree, tree=self.struct, **self._shoot_kw)
            ext = np.asarray(self.struct.root_max - self.struct.root_min)
            self.char_step = float(ext.min()) / (2 ** min(self.struct.max_depth, 16))
        elif accel == "kdtree_ropes":
            # Stackless rope walk (accel/ropes.py), a first-class backend:
            # its two-scalar resume state may win on much deeper trees.
            self.struct = build_kdtree_ropes(self.model, **params)
            self._shoot = partial(
                shoot_kdtree_ropes, tree=self.struct, **self._shoot_kw
            )
            self.char_step = self.struct.char_step
        else:
            raise ValueError(f"unknown accel {accel!r}")

    def shoot(self, rays: Ray, top_index: Optional[int] = None) -> HitRecord:
        """``Spatial_Partition.Shoot`` — both overloads: exclusion rides on
        ``rays.exclude_poly`` (``NO_POLY`` = none).

        Grid + ``top_index`` on a multi-topology model uses a PER-TOPOLOGY
        grid (built lazily, cached): the reference's 4-D ``Voxel_Inv``
        gives each topology its own per-voxel candidate list
        (``Voxel_Grid.cs:83``), so a filtered shoot walks only that
        topology's occupancy instead of collecting every topology's window
        rows and masking at test time.  The rows carry global ids, so no
        test-time ``top_index`` filter is needed at all.
        """
        if (
            top_index is not None
            and self.accel_name == "grid"
            and len(self.model) > 1
        ):
            if top_index not in self._top_grids:
                try:
                    self._top_grids[top_index] = build_voxel_grid(
                        self.model, only_top=top_index, **self._build_params
                    )
                except ValueError:
                    # Empty or out-of-range topology: keep the combined
                    # grid's test-time filter, which returns all-miss (the
                    # behavior callers probing topologies rely on).
                    self._top_grids[top_index] = None
            g = self._top_grids[top_index]
            if g is not None:
                return shoot_grid(self.scene, rays, g, **self._shoot_kw)
        return self._shoot(self.scene, rays, top_index=top_index)

    @property
    def aux(self):
        """The accel-structure pytree — pass as ``trace_rays(..., aux=...)``
        so it enters jit as a traced argument, not an embedded constant."""
        return self.struct

    @property
    def shoot_fn(self) -> Callable[..., HitRecord]:
        """``(scene, rays[, aux]) -> HitRecord`` for trace_rays composition.

        When ``aux`` is supplied it is used as the accel structure; without
        it the constructor-bound structure is closed over (fine for tiny
        scenes, but see trace_rays docs — big closed-over structures become
        jit constants and destroy compile/step time).

        MEMOIZED: repeated accesses return the SAME callable.  A fresh
        closure per access is a jit footgun — as a static argument it makes
        every call retrace and recompile the whole program (a benchmark
        that re-reads the property per call measures compile time).
        """
        fn = getattr(self, "_shoot_fn_cache", None)
        if fn is not None:
            return fn
        if self.accel_name == "brute":
            fn = lambda scene, rays, aux=None: self._shoot(scene, rays)
        else:
            raw = {
                "grid": shoot_grid,
                "octree": shoot_octree,
                "kdtree": shoot_kdtree,
                "kdtree_ropes": shoot_kdtree_ropes,
            }[self.accel_name]
            kw = dict(self._shoot_kw)
            struct = self.struct
            fn = lambda scene, rays, aux=None: raw(
                scene, rays, aux if aux is not None else struct, **kw
            )
        self._shoot_fn_cache = fn
        return fn
