"""hare_tpu — a differentiable acoustic ray tracer on JAX.

A from-scratch JAX framework with the capabilities of
PachydermAcoustic/Hare (see SURVEY.md): watertight ray/triangle and ray/AABB
intersection, voxel-grid 3D-DDA, octree and KD-tree traversal, welded mesh
topology — plus analytic gradients and multi-chip sharding the reference
never had.
"""

from . import accel, dist, geom, mesh, trace, utils
from .geom import AABB, HitRecord, NO_POLY, Ray
from .mesh import Scene, Topology, build_scene
from .accel import SpatialPartition
from .trace import TraceResult, energy_histogram, trace_rays
from .utils import HareConfig

__version__ = "0.1.0"

__all__ = [
    "AABB",
    "HareConfig",
    "HitRecord",
    "NO_POLY",
    "Ray",
    "Scene",
    "SpatialPartition",
    "Topology",
    "TraceResult",
    "accel",
    "build_scene",
    "dist",
    "energy_histogram",
    "geom",
    "mesh",
    "trace",
    "trace_rays",
    "utils",
]
