"""Frozen run configuration with CLI override.

The reference's only configuration surface is constructor arguments and
baked-in constants (SURVEY.md §5: ``Topology(Precision)``,
``Voxel_Grid(Model, Domain)`` / ``(Model, MaxDomain, Avg_polys)``,
``Octree/KDTree(Model, maxDepth, maxPolygonsPerNode)``; mailbox sizes and
epsilons are hard-coded).  This keeps the same tunables — weld precision,
grid domain / target occupancy, tree depth / leaf size — as one frozen
dataclass that jit can treat as static, plus batch/bounce/histogram knobs the
consumer loop needs, overridable from the command line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

__all__ = ["HareConfig"]


@dataclass(frozen=True)
class HareConfig:
    # Scene / mesh compilation (Topology ctor surface)
    precision: int = 15  # weld rounding digits (Hare_Geometry_Topology.cs:70)
    # Accel structure choice + parameters (Spatial_Partition implementations)
    accel: str = "grid"  # brute | grid | octree | kdtree
    domain: Optional[int] = None  # fixed grid resolution (Voxel_Grid.cs:48)
    max_doublings: int = 6  # adaptive cap (Voxel_Grid.cs:128)
    avg_polys: float = 10.0  # adaptive occupancy target (Voxel_Grid.cs:128)
    # octree/kdtree depth cap (Octree - alt.cs:45, KDTree.cs:51); None =
    # right-size to the scene (r5 — oversized depth inflates the register
    # stack the lockstep traversal pays for every pop; see build_octree).
    max_depth: Optional[int] = None
    max_tris_per_node: int = 16
    kernel: str = "watertight"  # watertight (default everywhere) | mt
    cap: int = 16  # grid candidate-buffer slots per round (shoot_grid cap)
    march: int = 32  # tree traversal steps per round (shoot_tree march)
    # Grid window-row width (triangles per packed row; None = 16, tuned on
    # the earlier accelerator, not yet measured on the H100).
    win: Optional[int] = None
    # Early-test threshold (shoot_grid soft); None = off (no help on
    # incoherent batches on the earlier accelerator; kept for primary-ray
    # use).
    soft: Optional[int] = None
    # Deep-tail knobs (r5, shoot_grid): ``tier`` = always-tested buffer
    # slots with a compacted high-slot arm; ``cap_s`` = deeper straggler
    # buffer.  Worthwhile when per-ray candidate-row tails are long
    # (config-5 scale: rows p99 37 / max 161); None = off.
    tier: Optional[int] = None
    cap_s: Optional[int] = None
    # Tracing
    n_rays: int = 1 << 15
    n_bounces: int = 8
    n_bins: int = 1024
    bin_dt: float = 1e-3
    sound_speed: float = 343.0
    seed: int = 0
    # Execution
    dtype: str = "float32"
    profile_dir: Optional[str] = None  # jax.profiler trace output
    metrics_path: Optional[str] = None  # JSONL metrics sink
    checkpoint_dir: Optional[str] = None

    def replace(self, **kw) -> "HareConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "HareConfig":
        return cls(**json.loads(s))

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(description="hare_tpu run configuration")
        for f in dataclasses.fields(cls):
            name = "--" + f.name.replace("_", "-")
            if f.type == "bool" or isinstance(f.default, bool):
                p.add_argument(name, action="store_true", default=f.default)
            else:
                typ = type(f.default) if f.default is not None else str
                if f.default is None and f.name in ("domain", "win", "soft", "tier", "cap_s", "max_depth"):
                    typ = int
                p.add_argument(name, type=typ, default=f.default)
        return p

    @classmethod
    def from_cli(cls, argv: Optional[Sequence[str]] = None) -> "HareConfig":
        ns = cls.parser().parse_args(argv)
        return cls(**vars(ns))

    def accel_params(self) -> dict:
        """kwargs for SpatialPartition, by accel kind — both the structure
        BUILD parameters and the shoot-time traversal knobs (``cap`` for the
        grid's candidate buffer, ``march`` for the trees' per-round step
        count), so a config round-trips into an actual traversal
        configuration."""
        if self.accel == "grid":
            extra = {}
            if self.win is not None:
                extra["win"] = self.win
            if self.soft is not None:
                extra["soft"] = self.soft
            if self.tier is not None:
                extra["tier"] = self.tier
            if self.cap_s is not None:
                extra["cap_s"] = self.cap_s
            if self.domain is not None:
                return {"domain": self.domain, "cap": self.cap, **extra}
            return {
                "max_doublings": self.max_doublings,
                "avg_polys": self.avg_polys,
                "cap": self.cap,
                **extra,
            }
        if self.accel in ("octree", "kdtree", "kdtree_ropes"):
            return {
                "max_depth": self.max_depth,
                "max_tris_per_node": self.max_tris_per_node,
                "march": self.march,
            }
        return {}
