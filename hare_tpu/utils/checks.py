"""Numerical sanitizers and determinism checks (SURVEY.md §5).

The reference *contains* a latent data race (shared SAT scratch fields,
``AABB_Tri_Int.cs:97-98``, written concurrently from the voxel-fill
threads, ``Voxel_Grid.cs:96-103``) and guards everything else with coarse
locks.  Pure-functional JAX removes data races by construction; the analog
sanitizer surface here is:

- :func:`enable_debug_checks`: turn on ``jax_debug_nans`` /
  ``jax_debug_infs`` so any non-finite intermediate raises at the op.
- :func:`determinism_check`: run a function twice and demand bitwise-equal
  results (same seed => same histogram) — the replacement for a race
  detector on an architecture with no shared mutable state.  Bitwise
  equality holds on the CPU backend only; see its docstring.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import jax

__all__ = ["enable_debug_checks", "determinism_check"]


def enable_debug_checks(nans: bool = True, infs: bool = False) -> None:
    """Raise on NaN (and optionally Inf) produced by any jitted op."""
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)


def determinism_check(fn: Callable, *args, runs: int = 2) -> bool:
    """True iff ``fn(*args)`` is bitwise identical across ``runs`` calls.

    Raises AssertionError naming the first differing leaf otherwise.

    Holds on the CPU backend only.  On a GPU, scatter-adds (the
    ``segment_sum`` histogram, the gather transposes in the backward pass)
    accumulate with atomics in an order that varies from run to run, so
    float results agree only to rounding; compare those with a tolerance.
    """
    ref = jax.tree.map(np.asarray, fn(*args))
    ref_leaves, treedef = jax.tree_util.tree_flatten(ref)
    for r in range(1, runs):
        out = jax.tree.map(np.asarray, fn(*args))
        leaves = treedef.flatten_up_to(out)
        for i, (a, b) in enumerate(zip(ref_leaves, leaves)):
            if not np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True):
                raise AssertionError(
                    f"nondeterminism: leaf {i} differs on run {r} "
                    f"(max abs diff {np.max(np.abs(np.asarray(a) - np.asarray(b)))})"
                )
    return True
