from ohm_tsd_slam.grid.state import TsdGrid, create, free_footprint
from ohm_tsd_slam.grid.interpolate import (
    interpolate_bilinear,
    interpolate_normal,
)
from ohm_tsd_slam.grid.push import push, push_jit, push_tree, push_tree_jit
from ohm_tsd_slam.grid.render import render_ranges, render_ranges_jit
from ohm_tsd_slam.grid.raycast import RaycastResult, raycast, raycast_jit
# NOTE: the raycast_fast FUNCTION is deliberately not re-exported here —
# binding it would shadow the ohm_tsd_slam.grid.raycast_fast
# SUBMODULE attribute (import it from the submodule directly)
from ohm_tsd_slam.grid.raycast_fast import (
    SegmentCache,
    extract_segments,
    extract_segments_jit,
    raycast_checked,
)

__all__ = [
    "SegmentCache",
    "extract_segments",
    "extract_segments_jit",
    "raycast_checked",
    "TsdGrid",
    "create",
    "free_footprint",
    "interpolate_bilinear",
    "interpolate_normal",
    "push",
    "push_jit",
    "push_tree",
    "push_tree_jit",
    "render_ranges",
    "render_ranges_jit",
    "RaycastResult",
    "raycast",
    "raycast_jit",
]
