from ohm_tsd_slam.slam.localize import (
    LocalizeParams,
    LocalizeResult,
    localize_step,
    localize_step_jit,
)
from ohm_tsd_slam.slam.mapping import Mapper
from ohm_tsd_slam.slam.grid_pub import GridPublisher
from ohm_tsd_slam.slam.messages import (
    ImageMsg,
    LaserScan,
    OccupancyGridMsg,
    PoseStamped,
    Transform2D,
)
from ohm_tsd_slam.slam.node import Localizer, SlamNode

__all__ = [
    "LocalizeParams",
    "LocalizeResult",
    "localize_step",
    "localize_step_jit",
    "Mapper",
    "GridPublisher",
    "ImageMsg",
    "LaserScan",
    "OccupancyGridMsg",
    "PoseStamped",
    "Transform2D",
    "Localizer",
    "SlamNode",
]
