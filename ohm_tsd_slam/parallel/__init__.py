from ohm_tsd_slam.parallel.mesh import (
    grid_sharding,
    make_mesh,
    replicated,
    robot_sharding,
)
from ohm_tsd_slam.parallel.sharded import (
    SlamStepResult,
    make_sharded_step,
    map_residual_loss,
    multi_robot_slam_step,
    pose_gradient,
)

__all__ = [
    "grid_sharding",
    "make_mesh",
    "replicated",
    "robot_sharding",
    "SlamStepResult",
    "make_sharded_step",
    "map_residual_loss",
    "multi_robot_slam_step",
    "pose_gradient",
]
