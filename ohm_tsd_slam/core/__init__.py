from ohm_tsd_slam.core import cloud, se2

__all__ = ["cloud", "se2"]
