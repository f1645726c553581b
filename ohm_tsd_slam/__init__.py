"""ohm_tsd_slam — a 2D TSD-grid SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
autonohm/ohm_tsd_slam: online 2D SLAM for laser
scanners on a truncated-signed-distance (TSD) grid, with

  * a functional TSD grid state (dense tiles instead of lazily allocated
    partitions; cf. reference src/obvision/reconstruct/grid/TsdGrid.h),
  * a vectorized scan-fusion ("push") kernel (cf. TsdGrid.cpp:217-284),
  * a batched polar ray-marcher rendering model scans from the grid
    (cf. RayCastPolar2D.cpp:194-281) with analytic pose/cell gradients
    (absent in the reference),
  * registration: brute-force-NN ICP with closed-form 2D estimation
    (cf. Icp.cpp, ClosedFormEstimator2D.cpp) plus RANSAC-style global
    matchers (cf. ransacMatching/*),
  * a host-side SLAM runtime replicating the reference's three-thread
    architecture (ThreadLocalize / ThreadMapping / ThreadGrid), and
  * multi-chip scale-out via jax.sharding over rays and grid tiles.
"""

import jax as _jax

# Geometry everywhere in this library flows through small f32 matmuls
# (3x3 pose composes, Nx2 point transforms, RANSAC control-set products,
# the raycast's ray-segment cross products).  On the GPU an f32 matmul
# may run in TF32, which keeps ~3 decimal digits of the mantissa — on
# world coordinates of a 25 m map that is centimetres, enough to shift
# back-projected beam indices by whole bins.  Pin the default to full
# f32.
_jax.config.update("jax_default_matmul_precision", "highest")

from ohm_tsd_slam.version import __version__

__all__ = ["__version__"]
