"""Loader for the golden-file binary format written by golden/harness.cpp
(the compiled, unmodified C++ reference) and the scenario text parser."""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "golden")
ROOM_BIN = os.path.join(GOLDEN_DIR, "data", "room.bin")
ROOM_TXT = os.path.join(GOLDEN_DIR, "data", "room.txt")
ROOM_STORE = os.path.join(GOLDEN_DIR, "data", "room_store.txt")

_DTYPES = {b"f": np.float64, b"i": np.int32, b"b": np.uint8}


def load_golden(path: str = ROOM_BIN) -> Dict[str, np.ndarray]:
    """Parse the tagged-array stream (name, dtype, dims, payload)."""
    arrays: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    n = len(data)
    while off < n:
        (nl,) = struct.unpack_from("<I", data, off)
        off += 4
        name = data[off:off + nl].decode()
        off += nl
        dt = data[off:off + 1]
        off += 1
        (nd,) = struct.unpack_from("<I", data, off)
        off += 4
        dims = struct.unpack_from("<%dI" % nd, data, off)
        off += 4 * nd
        dtype = _DTYPES[dt]
        count = int(np.prod(dims)) if nd else 1
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=off)
        off += count * dtype().itemsize
        arrays[name] = arr.reshape(dims)
    return arrays


class Scenario:
    def __init__(self, path: str = ROOM_TXT):
        with open(path) as f:
            tok = f.read().split()
        i = 0

        def take(k):
            nonlocal i
            assert tok[i] == k, (tok[i], k)
            i += 1

        take("grid")
        self.cellsize = float(tok[i]); i += 1
        self.layout_part = int(tok[i]); i += 1
        self.layout_grid = int(tok[i]); i += 1
        self.max_trunc = float(tok[i]); i += 1
        take("sensor")
        self.size = int(tok[i]); i += 1
        self.angular_res = float(tok[i]); i += 1
        self.phi_min = float(tok[i]); i += 1
        self.max_range = float(tok[i]); i += 1
        self.min_range = float(tok[i]); i += 1
        self.low_reflectivity_range = float(tok[i]); i += 1
        take("footprint")
        if tok[i] == "none":
            self.footprint = None
            i += 1
        else:
            self.footprint = tuple(float(tok[i + k]) for k in range(4))
            i += 4
        take("npush")
        npush = int(tok[i]); i += 1
        self.push_poses: List[np.ndarray] = []
        self.push_ranges: List[np.ndarray] = []
        for _ in range(npush):
            take("pose")
            self.push_poses.append(
                np.array([float(x) for x in tok[i:i + 9]]).reshape(3, 3))
            i += 9
            take("ranges")
            self.push_ranges.append(
                np.array([float(x) for x in tok[i:i + self.size]]))
            i += self.size
        take("nquery")
        nq = int(tok[i]); i += 1
        self.query_poses: List[np.ndarray] = []
        for _ in range(nq):
            take("pose")
            self.query_poses.append(
                np.array([float(x) for x in tok[i:i + 9]]).reshape(3, 3))
            i += 9


# ---------------------------------------------------------------------------
# RANSAC parity helpers (golden/ransac_harness + golden/shim/detrand.h)
# ---------------------------------------------------------------------------

RANSAC_DIR = os.path.join(GOLDEN_DIR, "data", "ransac")


class DetRand:
    """Replays golden/shim/detrand.h's 31-bit LCG exactly."""

    def __init__(self, seed: int):
        self.s = seed & 0xFFFFFFFF

    def rand(self) -> int:
        self.s = (self.s * 1103515245 + 12345) & 0xFFFFFFFF
        return self.s & 0x7FFFFFFF


def replay_subsample(seed: int, mask_s: np.ndarray):
    """Phase 1 of the reference matchers' rand() stream: subsampleMask
    over the raw scene mask (one draw per point regardless of validity,
    RandomMatching.cpp:171-183, gated by probability < 0.99).  Returns
    (post-subsample mask, DetRand carrying the stream state)."""
    n = mask_s.shape[0]
    dr = DetRand(seed)
    valid_points = int(mask_s.sum())
    prob = 180.0 / max(valid_points, 1)
    sub = np.array(mask_s, bool).copy()
    if prob < 0.99:
        thresh = int(1000.0 - prob * 1000.0 + 0.5)
        for i in range(n):
            if dr.rand() % 1000 < thresh:
                sub[i] = False
    return sub, dr


def replay_picks(dr: "DetRand", idx_s_valid, idx_m_valid,
                 trials: int, size_control: int):
    """Phase 2: pickControlSet over the post-PCA scene indices
    (RandomMatching.cpp:52-75), the intercepted no-op srand, then one
    erase-without-replacement draw per trial over the post-PCA model
    indices (RandomNormalMatching.cpp:221-238).  Returns
    (ctrl_idx list, trial_idx list)."""
    c = min(size_control, len(idx_s_valid))
    tmp = list(idx_s_valid)
    ctrl = []
    for _ in range(c):
        r = dr.rand() % len(tmp)
        ctrl.append(tmp.pop(r))

    # srand(time(NULL)) in the reference is det_srand = no-op

    t = min(trials, len(idx_m_valid))
    tmp = list(idx_m_valid)
    tidx = []
    for _ in range(t):
        r = dr.rand() % len(tmp)
        tidx.append(tmp.pop(r))
    return ctrl, tidx


def load_score3d(path: str) -> np.ndarray:
    """score3D.dat rows: trial idxM idxS score (Trace.cpp:289-300)."""
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) == 4:
                rows.append((int(p[0]), int(p[1]), int(p[2]),
                             float(p[3])))
    return np.array(rows, dtype=np.float64)


def replay_twin(seed: int, idx_s_valid, n_m_valid: int, trials: int,
                size_control: int, min_d: int, max_d: int):
    """TwinPointMatching's rand() stream (TwinPointMatching.cpp:144-191):
    pickControlSet over the raw-valid scene indices, the intercepted
    no-op srand, then per trial (randIdx, second-sample) draw pairs over
    the valid-model RANKS.  Returns (ctrl_idx, rank1, rank2)."""
    dr = DetRand(seed)
    tmp = list(idx_s_valid)
    ctrl = []
    for _ in range(min(size_control, len(tmp))):
        r = dr.rand() % len(tmp)
        ctrl.append(tmp.pop(r))
    # srand(time(NULL)) in pickControlSet is det_srand = no-op
    r1s, r2s = [], []
    for _ in range(trials):
        r1 = dr.rand() % ((n_m_valid - 1) - min_d)
        remaining = min(n_m_valid - r1 - 1, max_d)
        r2 = r1 + (dr.rand() % (remaining - min_d)) + min_d
        r1s.append(r1)
        r2s.append(r2)
    return ctrl, r1s, r2s


# ---------------------------------------------------------------------------
# Full-loop replays (golden/slam_harness.cpp): the same scan sequences
# through this framework, for the parity tests and the on-card check
# ---------------------------------------------------------------------------

SLAM_BIN = os.path.join(GOLDEN_DIR, "data", "slam.bin")
SLAM_NPZ = os.path.join(GOLDEN_DIR, "data", "slam_inputs.npz")
SLAM_TSD_BIN = os.path.join(GOLDEN_DIR, "data", "slam_tsd.bin")
SLAM_TSD_NPZ = os.path.join(GOLDEN_DIR, "data", "slam_tsd_inputs.npz")


def replay_slam_loop_icp():
    """Replay slam_inputs.npz through SlamNode.process_scan (mode ICP,
    float64).  Returns (got_poses [K,3,3], got_flags [K,2] as
    (reg_error, significant), ref_poses, ref_flags)."""
    import math

    import jax.numpy as jnp

    from ohm_tsd_slam.config import (
        FootprintConfig,
        GridConfig,
        IcpConfig,
        RegistrationConfig,
        RobotConfig,
        SensorConfig,
        SlamConfig,
    )
    from ohm_tsd_slam.slam import LaserScan, SlamNode

    golden = load_golden(SLAM_BIN)
    inp = np.load(SLAM_NPZ)
    scans = inp["scans"]
    (cellsize, layout_grid, max_trunc, size, ang_res, phi_min, max_range,
     min_range, low_refl, icp_iters, dist_max, dist_min, trns_max,
     rot_max, trns_min, rot_min) = inp["params"]
    fp_w, fp_h = inp["footprint"]

    cfg = SlamConfig(
        grid=GridConfig(map_size=int(layout_grid), cellsize=float(cellsize),
                        truncation_radius=float(max_trunc / cellsize)),
        robots=[RobotConfig(
            local_offset_yaw=0.2,
            sensor=SensorConfig(max_range=float(max_range),
                                min_range=float(min_range),
                                low_reflectivity_range=float(low_refl),
                                laser_min_range=0.0),
            footprint=FootprintConfig(width=float(fp_w),
                                      height=float(fp_h), x_offset=0.0),
            registration=RegistrationConfig(
                trns_thresh=float(trns_max), rot_thresh=float(rot_max),
                trns_min=float(trns_min), rot_min=float(rot_min),
                icp=IcpConfig(iterations=int(icp_iters),
                              dist_filter_max=float(dist_max),
                              dist_filter_min=float(dist_min))),
        )],
    )
    node = SlamNode(cfg, dtype=jnp.float64)

    got_poses, got_flags = [], []
    for k in range(len(scans)):
        ranges = np.where(scans[k] >= 1e29, np.inf, scans[k])
        msg = LaserScan(ranges=ranges, angle_min=float(phi_min),
                        angle_increment=float(ang_res),
                        range_max=float(max_range), stamp=float(k))
        out = node.process_scan(0, msg)
        loc = node.localizers[0]
        got_poses.append(np.asarray(loc.pose))
        if k == 0:
            assert out is None
            got_flags.append((0, 1))                 # init push
        else:
            err = out is None or math.isnan(out.x)
            got_flags.append((int(err), int(np.allclose(
                np.asarray(loc.last_pose), np.asarray(loc.pose)))))
    return (np.asarray(got_poses), np.asarray(got_flags),
            np.asarray(golden["pose_trace"]).reshape(-1, 3, 3),
            np.asarray(golden["flags"]))


def replay_slam_loop_tsd():
    """Replay slam_tsd_inputs.npz through the localization cycle in the
    reference's shipped default mode (TSD_PDFMatching seed + ICP, float64),
    injecting the harness's rand draws (DetRand) into match_tsd so both
    sides score the SAME candidate sets against the SAME evolving grid.
    Returns (got_poses, got_flags, ref_poses, ref_flags) as
    replay_slam_loop_icp does."""
    import math

    import jax
    import jax.numpy as jnp

    from ohm_tsd_slam.config import GridConfig, IcpConfig
    from ohm_tsd_slam.grid import create, push
    from ohm_tsd_slam.grid.raycast_fast import raycast_fast
    from ohm_tsd_slam.grid.state import free_footprint
    from ohm_tsd_slam.registration.icp import IcpParams
    from ohm_tsd_slam.registration.ransac import (
        RansacInject,
        RansacParams,
        match_tsd,
        pca_normals,
    )
    from ohm_tsd_slam.sensor.polar2d import (
        SensorPolar2D,
        data_to_cartesian,
        standard_mask,
    )
    from ohm_tsd_slam.slam.localize import LocalizeParams, localize_step

    golden = load_golden(SLAM_TSD_BIN)
    inp = np.load(SLAM_TSD_NPZ)
    scans = inp["scans"]
    (cellsize, layout_grid, max_trunc, size, ang_res, phi_min, max_range,
     min_range, low_refl, icp_iters, dist_max, dist_min, trns_max,
     rot_max, trns_min, rot_min) = inp["params"]
    fp_w, fp_h = inp["footprint"]
    (r_trials, r_eps, r_ctl, r_phi_deg, r_zrand, r_seed) = inp["ransac"]
    gt = inp["gt"]

    geom = SensorPolar2D(size=int(size), angular_res=float(ang_res),
                         phi_min=float(phi_min),
                         max_range=float(max_range),
                         min_range=float(min_range),
                         low_reflectivity_range=float(low_refl))
    gcfg = GridConfig(map_size=int(layout_grid), cellsize=float(cellsize),
                      truncation_radius=float(max_trunc / cellsize))
    gw = gcfg.size_meters
    rparams = RansacParams(
        trials=int(r_trials), eps_thresh=float(r_eps),
        size_control_set=int(r_ctl),
        phi_max=math.radians(float(r_phi_deg)),
        resolution=float(ang_res), zrand_tsd=float(r_zrand))
    lparams = LocalizeParams(
        geom=geom,
        icp=IcpParams.from_config(
            IcpConfig(iterations=int(icp_iters),
                      dist_filter_max=float(dist_max),
                      dist_filter_min=float(dist_min)),
            bounds=(0.0, gw, 0.0, gw)),
        trns_max=float(trns_max), rot_max=float(rot_max),
        trns_min=float(trns_min), rot_min=float(rot_min))

    grid = create(gcfg, dtype=jnp.float64)
    pose = jnp.asarray(np.array([[np.cos(gt[0][2]), -np.sin(gt[0][2]),
                                  gt[0][0]],
                                 [np.sin(gt[0][2]), np.cos(gt[0][2]),
                                  gt[0][1]],
                                 [0.0, 0.0, 1.0]]))
    grid = free_footprint(grid, (float(gt[0][0]), float(gt[0][1])),
                          float(fp_w), float(fp_h))
    last_pose = pose

    rr = rparams.pca_search_range // 2
    N = int(size)
    key0 = jax.random.PRNGKey(0)

    # jit once (static matcher/localize params): the 24-scan loop would
    # otherwise retrace the matcher + ICP every scan
    raycast_j = jax.jit(lambda g, p: raycast_fast(g, geom, p))
    match_j = jax.jit(
        lambda k, g, p, mc, mm, sc, sm, inj: match_tsd(
            k, g, p, mc, mm, sc, sm, rparams, inject=inj))
    loc_j = jax.jit(
        lambda g, p, lp, d, m, tp: localize_step(
            g, p, lp, d, m, lparams, T_prereg=tp))
    push_j = jax.jit(lambda g, p, d, m: push(g, geom, p, d, m))
    pca_j = jax.jit(lambda pts, m: pca_normals(pts, m, rr))

    got_poses, got_flags = [], []
    for k in range(len(scans)):
        ranges = np.where(scans[k] >= 1e29, np.inf, scans[k])
        data, mask = standard_mask(geom, jnp.asarray(ranges))
        if k == 0:
            grid = push_j(grid, pose, data, mask)
            got_poses.append(np.asarray(pose))
            got_flags.append((0, 1))
            continue

        model = raycast_j(grid, pose)
        scene, smask = data_to_cartesian(geom, data, mask)

        # replay the harness's det_reset(seed + k) rand stream
        _, mask_mp = pca_j(model.coords, model.mask)
        sub, dr = replay_subsample(int(r_seed) + k, np.asarray(smask))
        _, mask_sp_full = pca_j(scene, smask)
        mask_sp = np.asarray(mask_sp_full) & sub
        mask_mp_np = np.asarray(mask_mp)
        idx_s_valid = [i for i in range(rr, N - rr) if mask_sp[i]]
        idx_m_valid = [i for i in range(rr, N - rr) if mask_mp_np[i]]
        ctrl, tidx = replay_picks(dr, idx_s_valid, idx_m_valid,
                                  rparams.trials,
                                  rparams.size_control_set)
        C = rparams.size_control_set
        T = rparams.trials
        ctrl_idx = np.zeros(C, np.int32)
        ctrl_idx[:len(ctrl)] = ctrl
        trial_idx = np.zeros(T, np.int32)
        trial_idx[:len(tidx)] = tidx
        inject = RansacInject(
            sub_mask=jnp.asarray(sub),
            ctrl_idx=jnp.asarray(ctrl_idx),
            ctrl_valid=jnp.asarray(np.arange(C) < len(ctrl)),
            trial_idx=jnp.asarray(trial_idx),
            trial_valid=jnp.asarray(np.arange(T) < len(tidx)))

        T_pre = match_j(key0, grid, pose, model.coords, model.mask,
                        scene, smask, inject)
        res = loc_j(grid, pose, last_pose, data, mask, T_pre)
        pose = res.pose
        if bool(res.significant):
            grid = push_j(grid, pose, data, mask)
            last_pose = pose
        got_poses.append(np.asarray(pose))
        got_flags.append((int(bool(res.reg_error)),
                          int(bool(res.significant))))
    return (np.asarray(got_poses), np.asarray(got_flags),
            np.asarray(golden["pose_trace"]).reshape(-1, 3, 3),
            np.asarray(golden["flags"]))


def loop_parity(got_poses, got_flags, ref_poses, ref_flags):
    """The full-loop parity bounds: gate decisions equal scan for scan,
    and |dpos|, |drot| (rotation-matrix entry) below 1e-4.  Returns
    (ok, max |dpos|, max |drot|, gates_equal)."""
    gates = bool(np.array_equal(got_flags, ref_flags[:, :2]))
    dpos = float(np.abs(got_poses[:, :2, 2] - ref_poses[:, :2, 2]).max())
    drot = float(np.abs(got_poses[:, 0, 0] - ref_poses[:, 0, 0]).max())
    return gates and dpos < 1e-4 and drot < 1e-4, dpos, drot, gates
