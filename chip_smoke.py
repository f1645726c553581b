#!/usr/bin/env python3
"""On-card smoke check of the SLAM node.

    python chip_smoke.py

Runs on one NVIDIA GPU and refuses to run anywhere else (exit 2, last
line {"ok": false, ...}).  Every phase must pass for exit 0.

  A  the main path through the CLI entry point, in-process:
     `simulate` (1081 beams, 120 scans) and `run` on
     configs/single-laser.yaml (1024^2 grid at 0.025 m, registration
     mode 3: TSD-RANSAC seed + 30 ICP iterations), then `launch multi`
     (configs/double-laser.yaml: two robots on one grid).
  B  on-card comparisons with the plain references at 1024^2 / 1081
     beams: the cached fast caster against the exact march, the GPU
     push against the same push in float64 on the CPU device,
     localize_step (modes 3 and 0) against the CPU device, and the
     compiled-C++ golden loops replayed in float64 on the card.
  C  plain-stage times (block_until_ready wall, median after warm-up),
     mode-3 compile times and device memory.

Outputs go to chiprun_out/chip_smoke/ beside this script.  The last
stdout line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")
CONFIG = os.path.join(HERE, "configs", "single-laser.yaml")

# Phase A: trajectory error bound against ground truth (max over the
# run, after aligning at the first published pose).  Noise-free
# simulated scans on a 2.5 cm grid: a healthy run stays well inside one
# cell.
TRAJ_MAX_ERR_M = 0.025
# Phase B tolerances (float32 on the card unless stated):
#   fast caster vs exact march (tests/test_raycast_fast.py criterion,
#   with an f32 coordinate tolerance)
CASTER_MIN_AGREE = 0.98
CASTER_COORD_TOL_M = 1e-4
#   GPU f32 push vs CPU f64 push: f32 cell-centre coordinates at 25 m
#   carry ~1e-6 m rounding (~2e-5 of the 7.5 cm truncation), so a cell
#   "differs" above 1e-4; differing cells must be rare and each must sit
#   on a beam-bin boundary, where f32 and f64 bearings may bin apart
PUSH_TSD_TOL = 1e-4
PUSH_MAX_DIFF_FRAC = 5e-4
PUSH_BIN_EDGE_TOL = 1e-3
PUSH_WEIGHT_TOL = 1e-5
#   localize_step GPU vs CPU, same key, both float32
LOC_POS_TOL_M = 1e-3
LOC_ROT_TOL_RAD = 1e-4
#   golden loops (tests/test_reference_parity_slam.py bounds, float64)
GOLDEN_TOL = 1e-4
# Phase C: timed repetitions after warm-up
TIMED_REPS = 20


class CheckFailed(Exception):
    """A smoke check missed its bound."""


def require(ok, detail=None):
    """Raise CheckFailed unless `ok` (an assert would vanish under -O)."""
    if not ok:
        raise CheckFailed(detail)


def card_name_and_limit() -> str:
    """`name, power.limit` of the card as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _load_golden_io():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import golden_io

    return golden_io


def sim_geom(log, max_range=30.0):
    from ohm_tsd_slam.sensor.polar2d import SensorPolar2D

    return SensorPolar2D(size=int(log["ranges"].shape[1]),
                         angular_res=float(log["angle_increment"]),
                         phi_min=float(log["angle_min"]),
                         max_range=max_range, min_range=0.01,
                         low_reflectivity_range=2.0)


def gt_pose(xyt, dtype):
    import jax.numpy as jnp

    from ohm_tsd_slam.core import se2

    return jnp.asarray(np.array(se2.make(*map(float, xyt))), dtype)


def scan(geom, ranges, dtype):
    import jax.numpy as jnp

    from ohm_tsd_slam.sensor.polar2d import standard_mask

    return standard_mask(geom, jnp.asarray(ranges, dtype))


def build_map(grid_cfg, log, geom, every=10, dtype=None):
    """Fuse every `every`-th logged scan at its ground-truth pose into a
    fresh grid (the simulator's world frame is the grid frame)."""
    import jax
    import jax.numpy as jnp

    from ohm_tsd_slam.grid import create, push

    dtype = dtype or jnp.float32
    grid = create(grid_cfg, dtype=dtype)
    push_j = jax.jit(lambda g, p, d, m: push(g, geom, p, d, m))
    gt = log["ground_truth"]
    for k in range(0, len(gt), every):
        d, m = scan(geom, log["ranges"][k], dtype)
        grid = push_j(grid, gt_pose(gt[k], dtype), d, m)
    return grid


# ---------------------------------------------------------------------------
# Phase A: the main path
# ---------------------------------------------------------------------------

def phase_main_path(out, config=CONFIG, beams=1081, steps=120,
                    multi_steps=120, multi_config=None, label="",
                    traj_bound=TRAJ_MAX_ERR_M):
    """simulate -> run -> launch multi through __main__.main."""
    from ohm_tsd_slam.__main__ import main, trajectory_errors

    os.makedirs(out, exist_ok=True)
    scans = os.path.join(out, "scans.npz")
    run_out = os.path.join(out, "run")
    require(main(["simulate", "--beams", str(beams), "--steps", str(steps),
                  "--config", config, "--out", scans]) == 0, "simulate")
    require(main(["run", scans, "--config", config, "--out", run_out]) == 0,
            "run")

    for name in ("map.pgm", "trajectory.csv", "scan_stats.csv"):
        require(os.path.exists(os.path.join(run_out, name)), name)
    stats = np.loadtxt(os.path.join(run_out, "scan_stats.csv"),
                       delimiter=",", skiprows=1, ndmin=2)
    traj = np.loadtxt(os.path.join(run_out, "trajectory.csv"),
                      delimiter=",", skiprows=1, ndmin=2)
    log = np.load(scans)
    errs, n_nan_traj = trajectory_errors([tuple(r) for r in traj],
                                         log["ground_truth"])
    rays_dropped = stats[:, 2].astype(int)
    nan_scans = int(stats[1:, 3].sum())
    res = dict(
        scans=len(stats),
        first_scan_s=float(stats[0, 1]),
        median_scan_s=float(np.median(stats[1:, 1])),
        max_scan_s=float(np.max(stats[1:, 1])),
        traj_mean_err_m=float(np.mean(errs)) if errs else math.nan,
        traj_max_err_m=float(np.max(errs)) if errs else math.nan,
        nan_scans=nan_scans,
        rays_dropped_total=int(rays_dropped.sum()),
        scans_with_drops=int((rays_dropped > 0).sum()),
    )
    print(f"  run: {res['scans']} scans; first scan (init + compile) "
          f"{res['first_scan_s']:.3f} s; per-scan median "
          f"{res['median_scan_s'] * 1e3:.3f} ms, max "
          f"{res['max_scan_s'] * 1e3:.3f} ms [{label}]")
    print(f"  trajectory error vs ground truth: mean "
          f"{res['traj_mean_err_m']:.5f} m, max {res['traj_max_err_m']:.5f}"
          f" m (bound {traj_bound} m); NaN scans after the first: "
          f"{nan_scans}; rays_dropped total {res['rays_dropped_total']} "
          f"on {res['scans_with_drops']} scans (must be 0)")
    require(errs and res["traj_max_err_m"] < traj_bound, res)
    require(nan_scans == 0 and n_nan_traj == 0, res)
    require(res["rays_dropped_total"] == 0, res)

    multi_out = os.path.join(out, "multi")
    argv = ["launch", "multi", "--out", multi_out, "--steps",
            str(multi_steps), "--beams", str(beams)]
    if multi_config:
        argv += ["--config", multi_config]
    require(main(argv) == 0)
    require(os.path.exists(os.path.join(multi_out, "map.pgm")))
    nan_r = []
    for r in range(2):
        t = np.loadtxt(os.path.join(multi_out, f"trajectory_r{r}.csv"),
                       delimiter=",", skiprows=1, ndmin=2)
        require(len(t) == multi_steps - 1, (r, len(t)))
        nan_r.append(int(np.isnan(t[:, 1]).sum()))
    # the launch simulates one log and replays it for both robots; robot
    # 1 starts at its configured offset, so its scans do not match its
    # pose and its NaN count is reported, not checked
    print(f"  launch multi: 2 robots x {multi_steps} scans, map.pgm "
          f"written; NaN poses robot 0: {nan_r[0]} (must be 0), robot 1: "
          f"{nan_r[1]}")
    require(nan_r[0] == 0, nan_r)
    res["multi_nan_poses"] = nan_r
    return res


# ---------------------------------------------------------------------------
# Phase B: on-card comparisons
# ---------------------------------------------------------------------------

def phase_caster(grid, geom, poses):
    """Cached fast caster vs the exact march, beam for beam."""
    import jax

    from ohm_tsd_slam.grid.raycast import raycast
    from ohm_tsd_slam.grid.raycast_fast import (
        extract_segments_jit,
        raycast_fast,
    )

    seg = extract_segments_jit(grid)
    fast_j = jax.jit(lambda g, p, s: raycast_fast(g, geom, p, segments=s))
    exact_j = jax.jit(lambda g, p: raycast(g, geom, p))
    worst_agree, worst_dc, n_hits = 1.0, 0.0, 0
    for p in poses:
        fast = fast_j(grid, p, seg)
        exact = exact_j(grid, p)
        require(int(fast.n_dropped) == 0, int(fast.n_dropped))
        mf, me = np.asarray(fast.mask), np.asarray(exact.mask)
        both = mf & me
        agree = float((mf == me).mean())
        dc = float(np.abs(np.asarray(fast.coords)[both]
                          - np.asarray(exact.coords)[both]).max(
                              initial=0.0))
        worst_agree = min(worst_agree, agree)
        worst_dc = max(worst_dc, dc)
        n_hits += int(both.sum())
    print(f"  fast caster vs exact march ({len(poses)} poses, "
          f"{geom.size} beams): worst mask agreement {worst_agree:.5f} "
          f"(> {CASTER_MIN_AGREE}), worst |dcoord| {worst_dc:.3e} m "
          f"(< {CASTER_COORD_TOL_M}), {n_hits} beams hit on both")
    require(worst_agree > CASTER_MIN_AGREE and worst_dc < CASTER_COORD_TOL_M)
    return dict(agree=worst_agree, dcoord=worst_dc)


def phase_push(grid, geom, pose_np, ranges, cpu):
    """GPU float32 push vs the same push in float64 on the CPU device."""
    import jax
    import jax.numpy as jnp

    from ohm_tsd_slam.grid import push

    d, m = scan(geom, ranges, jnp.float32)
    g32 = jax.jit(lambda g, p, d_, m_: push(g, geom, p, d_, m_))(
        grid, jnp.asarray(pose_np, jnp.float32), d, m)
    t32 = np.asarray(g32.tsd).astype(np.float64)
    w32 = np.asarray(g32.weight).astype(np.float64)
    with jax.enable_x64(True):
        g_in = jax.device_put(jax.tree_util.tree_map(
            lambda a: np.asarray(a).astype(np.float64)
            if np.asarray(a).dtype == np.float32 else np.asarray(a),
            grid), cpu)
        d64, m64 = jax.device_put(scan(geom, ranges, jnp.float64), cpu)
        p64 = jax.device_put(jnp.asarray(pose_np, jnp.float64), cpu)
        g64 = jax.jit(lambda g, p, d_, m_: push(g, geom, p, d_, m_))(
            g_in, p64, d64, m64)
        t64 = np.asarray(g64.tsd)
        w64 = np.asarray(g64.weight)
    same_nan = bool(np.array_equal(np.isnan(t32), np.isnan(t64)))
    written = ~np.isnan(t64)
    diff = np.abs(np.where(written & ~np.isnan(t32), t32 - t64, 0.0))
    cells = np.nonzero(diff > PUSH_TSD_TOL)
    frac = len(cells[0]) / max(int(written.sum()), 1)
    dw = float(np.abs(np.where(np.isnan(w64), 0.0, w32 - w64)).max())
    cs = float(grid.cell_size)
    off_edge = []
    for cy, cx in zip(*cells):
        local = np.linalg.inv(pose_np) @ np.array(
            [(cx + 0.5) * cs, (cy + 0.5) * cs, 1.0])
        bin_f = ((math.atan2(local[1], local[0]) - geom.phi_min)
                 / geom.angular_res + 0.5)
        if abs(bin_f - round(bin_f)) >= PUSH_BIN_EDGE_TOL:
            off_edge.append((int(cy), int(cx)))
    print(f"  push GPU f32 vs CPU f64: NaN pattern identical: {same_nan}; "
          f"{len(cells[0])} of {int(written.sum())} written cells differ "
          f"by > {PUSH_TSD_TOL} ({frac:.2e} < {PUSH_MAX_DIFF_FRAC}), "
          f"{len(off_edge)} of them off a beam-bin boundary (must be 0); "
          f"max |dtsd| {float(diff.max()):.3e}; max |dweight| {dw:.3e} "
          f"(< {PUSH_WEIGHT_TOL})")
    require(same_nan and frac < PUSH_MAX_DIFF_FRAC and not off_edge
            and dw < PUSH_WEIGHT_TOL, off_edge[:10])
    return dict(diff_cells=len(cells[0]), frac=frac, dweight=dw)


def _pose_delta(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dpos = float(np.hypot(*(a[:2, 2] - b[:2, 2])))
    drot = abs(math.atan2(a[1, 0], a[0, 0]) - math.atan2(b[1, 0], b[0, 0]))
    return dpos, min(drot, 2 * math.pi - drot)


def phase_localize(grid, params, pose, data, mask, key, cpu):
    """localize_step on the card vs on the CPU device, same key."""
    import jax

    from ohm_tsd_slam.grid.raycast_fast import extract_segments_jit
    from ohm_tsd_slam.slam.localize import localize_step_jit

    def run(args, T_prereg=None):
        g, p, d, m, k = args
        seg = extract_segments_jit(g)
        r = localize_step_jit(g, p, p, d, m, params, T_prereg=T_prereg,
                              key=k, segments=seg)
        return jax.device_get((r.pose, r.T, r.reg_error, r.rays_dropped))

    args = (grid, pose, data, mask, key)
    gpu = run(args)
    host = run(jax.device_put(args, cpu))
    dpos, drot = _pose_delta(gpu[0], host[0])
    note = ""
    ok = dpos < LOC_POS_TOL_M and drot < LOC_ROT_TOL_RAD
    if not ok and params.mode != 0:
        # the RANSAC winner may differ across backends (ties in f32
        # scores); compare the ICP refinement from the card's seed
        T_pre = gpu[1]
        gpu_f = run(args, T_prereg=T_pre)
        host_f = run(jax.device_put(args, cpu),
                     T_prereg=jax.device_put(T_pre, cpu))
        dpos, drot = _pose_delta(gpu_f[0], host_f[0])
        note = " (RANSAC winner differed; compared ICP from a fixed T_prereg)"
        ok = dpos < LOC_POS_TOL_M and drot < LOC_ROT_TOL_RAD
    print(f"  localize_step mode {params.mode} GPU vs CPU: |dpos| "
          f"{dpos:.3e} m (< {LOC_POS_TOL_M}), |drot| {drot:.3e} rad "
          f"(< {LOC_ROT_TOL_RAD}); reg_error {bool(gpu[2])}/"
          f"{bool(host[2])}; rays_dropped {int(gpu[3])}{note}")
    require(ok and not bool(gpu[2]) and int(gpu[3]) == 0)
    return dict(dpos=dpos, drot=drot, fixed_prereg=bool(note))


def phase_golden():
    """The compiled-C++ golden loops, replayed in float64 on the card."""
    import jax

    gio = _load_golden_io()
    res = {}
    with jax.enable_x64(True):
        for name, fn in (("icp", gio.replay_slam_loop_icp),
                         ("tsd", gio.replay_slam_loop_tsd)):
            ok, dpos, drot, gates = gio.loop_parity(*fn())
            print(f"  golden loop [{name}] f64: gates equal {gates}; max "
                  f"|dpos| {dpos:.3e}, max |drot| {drot:.3e} "
                  f"(< {GOLDEN_TOL})")
            require(ok, (name, dpos, drot, gates))
            res[name] = dict(dpos=dpos, drot=drot)
    return res


# ---------------------------------------------------------------------------
# Phase C: plain-stage times
# ---------------------------------------------------------------------------

def median_wall(fn, *args, reps=TIMED_REPS, warmup=2):
    """Median wall time of fn(*args) to block_until_ready, in seconds."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def phase_times(grid, geom, params, pose, data, mask, key, label,
                reps=TIMED_REPS):
    import jax

    from ohm_tsd_slam.grid import push
    from ohm_tsd_slam.grid.raycast_fast import (
        extract_segments_jit,
        raycast_fast,
    )
    from ohm_tsd_slam.slam.localize import localize_step

    seg = extract_segments_jit(grid)
    params0 = dataclasses.replace(params, mode=0)
    times = {
        "extract_segments": median_wall(extract_segments_jit, grid,
                                        reps=reps),
        "raycast_fast_cached": median_wall(
            jax.jit(lambda g, p, s: raycast_fast(g, geom, p, segments=s)),
            grid, pose, seg, reps=reps),
        "push": median_wall(
            jax.jit(lambda g, p, d, m: push(g, geom, p, d, m)),
            grid, pose, data, mask, reps=reps),
    }
    # mode-3 compile with the in-memory caches dropped: a persistent-
    # cache hit when phase A's node already compiled the same step
    # (a warm process start), a cold compile when no entry was on disk
    args = (grid, pose, pose, data, mask)
    kw = dict(key=key, segments=seg)
    cache = jax.config.jax_compilation_cache_dir

    def n_entries():
        return len(os.listdir(cache)) if cache and os.path.isdir(cache) \
            else 0

    n0 = n_entries()
    jax.clear_caches()
    t0 = time.perf_counter()
    loc3 = jax.jit(localize_step, static_argnames=("params",)).lower(
        *args, params, **kw).compile()
    compile_s = time.perf_counter() - t0
    compile_kind = ("persistent cache off" if not cache
                    else "cold, entry written" if n_entries() > n0
                    else "warm, persistent-cache hit")
    mem = loc3.memory_analysis()
    temp = getattr(mem, "temp_size_in_bytes", None)
    times[f"localize_step_mode{params.mode}"] = median_wall(
        lambda *a: loc3(*a, **kw), *args, reps=reps)
    loc0 = jax.jit(lambda *a: localize_step(*a, params0, **kw))
    times["localize_step_mode0"] = median_wall(loc0, *args, reps=reps)
    for name, t in times.items():
        print(f"  {name}: {t * 1e3:.4f} ms (median of {reps}) [{label}]")
    print(f"  localize_step mode {params.mode} compile: {compile_s:.3f} s "
          f"({compile_kind}); compiled temp buffers "
          f"{temp if temp is None else f'{temp / 2**20:.1f} MiB'} [{label}]")
    return dict(times_s=times, compile_s=compile_s,
                compile_kind=compile_kind, mode3_temp_bytes=temp)


# ---------------------------------------------------------------------------

def check_device():
    """Print the device; None unless the default backend is a GPU."""
    import jax

    from ohm_tsd_slam.utils.compile_cache import enable_persistent_cache

    print("jax.devices():", jax.devices())
    print("card:", card_name_and_limit())
    cache = enable_persistent_cache()
    n_entries = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    print(f"compile cache: {cache} ({n_entries} entries at start)")
    if jax.default_backend() != "gpu":
        return None
    return jax.devices()[0]


def main() -> int:
    import jax

    dev = check_device()
    if dev is None:
        print(json.dumps({"ok": False, "error": "no GPU: default backend "
                          f"is {jax.default_backend()!r}"}))
        return 2

    import jax.numpy as jnp

    from ohm_tsd_slam import native
    from ohm_tsd_slam.config import load_yaml
    from ohm_tsd_slam.slam.localize import LocalizeParams

    card = card_name_and_limit()
    print(f"native channel: {'C++' if native.NATIVE else 'pure Python'}")
    results, failed = {}, []

    def phase(name, fn, *a, **k):
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            results[name] = fn(*a, **k)
            print(f"[{name}] PASS ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            failed.append(name)
            print(f"[{name}] FAIL ({time.perf_counter() - t0:.1f} s)",
                  flush=True)

    phase("A main path", phase_main_path, OUT, label=card)

    cfg = load_yaml(CONFIG)
    log_path = os.path.join(OUT, "scans.npz")
    if not os.path.exists(log_path):      # phase A failed early
        from ohm_tsd_slam.__main__ import main as cli

        cli(["simulate", "--beams", "1081", "--steps", "120", "--config",
             CONFIG, "--out", log_path])
    log = np.load(log_path)
    geom = sim_geom(log, cfg.robots[0].sensor.max_range)
    grid = build_map(cfg.grid, log, geom)
    gt = log["ground_truth"]
    cpu = jax.devices("cpu")[0]
    gw = cfg.grid.size_meters
    params = LocalizeParams.from_config(
        cfg.robots[0].registration, geom, bounds=(0.0, gw, 0.0, gw),
        cell_size=cfg.grid.cellsize)
    k = 33
    data, mask = scan(geom, log["ranges"][k], jnp.float32)
    # start 2 cm / 0.01 rad off the true pose, as a scan-to-map step does
    start = gt_pose((gt[k][0] + 0.02, gt[k][1] - 0.01, gt[k][2] + 0.01),
                    jnp.float32)
    key = jax.random.PRNGKey(7)

    phase("B fast caster vs exact march", phase_caster, grid, geom,
          [gt_pose(gt[i], jnp.float32) for i in (3, 17, 33, 48)])
    phase("B push vs CPU f64", phase_push, grid, geom,
          np.asarray(gt_pose(gt[55], jnp.float32), np.float64),
          log["ranges"][55], cpu)
    for mode in (3, 0):
        phase(f"B localize mode {mode} vs CPU", phase_localize, grid,
              dataclasses.replace(params, mode=mode), start, data, mask,
              key, cpu)
    phase("B golden loops f64", phase_golden)
    phase("C stage times", phase_times, grid, geom, params, start, data,
          mask, key, card)

    stats = dev.memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')} [{card}]")
    with open(os.path.join(OUT, "results.json"), "w") as f:
        json.dump(dict(card=card, results=results, failed=failed,
                       peak_bytes_in_use=stats.get("peak_bytes_in_use")),
                  f, indent=1, default=str)
    print("card:", card)
    if failed:
        print(json.dumps({"ok": False, "failed": failed}))
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
