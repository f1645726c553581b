"""RANSAC global matchers as fixed-shape vmapped trial batches.

Redesign of the reference's ransacMatching family
(src/obvision/registration/ransacMatching/):

  * RandomMatching base machinery — PCA normals over beam windows,
    control-set picking, subsampling (RandomMatching.cpp:41-183)
  * RandomNormalMatching "EXP" mode  (RandomNormalMatching.cpp:67-395)
  * PDFMatching "PDF" mode           (PDFMatching.cpp:47-430,435-487)
  * TSD_PDFMatching "TSD" mode       (TSD_PDFMatching.cpp:30-283)

Redesign decisions (vs the reference's OpenMP trial loops):

  * The reference draws random model indices *without replacement* under
    an omp critical (`rand()` + erase).  Here the whole trial set is one
    draw: a random strict ranking of the valid model indices
    (uniform-noise argsort), taking the first `trials` — identical
    statistics, no critical section, deterministic under a PRNG key.
  * Every (trial, scene-beam-offset) pair inside the ±span polar window
    becomes one fixed-shape *candidate*; all candidates are scored by
    dense masked linear algebra (the per-candidate 1-NN over model
    points is a dense [C, M] distance computation, replacing the
    per-query FLANN kd-tree).  Candidates are processed in chunks with
    `lax.map` to bound memory.
  * The reference updates its best-so-far under `omp critical` with an
    epsilon tie rule (RandomNormalMatching.cpp:344-360), which makes the
    winner depend on thread interleaving.  Here the winner is the global
    lexicographic maximum of (quantized ratio, match count, -error) —
    deterministic, and always one the reference could have produced.
  * Scan-probability products (PDF/TSD scoring) run in log space: a
    product of up to 180 per-point probabilities underflows float32;
    log-sums compare identically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.config import BeamModelConfig, RansacConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid.interpolate import interpolate_bilinear
from ohm_tsd_slam.grid.state import INTERPOLATE_SUCCESS, TsdGrid

_BIG = 1e9
_PHI_INVALID = -1e6      # RandomMatching::calcPhi invalid marker (:166)


# ---------------------------------------------------------------------------
# RandomMatching base machinery
# ---------------------------------------------------------------------------

def pca_normals(points: jnp.ndarray, mask: jnp.ndarray,
                search_radius: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-beam normals from PCA over a ±search_radius window.

    Replicates RandomMatching::calcNormals (RandomMatching.cpp:77-146):
    window j ∈ [-r, r); needs >3 valid points; principal axes from the
    SVD of the centered window (extent = max−min of projections, cf.
    Matrix::pcaAnalysis, gsl/Matrix.cpp:227-326); reject blob-like
    neighborhoods where extent²(major)/extent²(minor) < 4 (unless the
    minor extent² ≤ 1e-6, i.e. collinear); the normal is the minor axis
    oriented toward the sensor (dot(point, n) < 0).

    Returns (normals [N,2], mask_out [N]).
    """
    n = points.shape[0]
    r = search_radius
    dtype = points.dtype
    offs = jnp.arange(-r, r)                       # j in [-r, r)
    idx = jnp.arange(n)[:, None] + offs[None, :]   # [N, W]
    inb = (idx >= 0) & (idx < n)
    idx_c = jnp.clip(idx, 0, n - 1)
    wmask = mask[idx_c] & inb                      # [N, W]
    wpts = points[idx_c]                           # [N, W, 2]

    cnt = jnp.sum(wmask, axis=1)
    denom = jnp.maximum(cnt, 1).astype(dtype)[:, None]
    wm = wmask[..., None].astype(dtype)
    mean = jnp.sum(wpts * wm, axis=1) / denom      # [N, 2]
    d = (wpts - mean[:, None, :]) * wm             # centered, zeroed invalid

    cxx = jnp.sum(d[..., 0] * d[..., 0], axis=1)
    cxy = jnp.sum(d[..., 0] * d[..., 1], axis=1)
    cyy = jnp.sum(d[..., 1] * d[..., 1], axis=1)

    # closed-form principal direction of the 2x2 scatter matrix
    alpha = 0.5 * jnp.arctan2(2.0 * cxy, cxx - cyy)
    v1 = jnp.stack([jnp.cos(alpha), jnp.sin(alpha)], axis=-1)   # major
    v2 = jnp.stack([-v1[:, 1], v1[:, 0]], axis=-1)              # minor

    def extent(v):
        proj = jnp.sum(d * v[:, None, :], axis=-1)              # [N, W]
        pmax = jnp.max(jnp.where(wmask, proj, -_BIG), axis=1)
        pmin = jnp.min(jnp.where(wmask, proj, _BIG), axis=1)
        return pmax - pmin

    ext1 = extent(v1)
    ext2 = extent(v2)
    len_long2 = ext1 * ext1
    len_short2 = ext2 * ext2
    blob = (len_short2 > 1e-6) & (len_long2 / jnp.maximum(len_short2, 1e-30)
                                  < 4.0)

    # orient toward the sensor (RandomMatching.cpp:125-135)
    sign = jnp.where(jnp.sum(points * v2, axis=1) < 0.0, 1.0, -1.0)
    normals = v2 * sign[:, None]

    interior = (jnp.arange(n) >= r) & (jnp.arange(n) < n - r)
    mask_out = mask & interior & (cnt > 3) & ~blob
    return normals, mask_out


def calc_phi(normals: jnp.ndarray,
             mask: Optional[jnp.ndarray]) -> jnp.ndarray:
    """RandomMatching::calcPhi (RandomMatching.cpp:148-169)."""
    phi = jnp.arctan2(normals[:, 1], normals[:, 0])
    if mask is None:
        return phi
    return jnp.where(mask, phi, _PHI_INVALID)


def subsample_mask(key: jax.Array, mask: jnp.ndarray,
                   target_points: float = 180.0) -> jnp.ndarray:
    """Random scene subsampling to ~target_points survivors.

    RandomNormalMatching/PDF/TSD all call
    subsampleMask(maskSpca, size, 180/validPoints) when that probability
    is < 0.99 (RandomNormalMatching.cpp:131-135,
    RandomMatching.cpp:171-183)."""
    valid = jnp.sum(mask)
    prob = target_points / jnp.maximum(valid, 1).astype(jnp.float32)
    keep = jax.random.uniform(key, mask.shape) < prob
    return jnp.where(prob < 0.99, mask & keep, mask)


def random_valid_subset(key: jax.Array, mask: jnp.ndarray,
                        k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """First k of a uniformly random strict ranking of the valid indices
    (= sampling k valid indices without replacement; the functional
    equivalent of pickControlSet's rand()/erase loop,
    RandomMatching.cpp:52-75).

    Returns (indices [k], valid [k]); `valid` is False past the number
    of available valid indices.
    """
    score = jax.random.uniform(key, mask.shape) + jnp.where(mask, 0.0, _BIG)
    order = jnp.argsort(score)
    idx = order[:k]
    return idx.astype(jnp.int32), mask[idx]


# ---------------------------------------------------------------------------
# Static parameters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RansacParams:
    """Static matcher parameters (hashable; jit-safe).

    Mirrors the ThreadLocalize ctor wiring (ThreadLocalize.cpp:104-117,
    :148-187): trials, epsThresh, sizeControlSet, phiMax, plus the scan
    resolution that the reference passes per call.
    """

    trials: int = 100                   # node "trials" (ThreadLocalize.cpp:105)
    eps_thresh: float = 0.15
    size_control_set: int = 140         # node "sizeControlSet" (:106)
    phi_max: float = math.radians(30.0)
    resolution: float = math.radians(0.25)
    pca_search_range: int = 10          # _pcaSearchRange (fixed in ctor)
    scale_orientation: float = 0.33     # _scaleOrientation
    zrand_tsd: float = 0.25             # node "zrand" -> TSD ctor (ThreadLocalize.cpp:190)
    trans_max: float = 0.25             # transMax gate (TwinPointMatching.cpp:97,278)
    # candidates scored per lax.map step.  The 1024 default ASSUMES the
    # backend fuses the [chunk, C, N] broadcast producers (d2/diff,
    # payload tables, iota) into the variadic lax.reduce so nothing
    # [chunk, C, N]-sized is materialized — true for the current
    # CPU XLA pipeline (the CPU test suite runs EXP/PDF/TSD matchers at
    # this default, so a materialization regression shows up as an
    # obvious slowdown/memory spike there).  If a backend materializes
    # them, per-map-step intermediates grow ~8x (hundreds of MB for
    # large model scans) — drop to 128 in that case.
    chunk: int = 1024

    @property
    def span(self) -> int:
        """Polar search radius in beams (RandomNormalMatching.cpp:196-206)."""
        phi = min(self.phi_max, math.pi * 0.5)
        return max(1, int(math.floor(phi / self.resolution)))

    @property
    def scale_distance(self) -> float:
        return 1.0 / (self.eps_thresh * self.eps_thresh)

    @staticmethod
    def from_config(cfg: RansacConfig, resolution: float) -> "RansacParams":
        return RansacParams(
            trials=cfg.trials,
            eps_thresh=cfg.eps_thresh,
            size_control_set=cfg.size_control_set,
            phi_max=math.radians(cfg.phi_max_deg),
            resolution=resolution,
        )


class RansacInject(NamedTuple):
    """Deterministic draw injection for golden parity tests.

    The reference matchers consume libc rand() for the scene subsample,
    the control-set pick and the trial draws
    (RandomMatching.cpp:52-183, RandomNormalMatching.cpp:221-238); the
    golden harness intercepts rand with a replayable LCG
    (golden/shim/detrand.h) and tests/golden_io.py replays the identical
    sequence to produce these fields, so the JAX matchers score the
    SAME candidate set as the compiled reference."""

    sub_mask: Optional[jnp.ndarray] = None     # [N] post-subsample mask
    ctrl_idx: Optional[jnp.ndarray] = None     # [C] control indices
    ctrl_valid: Optional[jnp.ndarray] = None   # [C]
    trial_idx: Optional[jnp.ndarray] = None    # [T] model trial indices
    trial_valid: Optional[jnp.ndarray] = None  # [T]


class _Prep(NamedTuple):
    """Shared trial/candidate preprocessing for all three matchers."""

    phi_cand: jnp.ndarray      # [K] candidate rotation
    t_cand: jnp.ndarray        # [K, 2] candidate translation
    cand_valid: jnp.ndarray    # [K]
    ctrl: jnp.ndarray          # [C, 2] control points (scene frame)
    ctrl_mask: jnp.ndarray     # [C]
    ctrl_phi: jnp.ndarray      # [C] control normals' orientation
    phi_m: jnp.ndarray         # [N] model normals' orientation
    mask_m: jnp.ndarray        # [N] model validity after PCA
    theta_min: jnp.ndarray     # model frustum bounds
    theta_max: jnp.ndarray
    ok: jnp.ndarray            # >=3 valid in both clouds
    t_idx: jnp.ndarray         # [T] drawn trial model indices


def _prepare(key: jax.Array, model: jnp.ndarray, mask_m: jnp.ndarray,
             scene: jnp.ndarray, mask_s: jnp.ndarray,
             p: RansacParams, inject: RansacInject = None) -> _Prep:
    """Everything before the trial loop, shared verbatim by
    RandomNormalMatching.cpp:96-206 / PDFMatching.cpp:67-175 /
    TSD_PDFMatching.cpp:60-170."""
    r = p.pca_search_range // 2
    k_sub, k_trial, k_ctrl = jax.random.split(key, 3)

    # model: PCA normals + orientation
    nm, mask_mp = pca_normals(model, mask_m, r)
    phi_m = calc_phi(nm, mask_mp)

    # scene: subsample to ~180 points, then PCA normals.  The reference
    # passes maskIn=maskS (pre-subsample) to calcNormals while maskOut
    # starts from the subsampled copy (RandomNormalMatching.cpp:131-137):
    # normals use full-mask windows, validity intersects the subsample.
    if inject is not None and inject.sub_mask is not None:
        mask_s_sub = inject.sub_mask
    else:
        mask_s_sub = subsample_mask(k_sub, mask_s)
    ns_full, mask_sp_full = pca_normals(scene, mask_s, r)
    mask_sp = mask_sp_full & mask_s_sub
    phi_s = calc_phi(ns_full, mask_sp)

    # control set: random valid scene indices (uses the *subsampled* PCA
    # mask, RandomNormalMatching.cpp:141-152)
    if inject is not None and inject.ctrl_idx is not None:
        c_idx, c_mask = inject.ctrl_idx, inject.ctrl_valid
    else:
        c_idx, c_mask = random_valid_subset(k_ctrl, mask_sp,
                                            p.size_control_set)
    ctrl = scene[c_idx]
    ctrl_n = ns_full[c_idx]
    ctrl_phi = calc_phi(ctrl_n, None)      # calcPhi(NControl, NULL, ...)

    # model frustum from first/last valid model point
    n = model.shape[0]
    first = jnp.argmax(mask_mp)
    last = n - 1 - jnp.argmax(mask_mp[::-1])
    theta_min = jnp.arctan2(model[first, 1], model[first, 0])
    theta_max = jnp.arctan2(model[last, 1], model[last, 0])

    ok = (jnp.sum(mask_mp) >= 3) & (jnp.sum(mask_sp) >= 3)

    # trials: random valid model indices without replacement
    if inject is not None and inject.trial_idx is not None:
        t_idx, t_valid = inject.trial_idx, inject.trial_valid
    else:
        t_idx, t_valid = random_valid_subset(k_trial, mask_mp, p.trials)

    # candidates: every scene beam within ±span of the trial beam
    span = p.span
    phi_max = min(p.phi_max, math.pi * 0.5)
    offs = jnp.arange(-span, span)
    i_s = t_idx[:, None] + offs[None, :]               # [T, W]
    in_rng = (i_s >= r) & (i_s < n - r)                # iMin/iMax clamp
    i_c = jnp.clip(i_s, 0, n - 1)

    dphi = phi_m[t_idx][:, None] - phi_s[i_c]
    dphi = jnp.where(dphi > jnp.pi, dphi - 2.0 * jnp.pi, dphi)
    dphi = jnp.where(dphi < -jnp.pi, dphi + 2.0 * jnp.pi, dphi)
    cand_valid = (t_valid[:, None] & in_rng & mask_sp[i_c]
                  & (jnp.abs(dphi) < phi_max))

    # T = R(dphi); t = M[idx] - R @ S[i]  (RandomNormalMatching.cpp:253-263)
    c, s = jnp.cos(dphi), jnp.sin(dphi)
    sx = scene[i_c][..., 0]
    sy = scene[i_c][..., 1]
    mx = model[t_idx][:, None, 0]
    my = model[t_idx][:, None, 1]
    tx = mx - (c * sx - s * sy)
    ty = my - (s * sx + c * sy)

    return _Prep(
        phi_cand=dphi.reshape(-1),
        t_cand=jnp.stack([tx, ty], axis=-1).reshape(-1, 2),
        cand_valid=cand_valid.reshape(-1),
        ctrl=ctrl, ctrl_mask=c_mask, ctrl_phi=ctrl_phi,
        phi_m=phi_m, mask_m=mask_mp,
        theta_min=theta_min, theta_max=theta_max, ok=ok, t_idx=t_idx)


def _reduce_min_payload(primary, payloads, axis):
    """min over `axis` of `primary`, carrying `payloads` values at the
    (first) minimum — one fused variadic reduce instead of
    argmin + take_along_axis + table gathers over the [k, C, N]
    search space.  Payloads are broadcast against `primary`; ties
    resolve to the lowest index, matching jnp.argmin."""
    idx = jax.lax.broadcasted_iota(jnp.int32, primary.shape, axis)
    dtype = primary.dtype
    init = ((jnp.asarray(jnp.inf, dtype),)
            + tuple(jnp.asarray(0, p.dtype) for p in payloads)
            + (jnp.asarray(primary.shape[axis], jnp.int32),))
    ops = ((primary,)
           + tuple(jnp.broadcast_to(p, primary.shape) for p in payloads)
           + (idx,))

    def comp(a, b):
        better = (b[0] < a[0]) | ((b[0] == a[0]) & (b[-1] < a[-1]))
        return tuple(jnp.where(better, y, x) for x, y in zip(a, b))

    out = jax.lax.reduce(ops, init, comp, (axis,))
    return out[0], out[1:-1]


def _transform_ctrl(prep: _Prep, phi: jnp.ndarray, t: jnp.ndarray):
    """Apply candidate transforms to the control set.

    phi: [k]; t: [k, 2] -> [k, C, 2]."""
    c, s = jnp.cos(phi), jnp.sin(phi)
    x = prep.ctrl[None, :, 0]
    y = prep.ctrl[None, :, 1]
    xs = c[:, None] * x - s[:, None] * y + t[:, 0:1]
    ys = s[:, None] * x + c[:, None] * y + t[:, 1:2]
    return jnp.stack([xs, ys], axis=-1)


def _chunked_scores(prep: _Prep, p: RansacParams, score_fn):
    """Score all candidates in fixed-size chunks -> [K, n_scores]."""
    K = prep.phi_cand.shape[0]
    pad = (-K) % p.chunk
    phi = jnp.pad(prep.phi_cand, (0, pad))
    t = jnp.pad(prep.t_cand, ((0, pad), (0, 0)))
    valid = jnp.pad(prep.cand_valid, (0, pad))
    phi = phi.reshape(-1, p.chunk)
    t = t.reshape(-1, p.chunk, 2)
    valid = valid.reshape(-1, p.chunk)
    out = jax.lax.map(lambda a: score_fn(*a), (phi, t, valid))
    return jax.tree.map(lambda x: x.reshape(-1, *x.shape[2:])[:K], out)


def _lex_best(keys, phis, ts, ok) -> jnp.ndarray:
    """Deterministic winner: lexicographic max over candidate score keys
    (primary first); returns the (3,3) transform, identity when nothing
    qualifies (the reference's TBest identity fallback)."""
    dtype = ts.dtype
    order = jnp.lexsort(tuple(-k for k in reversed(keys)))
    b = order[0]
    qualified = keys[0][b] > -_BIG * 0.5
    phi = phis[b]
    t = ts[b]
    c, s = jnp.cos(phi), jnp.sin(phi)
    T = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                  dtype)
    T_cand = jnp.stack([
        jnp.stack([c, -s, t[0]]),
        jnp.stack([s, c, t[1]]),
        jnp.array([0.0, 0.0, 1.0], dtype)])
    return jnp.where(ok & qualified, T_cand, T)


# ---------------------------------------------------------------------------
# RandomNormalMatching — registration mode EXP (1)
# ---------------------------------------------------------------------------

def match_normal(key: jax.Array, model: jnp.ndarray, mask_model: jnp.ndarray,
                 scene: jnp.ndarray, mask_scene: jnp.ndarray,
                 params: RansacParams, inject: RansacInject = None,
                 return_scores: bool = False):
    """RandomNormalMatching::match (RandomNormalMatching.cpp:67-395).

    Per candidate: transform the control set, clip to the model frustum,
    1-NN into the valid model (dense masked distance computation
    instead of FLANN), error = NN-distance·(1/ε²) + normal-consensus
    (1−cos Δφ)/2·0.33; count err<1 matches; gate cntMatch > |C|/3;
    winner by (ratio, cnt, −errSum) (:298-360).
    """
    prep = _prepare(key, model, mask_model, scene, mask_scene, params,
                    inject)
    dtype = scene.dtype
    mvalid = prep.mask_m
    model_masked_sq = jnp.sum(model * model, axis=1) + jnp.where(
        mvalid, 0.0, _BIG)
    cnt_thresh = jnp.sum(prep.ctrl_mask) // 3       # cntMatchThresh
    # the winning model point's normal enters only through
    # cos(phi_m[nn] - beta) = cos(phi_m[nn])cos(beta) + sin(phi_m[nn])
    # sin(beta): carry (cos, sin) tables through the NN reduce instead
    # of gathering phi_m[nn]
    cosm = jnp.cos(prep.phi_m)[None, None, :]
    sinm = jnp.sin(prep.phi_m)[None, None, :]
    mx = model[:, 0][None, None, :]
    my = model[:, 1][None, None, :]

    def score_chunk(phi, t, valid):
        st = _transform_ctrl(prep, phi, t)                    # [k, C, 2]
        theta = jnp.arctan2(st[..., 1], st[..., 0])
        in_fov = ((theta >= prep.theta_min) & (theta <= prep.theta_max)
                  & prep.ctrl_mask[None, :])
        max_cnt = jnp.sum(in_fov, axis=1)

        # 1-NN into valid model: d2 = |q|^2 + |m|^2 - 2 q.m, computed as
        # broadcasts so the whole [k, C, N] search fuses into one
        # variadic reduce (nothing [k, C, N]-sized ever hits HBM)
        q2 = jnp.sum(st * st, axis=-1)                        # [k, C]
        d2 = (q2[..., None] + model_masked_sq[None, None, :]
              - 2.0 * (st[..., 0:1] * mx + st[..., 1:2] * my))
        d2min, (cos_nn, sin_nn) = _reduce_min_payload(
            d2, (cosm, sinm), axis=2)
        d2min = jnp.maximum(d2min, 0.0)

        # normal consensus (RandomNormalMatching.cpp:310-318)
        beta = prep.ctrl_phi[None, :] + phi[:, None]
        ncons = (1.0 - (cos_nn * jnp.cos(beta)
                        + sin_nn * jnp.sin(beta))) / 2.0
        err = (d2min * params.scale_distance
               + ncons * params.scale_orientation)
        err_sum = jnp.sum(jnp.where(in_fov, err, 0.0), axis=1)
        cnt = jnp.sum(in_fov & (err < 1.0), axis=1)

        ratio = cnt.astype(dtype) / jnp.maximum(max_cnt, 1).astype(dtype)
        good = valid & (cnt > cnt_thresh) & (max_cnt > 0)
        ratio = jnp.where(good, ratio, -_BIG)
        return ratio, cnt, err_sum, max_cnt

    ratio, cnt, err_sum, max_cnt = _chunked_scores(prep, params,
                                                   score_chunk)
    # quantize ratio by the reference's equalThres=1e-5 so the
    # similarity tie-break (equal ratio -> lower errSum) applies
    ratio_q = jnp.round(ratio * 1e5)
    T = _lex_best((ratio_q, cnt.astype(ratio.dtype), -err_sum),
                  prep.phi_cand, prep.t_cand, prep.ok)
    if return_scores:
        return T, dict(prep=prep, ratio=ratio, cnt=cnt,
                       err_sum=err_sum, max_cnt=max_cnt,
                       cnt_thresh=cnt_thresh)
    return T


# ---------------------------------------------------------------------------
# PDFMatching — registration mode PDF (2)
# ---------------------------------------------------------------------------

def beam_model_log_prob(m: jnp.ndarray, s: jnp.ndarray,
                        bm: BeamModelConfig) -> jnp.ndarray:
    """log of PDFMatching::probabilityOfTwoSingleScans
    (PDFMatching.cpp:435-487): zhit·N(m−s;σhit) + zshort·Exp + zmax·[s≥max]
    + zrand/rangemax + zphi·N(s;σphi)."""
    sigphit = 1.0 / (math.sqrt(2.0 * math.pi) * bm.sig_hit)
    phit = jnp.where(s < bm.max_range,
                     sigphit * jnp.exp(-0.5 * (m - s) ** 2
                                       / (bm.sig_hit ** 2)), 0.0)
    # replicated quirk: the reference scales pphi by _sigphi itself, not
    # the Gaussian normalizer _sigpphi it also computes (PDFMatching.cpp:452)
    pphi = bm.sig_phi * jnp.exp(-0.5 * s * s / (bm.sig_phi * bm.sig_phi))
    n = 1.0 / (1.0 - jnp.exp(-bm.lam_short * jnp.maximum(m, 1e-9)))
    pshort = jnp.where(s < m, n * bm.lam_short * jnp.exp(-bm.lam_short * s),
                       0.0)
    pmax = (s >= bm.max_range).astype(s.dtype)
    prand = jnp.where(s < bm.max_range, 1.0 / bm.max_range, 0.0)
    p = (bm.zhit * phit + bm.zshort * pshort + bm.zmax * pmax
         + bm.zrand * prand + bm.zphi * pphi)
    return jnp.log(jnp.maximum(p, 1e-30)) + jnp.where(p > 0, 0.0, -_BIG)


def match_pdf(key: jax.Array, model: jnp.ndarray, mask_model: jnp.ndarray,
              scene: jnp.ndarray, mask_scene: jnp.ndarray,
              params: RansacParams, bm: BeamModelConfig,
              inject: RansacInject = None, return_scores: bool = False):
    """PDFMatching::match, MATCH_SCENE_ON_MODEL branch
    (PDFMatching.cpp:47-430): per candidate, each transformed control
    point finds the model point of nearest polar angle; per-point
    beam-model probabilities multiply into the measurement probability;
    gate: fieldOfViewCount (angle diff < maxAngleDiff) must exceed
    |C|·percentagePointsInC; winner = highest probability.
    """
    prep = _prepare(key, model, mask_model, scene, mask_scene, params,
                    inject)
    angle_thresh = math.radians(bm.max_angle_diff_deg)

    m_angle = jnp.arctan2(model[:, 1], model[:, 0])
    m_angle = jnp.where(prep.mask_m, m_angle, _BIG)     # excluded from argmin
    m_dist = jnp.linalg.norm(model, axis=1)
    c_gate = (jnp.sum(prep.ctrl_mask).astype(scene.dtype)
              * bm.percentage_points_in_c)

    def score_chunk(phi, t, valid):
        st = _transform_ctrl(prep, phi, t)                     # [k, C, 2]
        angle = jnp.arctan2(st[..., 1], st[..., 0])
        dist = jnp.linalg.norm(st, axis=-1)
        diff = jnp.abs(angle[..., None] - m_angle[None, None, :])
        # fused nearest-angle search carrying the winner's range (see
        # _reduce_min_payload instead of argmin + m_dist[nn] gathers)
        min_diff, (mdist_nn,) = _reduce_min_payload(
            diff, (m_dist[None, None, :],), axis=2)
        fov_cnt = jnp.sum((min_diff < angle_thresh) & prep.ctrl_mask[None, :],
                          axis=1)
        logp = beam_model_log_prob(mdist_nn, dist, bm)
        logp_sum = jnp.sum(jnp.where(prep.ctrl_mask[None, :], logp, 0.0),
                           axis=1)
        good = valid & (fov_cnt.astype(logp_sum.dtype) > c_gate)
        return jnp.where(good, logp_sum, -_BIG), logp_sum, fov_cnt

    logp, logp_raw, fov_cnt = _chunked_scores(prep, params, score_chunk)
    T = _lex_best((logp,), prep.phi_cand, prep.t_cand, prep.ok)
    if return_scores:
        return T, dict(prep=prep, logp=logp, logp_raw=logp_raw,
                       fov_cnt=fov_cnt, c_gate=c_gate)
    return T


# ---------------------------------------------------------------------------
# TSD_PDFMatching — registration mode TSD (3)
# ---------------------------------------------------------------------------

def match_tsd(key: jax.Array, grid: TsdGrid, sensor_pose: jnp.ndarray,
              model: jnp.ndarray, mask_model: jnp.ndarray,
              scene: jnp.ndarray, mask_scene: jnp.ndarray,
              params: RansacParams, inject: RansacInject = None,
              return_scores: bool = False, logp_sum_fn=None):
    """TSD_PDFMatching::match (TSD_PDFMatching.cpp:30-283): candidates
    are scored directly against the map — transform the control set into
    the map frame (TMap = TSensor·T), read the TSD field bilinearly, and
    multiply per-point likelihoods (1 − (1−zrand)·|tsd|), zrand on
    interpolation misses (:223-251).  Winner = highest probability.

    `logp_sum_fn(world [k,C,2], ctrl_mask [C]) -> [k]`, when given,
    replaces the grid taps + masked sum (grid may then be None) — the
    hook the row-sharded path plugs a shard-local tap evaluation into
    (parallel/shard_matchers.py).
    """
    prep = _prepare(key, model, mask_model, scene, mask_scene, params,
                    inject)
    zrand = params.zrand_tsd
    log_zrand = math.log(zrand)

    def score_chunk(phi, t, valid):
        st = _transform_ctrl(prep, phi, t)                     # [k, C, 2]
        world = se2.transform_points(sensor_pose, st)
        if logp_sum_fn is not None:
            logp_sum = logp_sum_fn(world, prep.ctrl_mask)
            return jnp.where(valid, logp_sum, -_BIG), logp_sum
        tsd, code = interpolate_bilinear(grid, world)
        hit = code == INTERPOLATE_SUCCESS
        logp = jnp.where(
            hit,
            jnp.log(jnp.maximum(1.0 - (1.0 - zrand) * jnp.abs(tsd), 1e-30)),
            log_zrand)
        logp_sum = jnp.sum(jnp.where(prep.ctrl_mask[None, :], logp, 0.0),
                           axis=1)
        return jnp.where(valid, logp_sum, -_BIG), logp_sum

    logp, logp_raw = _chunked_scores(prep, params, score_chunk)
    T = _lex_best((logp,), prep.phi_cand, prep.t_cand, prep.ok)
    if return_scores:
        return T, dict(prep=prep, logp=logp, logp_raw=logp_raw)
    return T
