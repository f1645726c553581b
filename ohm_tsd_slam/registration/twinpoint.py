"""Two-point RANSAC matcher as fixed-shape vmapped candidates.

Redesign of TwinPointMatching
(src/obvision/registration/ransacMatching/TwinPointMatching.cpp):

  1) pick a random valid model point idx1 and a second valid point idx2
     3°-10° to its right (offsets measured in the *valid-index list*,
     TwinPointMatching.cpp:183-192);
  2) for every scene beam i in the ±span polar window of idx1, find the
     scene beam i2 in [i+minDist, i+maxDist) whose intra-distance best
     matches |M[idx2]−M[idx1]| (the createLutIntraDistance LUT,
     :59-86, :221-247);
  3) rotation from the segment directions, translation from the
     centroids, gated by transMax (:250-284);
  4) consensus: 1-NN of the transformed control set into the valid
     model with rotation-clipping of both scene and model indices
     (:288-338), rated by (match ratio, count, −error) (:349-366).

Redesign: the intra-distance LUT becomes a dense [S, maxDist] rolled
difference array; the per-trial scan over scene beams becomes a
[trials, 2·span] candidate grid; FLANN 1-NN becomes a chunked masked
distance computation; the omp-critical best-update becomes a
deterministic lexicographic argmax (see registration/ransac.py notes).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.registration.ransac import (
    _BIG,
    RansacParams,
    _lex_best,
    random_valid_subset,
)

MIN_VALID_POINTS = 10   # TwinPointMatching.cpp:88


class TwinInject:
    """Deterministic draw injection for golden parity (cf.
    ransac.RansacInject): control indices plus per-trial valid-rank
    pairs replayed from the reference's rand() stream
    (TwinPointMatching.cpp:184-191, golden_io.replay_twin)."""

    def __init__(self, ctrl_idx, ctrl_valid, rank1, rank2, trial_valid):
        self.ctrl_idx = ctrl_idx
        self.ctrl_valid = ctrl_valid
        self.rank1 = rank1
        self.rank2 = rank2
        self.trial_valid = trial_valid


def _intra_distance_lut(scene: jnp.ndarray, mask: jnp.ndarray,
                        min_d: int, max_d: int):
    """Squared distances |S[i+d] − S[i]|² for d ∈ [min_d, max_d).

    Equivalent to createLutIntraDistance (TwinPointMatching.cpp:59-86)
    restricted to the offsets the search actually reads; invalid
    endpoints become +BIG.  Returns [S, max_d−min_d]."""
    n = scene.shape[0]
    offs = jnp.arange(min_d, max_d)
    idx2 = jnp.arange(n)[:, None] + offs[None, :]
    inb = idx2 < n
    idx2c = jnp.clip(idx2, 0, n - 1)
    d = scene[idx2c] - scene[:, None, :]
    dist2 = jnp.sum(d * d, axis=-1)
    ok = mask[:, None] & mask[idx2c] & inb
    return jnp.where(ok, dist2, _BIG), idx2c


def match_twinpoint(key: jax.Array, model: jnp.ndarray,
                    mask_model: jnp.ndarray, scene: jnp.ndarray,
                    mask_scene: jnp.ndarray,
                    params: RansacParams,
                    inject: TwinInject = None,
                    return_scores: bool = False) -> jnp.ndarray:
    """TwinPointMatching::match (TwinPointMatching.cpp:88-389)."""
    n = model.shape[0]
    dtype = scene.dtype
    res_deg = math.degrees(params.resolution)
    max_d = max(2, int(10.0 / res_deg))       # maxDist2ndSample (:152)
    min_d = max(1, int(3.0 / res_deg))        # minDist2ndSample (:153)
    span = params.span
    phi_max = min(params.phi_max, math.pi * 0.5)
    eps_sqr = params.eps_thresh * params.eps_thresh
    trans_max_sqr = params.trans_max * params.trans_max

    k_trial, k_pair, k_ctrl = jax.random.split(key, 3)

    n_mvalid = jnp.sum(mask_model)
    n_svalid = jnp.sum(mask_scene)
    ok = (n_mvalid >= MIN_VALID_POINTS) & (n_svalid >= MIN_VALID_POINTS)

    # valid model indices in beam order (rank array: position of each
    # valid index in idxMValid)
    order = jnp.cumsum(mask_model) - 1                      # rank per beam
    # idxMValid as a dense array: for rank r, the beam index
    beam_of_rank = jnp.argsort(jnp.where(mask_model, order, _BIG))[:n]

    # trials: randIdx uniform in [0, |valid|-1-minDist)
    if inject is not None:
        rank1 = jnp.asarray(inject.rank1, jnp.int32)
        rank2 = jnp.asarray(inject.rank2, jnp.int32)
        trial_ok = jnp.asarray(inject.trial_valid) & ok
    else:
        u1 = jax.random.uniform(k_trial, (params.trials,))
        hi1 = jnp.maximum(n_mvalid - 1 - min_d, 1).astype(dtype)
        rank1 = jnp.floor(u1 * hi1).astype(jnp.int32)
        # second sample: rank1 + minDist + rand() % (remaining - minDist)
        remaining = jnp.minimum(n_mvalid - rank1 - 1, max_d)
        u2 = jax.random.uniform(k_pair, (params.trials,))
        width = jnp.maximum(remaining - min_d, 1).astype(dtype)
        rank2 = rank1 + min_d + jnp.floor(u2 * width).astype(jnp.int32)
        trial_ok = (rank2 < n_mvalid) & (rank1 >= 0) & ok
    idx1 = beam_of_rank[jnp.clip(rank1, 0, n - 1)]
    idx2 = beam_of_rank[jnp.clip(rank2, 0, n - 1)]

    v_m = model[idx2] - model[idx1]                         # [T, 2]
    c_m = 0.5 * (model[idx1] + model[idx2])
    dist_m = jnp.sum(v_m * v_m, axis=-1)
    phi_m = jnp.arctan2(v_m[:, 1], v_m[:, 0])

    # control set from raw scene validity (TwinPointMatching.cpp:144-146)
    if inject is not None:
        c_idx = jnp.asarray(inject.ctrl_idx, jnp.int32)
        c_mask = jnp.asarray(inject.ctrl_valid)
    else:
        c_idx, c_mask = random_valid_subset(k_ctrl, mask_scene,
                                            params.size_control_set)
    ctrl = scene[c_idx]

    # scene pair search: per (trial, window beam i), best i2 by
    # |distS − distM|
    lut, lut_idx2 = _intra_distance_lut(scene, mask_scene, min_d, max_d)

    offs = jnp.arange(-span, span)
    i_s = idx1[:, None] + offs[None, :]                     # [T, W]
    in_rng = (i_s >= 0) & (i_s < n)
    i_c = jnp.clip(i_s, 0, n - 1)

    diff = jnp.abs(lut[i_c] - dist_m[:, None, None])        # [T, W, D]
    best_d = jnp.argmin(diff, axis=-1)
    best_diff = jnp.take_along_axis(diff, best_d[..., None], -1)[..., 0]
    i2_best = jnp.take_along_axis(lut_idx2[i_c], best_d[..., None],
                                  -1)[..., 0]               # [T, W]

    pair_ok = (trial_ok[:, None] & in_rng & mask_scene[i_c]
               & (best_diff < eps_sqr))

    # rotation + translation from the two segments (:249-277)
    s1 = scene[i_c]                                         # [T, W, 2]
    s2 = scene[i2_best]
    v_s = s2 - s1
    phi_s = jnp.arctan2(v_s[..., 1], v_s[..., 0])
    phi = phi_m[:, None] - phi_s
    pair_ok = pair_ok & (jnp.abs(phi) < phi_max)

    c_s = 0.5 * (s1 + s2)
    cphi, sphi = jnp.cos(phi), jnp.sin(phi)
    tx = c_m[:, None, 0] - (cphi * c_s[..., 0] - sphi * c_s[..., 1])
    ty = c_m[:, None, 1] - (sphi * c_s[..., 0] + cphi * c_s[..., 1])
    pair_ok = pair_ok & (tx * tx + ty * ty <= trans_max_sqr)

    clipped_beams = (phi / params.resolution).astype(jnp.int32)

    # flatten candidates
    K = params.trials * 2 * span
    phi_f = phi.reshape(-1)
    t_f = jnp.stack([tx, ty], -1).reshape(-1, 2)
    ok_f = pair_ok.reshape(-1)
    clip_f = clipped_beams.reshape(-1)

    model_masked_sq = jnp.sum(model * model, axis=1) + jnp.where(
        mask_model, 0.0, _BIG)

    chunk = params.chunk
    pad = (-K) % chunk
    phi_p = jnp.pad(phi_f, (0, pad)).reshape(-1, chunk)
    t_p = jnp.pad(t_f, ((0, pad), (0, 0))).reshape(-1, chunk, 2)
    ok_p = jnp.pad(ok_f, (0, pad)).reshape(-1, chunk)
    clip_p = jnp.pad(clip_f, (0, pad)).reshape(-1, chunk)

    def score_chunk(args):
        ph, t, valid, clip = args
        c, s = jnp.cos(ph), jnp.sin(ph)
        x = ctrl[None, :, 0]
        y = ctrl[None, :, 1]
        stx = c[:, None] * x - s[:, None] * y + t[:, 0:1]
        sty = s[:, None] * x + c[:, None] * y + t[:, 1:2]
        st = jnp.stack([stx, sty], axis=-1)                  # [k, C, 2]

        # scene-side clip (TwinPointMatching.cpp:297-313)
        lo_s = jnp.maximum(0, -clip)[:, None]
        hi_s = jnp.minimum(n, n - clip)[:, None]
        keep_s = ((c_idx[None, :] >= lo_s) & (c_idx[None, :] <= hi_s)
                  & c_mask[None, :])

        q2 = jnp.sum(st * st, axis=-1)
        cross = jnp.einsum("kcd,md->kcm", st, model)
        d2 = q2[..., None] + model_masked_sq[None, None, :] - 2.0 * cross
        nn = jnp.argmin(d2, axis=-1)
        d2min = jnp.maximum(
            jnp.take_along_axis(d2, nn[..., None], -1)[..., 0], 0.0)

        # model-side clip (:320-327)
        lo_m = jnp.maximum(0, clip)[:, None]
        hi_m = jnp.minimum(n, n + clip)[:, None]
        keep_m = (nn >= lo_m) & (nn <= hi_m)

        keep = keep_s & keep_m
        err = jnp.sqrt(jnp.sum(jnp.where(keep, d2min, 0.0), axis=1))
        cnt = jnp.sum(keep & (d2min < eps_sqr), axis=1)
        max_cnt = jnp.sum(keep, axis=1)
        rate = cnt.astype(dtype) / jnp.maximum(max_cnt, 1).astype(dtype)
        good = valid & (cnt > 0)
        return (jnp.where(good, jnp.round(rate * 1e5), -_BIG),
                jnp.where(good, cnt.astype(dtype), -_BIG), err,
                max_cnt)

    rate_q, cnt, err, max_cnt = jax.lax.map(
        score_chunk, (phi_p, t_p, ok_p, clip_p))
    rate_q = rate_q.reshape(-1)[:K]
    cnt = cnt.reshape(-1)[:K]
    err = err.reshape(-1)[:K]
    max_cnt = max_cnt.reshape(-1)[:K]

    T = _lex_best((rate_q, cnt, -err), phi_f, t_f, ok)
    if return_scores:
        return T, dict(idx1=idx1, idx2=idx2, i_s=i_s, pair_ok=pair_ok,
                       i2_best=i2_best, rate_q=rate_q, cnt=cnt, err=err,
                       max_cnt=max_cnt, phi=phi_f, t=t_f, span=span)
    return T
