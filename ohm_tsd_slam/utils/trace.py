"""Registration trace recorder.

Equivalent of the reference's Trace module
(src/obvision/registration/Trace.{h,cpp}): records the model, the scene,
and per-iteration transformed scenes / pair assignments / scores, then
serializes them to gnuplot-ready `.dat` files plus a plot script
(Trace.cpp:144-390: `model.dat`, `scene.dat`, `scene_NNN.dat`,
`pairs_NNN.dat`, `score.dat`, `trace.gpi`).

Functional redesign: where the reference mutates a Trace object from
inside Icp::step / the RANSAC matchers (forcing single-threaded
execution, RandomNormalMatching.cpp:209-216), the jitted kernels here
already *return* their per-iteration history (IcpResult.rms_history /
pair_history); this module is the host-side sink that collects those
pytrees and writes the same artifact layout — no effect on device code.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class Trace:
    """Host-side trace collector (Trace.h:30-120)."""

    dim: int = 2
    _model: Optional[np.ndarray] = None
    _scene: Optional[np.ndarray] = None
    _scenes: List[np.ndarray] = field(default_factory=list)
    _pairs: List[np.ndarray] = field(default_factory=list)
    _scores: List[float] = field(default_factory=list)
    # RANSAC-side 3-part record ids (trial, idxM, idxS) — switches
    # serialize() to the reference's id-aware layout (Trace.cpp:200-312)
    _ids: List[Optional[tuple]] = field(default_factory=list)

    def reset(self) -> None:
        """Trace::reset (Trace.cpp:57-79)."""
        self._model = None
        self._scene = None
        self._scenes.clear()
        self._pairs.clear()
        self._scores.clear()

    def set_model(self, model, mask=None) -> None:
        """Trace::setModel (Trace.cpp:81-100)."""
        m = np.asarray(model)
        if mask is not None:
            m = m[np.asarray(mask)]
        self._model = m

    def set_scene(self, scene, mask=None) -> None:
        """Trace::setScene (Trace.cpp:102-121)."""
        s = np.asarray(scene)
        if mask is not None:
            s = s[np.asarray(mask)]
        self._scene = s

    def add_assignment(self, scene, pairs=None, score: float = 0.0,
                       ids=None) -> None:
        """Trace::addAssignment (Trace.cpp:123-142): one iteration's
        transformed scene, its (model_idx, scene_idx) pair array, and a
        scalar score.  `ids` is the RANSAC matchers' 3-part record id
        (trial, idxM, idxS) — the hook at RandomNormalMatching.cpp:
        362-370 passes (iterationID, idxM[0], idxS[0])."""
        self._scenes.append(np.asarray(scene))
        self._pairs.append(
            np.asarray(pairs) if pairs is not None
            else np.zeros((0, 2), np.int32))
        self._scores.append(float(score))
        self._ids.append(tuple(int(v) for v in ids)
                         if ids is not None else None)

    def add_ransac_candidate(self, trial: int, idx_m: int, idx_s: int,
                             control_transformed, model_pt, scene_pt,
                             score: float) -> None:
        """One RANSAC candidate record: the transformed control set,
        the (model, scene) anchor pair, and the candidate score — what
        the reference's matchers push per traced candidate
        (RandomNormalMatching.cpp:362-370: STemp + the single
        idx/i pair + errSum)."""
        pair_pts = np.stack([np.asarray(model_pt),
                             np.asarray(scene_pt)])[None]    # [1, 2, d]
        self._scenes.append(np.asarray(control_transformed))
        self._pairs.append(pair_pts)
        self._scores.append(float(score))
        self._ids.append((int(trial), int(idx_m), int(idx_s)))

    def add_icp_history(self, scene0: np.ndarray, result) -> None:
        """Record a whole IcpResult history (the functional analogue of
        the per-step hook at Icp.cpp:430-444).

        When the ICP ran with IcpParams.record_pairs, the per-iteration
        (model_idx, scene_idx) pair assignments are recorded too
        (Trace::addAssignment's pair payload)."""
        rms = np.asarray(result.rms_history)
        idx_h = result.pair_idx_history
        mask_h = result.pair_mask_history
        for i in range(rms.shape[0]):
            if np.isnan(rms[i]):
                break
            pairs = None
            if idx_h is not None and mask_h is not None:
                m = np.asarray(mask_h[i])
                pairs = np.stack([np.asarray(idx_h[i])[m],
                                  np.nonzero(m)[0]], axis=1)
            self.add_assignment(scene0, pairs, float(rms[i]))

    # -- serialization ------------------------------------------------------
    def serialize(self, folder: str) -> None:
        """Trace::serialize (Trace.cpp:144-390): write model/scene/
        per-iteration data + a gnuplot script into a new folder.  With
        3-part record ids (RANSAC matchers) the reference's id-aware
        layout is produced: scene_/pairs_%05d_%05d_%05d.dat files,
        per-trial score_%05d.dat, score3D.dat and score3D.gpi
        (Trace.cpp:200-312)."""
        os.makedirs(folder, exist_ok=True)
        if self._model is not None:
            np.savetxt(os.path.join(folder, "model.dat"), self._model,
                       fmt="%.6f")
        if self._scene is not None:
            np.savetxt(os.path.join(folder, "scene.dat"), self._scene,
                       fmt="%.6f")
        ransac = bool(self._ids) and self._ids[0] is not None
        for i, (sc, pr) in enumerate(zip(self._scenes, self._pairs)):
            if ransac:
                t, im, isc = self._ids[i]
                tag = f"{t:05d}_{im:05d}_{isc:05d}"
            else:
                tag = f"{i:03d}"
            np.savetxt(os.path.join(folder, f"scene_{tag}.dat"), sc,
                       fmt="%.6f")
            lines = []
            if pr.size and pr.ndim == 3:
                # RANSAC anchor pairs carry the points directly
                for mp, sp in pr:
                    lines.append(mp)
                    lines.append(sp)
            elif pr.size and self._model is not None and sc.size:
                for mi, si in pr:
                    lines.append(self._model[mi])
                    lines.append(sc[si])
            np.savetxt(os.path.join(folder, f"pairs_{tag}.dat"),
                       np.asarray(lines).reshape(-1, self.dim)
                       if lines else np.zeros((0, self.dim)),
                       fmt="%.6f")
        if ransac:
            # per-trial score files: rows "idxM idxS score"
            # (Trace.cpp:255-284)
            by_trial = {}
            for (t, im, isc), sc in zip(self._ids, self._scores):
                by_trial.setdefault(t, []).append((im, isc, sc))
            for t, rows in by_trial.items():
                with open(os.path.join(folder, f"score_{t:05d}.dat"),
                          "w") as f:
                    for im, isc, sc in rows:
                        f.write(f"{im} {isc} {sc:.9f}\n")
            # score3D.dat + splot script (Trace.cpp:289-312)
            with open(os.path.join(folder, "score3D.dat"), "w") as f:
                for (t, im, isc), sc in zip(self._ids, self._scores):
                    f.write(f"{t} {im} {isc} {sc:.9f}\n")
            with open(os.path.join(folder, "score3D.gpi"), "w") as f:
                f.write("clear\nreset\nset hidden3d\n"
                        "set dgrid3d 50,50 qnorm 2\n"
                        "splot \"./score3D.dat\" u 2:3:4 w l\n")
        else:
            np.savetxt(os.path.join(folder, "score.dat"),
                       np.asarray(self._scores), fmt="%.9f")
        self._write_gpi(folder)

    def _write_gpi(self, folder: str) -> None:
        ransac = bool(self._ids) and self._ids[0] is not None
        lines = [
            "set terminal pngcairo size 800,800",
            "set size ratio -1",
        ]
        for i in range(len(self._scenes)):
            if ransac:
                t, im, isc = self._ids[i]
                tag = f"{t:05d}_{im:05d}_{isc:05d}"
            else:
                tag = f"{i:03d}"
            lines += [
                f"set output 'trace_{tag}.png'",
                ("plot 'model.dat' u 1:2 w p pt 7 ps 0.4 t 'model', "
                 f"'scene_{tag}.dat' u 1:2 w p pt 7 ps 0.4 t 'scene', "
                 f"'pairs_{tag}.dat' u 1:2 w l lw 0.3 t 'pairs'"),
            ]
        with open(os.path.join(folder, "trace.gpi"), "w") as f:
            f.write("\n".join(lines) + "\n")


def record_ransac_trace(trace: "Trace", model, mask_model, scene,
                        mask_scene, aux, params, keep, scores) -> None:
    """Fill `trace` with RANSAC candidate records from a matcher's
    return_scores aux (registration/ransac.py).

    keep: [K] bool — which candidates to record (the reference traces
    EXP candidates passing its count gate, RandomNormalMatching.cpp:
    338-379, and PDF/TSD candidates only on best-so-far improvement);
    scores: [K] — the per-candidate score payload (errSum for EXP,
    scaled probabilities for PDF/TSD).
    """
    from ohm_tsd_slam.registration.ransac import _transform_ctrl

    prep = aux["prep"]
    span = params.span
    keep = np.asarray(keep)
    scores = np.asarray(scores)
    model = np.asarray(model)
    scene = np.asarray(scene)
    trace.set_model(model, np.asarray(mask_model))
    trace.set_scene(scene, np.asarray(mask_scene))
    kidx = np.nonzero(keep)[0]
    if len(kidx) == 0:
        return
    st = np.asarray(_transform_ctrl(
        prep, prep.phi_cand[jnp_idx(kidx)], prep.t_cand[jnp_idx(kidx)]))
    t_of = np.asarray(prep.t_idx)
    for row, k in enumerate(kidx):
        t = int(k // (2 * span))
        idx_m = int(t_of[t])
        i = int(k % (2 * span)) - span + idx_m
        trace.add_ransac_candidate(t, idx_m, i, st[row],
                                   model[idx_m], scene[i],
                                   float(scores[k]))


def jnp_idx(idx):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(idx, np.int32))
