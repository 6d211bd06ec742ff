"""Two-view relative pose: Hamming matching, essential-matrix and
homography LO-RANSAC, ORB-SLAM's model selection, cheirality pose recovery
and the manifold polish (mirrors ``tinyslam_tpu/models/two_view.py``)."""

from __future__ import annotations

import torch

from slambench.reference.tslam.config import MatcherConfig, RansacConfig
from slambench.reference.tslam.geometry.camera import PinholeCamera
from slambench.reference.tslam.geometry.fivepoint import ransac_essential_5pt
from slambench.reference.tslam.geometry.homography import ransac_homography, recover_pose_homography
from slambench.reference.tslam.geometry.ransac import ransac_essential, recover_pose, refine_relative_pose
from slambench.reference.tslam.ops.hamming import match_descriptors
from slambench.reference.tslam.types import Features
from slambench.reference.tslam.utils.draws import Sampler


class TwoViewEstimator:
    def __init__(self, camera: PinholeCamera, matcher: MatcherConfig = MatcherConfig(),
                 ransac: RansacConfig = RansacConfig()):
        self.camera = camera
        self.matcher = matcher
        self.ransac = ransac

    def estimate(self, fa: Features, fb: Features, sampler: Sampler, seed: int = 0) -> dict:
        """Relative pose of frame b with respect to frame a: X_b = R X_a + t,
        |t| = 1.

        The RANSAC samples come from ``sampler`` under the keys
        ``("two_view", seed, "E")`` and ``("two_view", seed, "H")``, where
        the reference splits ``PRNGKey(seed)``.  Reads the two models'
        inlier counts back once, for the model choice.

        The solvers, votes and polish run in float64 (the reference's in
        float32): in float32, cuSOLVER's and LAPACK's roundings move a
        point across the inlier threshold often enough that the card and
        the CPU, given the same draws, pick different hypotheses.
        Returns dict with R, t, matches (idx_b per a-feature), match_valid,
        inliers, num_inliers, points (triangulated, frame-a coordinates;
        R, t and points float32) and model ("E" or "H").
        """
        rc = self.ransac
        m = match_descriptors(fa.desc, fa.valid, fb.desc, fb.valid,
                              max_distance=self.matcher.max_distance,
                              ratio=self.matcher.ratio,
                              cross_check=self.matcher.cross_check)
        valid = m["valid"]
        x1 = self.camera.normalize(fa.xy).double()
        x2 = self.camera.normalize(fb.xy[m["idx_b"].long()]).double()
        dev = x1.device
        if rc.sample_size == 5:
            u = sampler.uniform((rc.num_hypotheses // 4, 5), dev, key=("two_view", seed, "E"))
            res_e = ransac_essential_5pt(u, x1, x2, valid,
                                         inlier_threshold=rc.inlier_threshold,
                                         refine_iters=rc.refine_iters)
        else:
            u = sampler.uniform((rc.num_hypotheses, rc.sample_size), dev,
                                key=("two_view", seed, "E"))
            res_e = ransac_essential(u, x1, x2, valid,
                                     inlier_threshold=rc.inlier_threshold,
                                     refine_iters=rc.refine_iters)
        u = sampler.uniform((rc.num_hypotheses, 4), dev, key=("two_view", seed, "H"))
        res_h = ransac_homography(u, x1, x2, valid, inlier_threshold=rc.inlier_threshold)
        # Model selection (ORB-SLAM's rule): when the homography explains a
        # comparable share of the matches, the scene is quasi-planar and E
        # degenerate, so trust the H decomposition.
        s_e, s_h = torch.stack([res_e["num_inliers"], res_h["num_inliers"]]).tolist()
        use_h = s_h / max(s_h + s_e, 1) > 0.45
        if use_h:
            pose = recover_pose_homography(res_h["H"], x1, x2, res_h["inliers"])
            R, t = pose["R"], pose["t"]
            res = res_h
        else:
            pose = recover_pose(res_e["E"], x1, x2, res_e["inliers"])
            R, t = refine_relative_pose(pose["R"], pose["t"], x1, x2, res_e["inliers"],
                                        inlier_threshold=rc.inlier_threshold)
            res = res_e
        return {
            "R": R.float(), "t": t.float(), "matches": m["idx_b"], "match_valid": valid,
            "inliers": res["inliers"] & pose["good"], "num_inliers": res["num_inliers"],
            "points": pose["points"].float(), "model": "H" if use_h else "E",
        }
