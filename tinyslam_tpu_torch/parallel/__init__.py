"""The distributed layer on ``torch.distributed``, and the back-end worker
thread (mirrors ``tinyslam_tpu/parallel/``).

- ``mesh``        the (frame, landmark) ``DeviceMesh``, multi-process
                  start-up, and the axis sum and gather the solvers reduce
                  with.
- ``frontend_dp`` frame data parallelism: ORB over a batch of frames split
                  on ``frame``, K1 once over each rank's frames.
- ``dist_ba``     landmark-sharded bundle adjustment: Schur contributions
                  summed over ``landmark``, the reduced camera solve on
                  every rank, landmark back-substitution local.
- ``dist_pose_graph`` the edge-sharded pose graph (one sum of the normal
                  equations an iteration) and the node-sharded one
                  (two-level overlapping Schwarz with a halo exchange).
- ``track_dp``    multi-sequence tracking: B camera streams split over
                  ``frame``, each rank tracking its own as one batch.
- ``pipeline``    decoupling the back-end from tracking: the latest-wins
                  worker thread.
"""

# The exports are lazy (PEP 562), as in the JAX package: importing the
# package creates no process group and loads no solver.
_LAZY = {
    "make_mesh": "tinyslam_tpu_torch.parallel.mesh",
    "initialize_multihost": "tinyslam_tpu_torch.parallel.mesh",
    "extract_features_batch": "tinyslam_tpu_torch.parallel.frontend_dp",
    "bundle_adjust_sharded": "tinyslam_tpu_torch.parallel.dist_ba",
    "optimize_pose_graph_sharded": "tinyslam_tpu_torch.parallel.dist_pose_graph",
    "optimize_pose_graph_node_sharded": "tinyslam_tpu_torch.parallel.dist_pose_graph",
    "partition_edges_by_node": "tinyslam_tpu_torch.parallel.dist_pose_graph",
    "track_chunk_dp": "tinyslam_tpu_torch.parallel.track_dp",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
