"""A frozen copy of the port's plain tracker: the reference that decides
``correct``.

The files are the port's modules at the commit this benchmark was defined
on, with ``tinyslam_tpu_torch`` renamed to ``slambench.reference.tslam``:
configuration and types, the ORB front-end, the plain FAST stage and
matcher, the geometry (PnP and its RANSAC, the two-view solvers), the
windowed bundle adjustment, ``VisualOdometry`` (the bootstrap) and
``models/vo_device.py`` (``track_step``, ``track_chunk``,
``track_step_batch``).  Three files are not copies:
``ops/fast_cuda.py`` and ``ops/match_cuda.py`` run the plain FAST stage
and matcher on every device, and ``utils/cuda_graph.py`` keeps only
``device_cond`` and ``device_loop``'s eager forms.  So the reference is
plain PyTorch: it runs no hand-written kernel and captures no graph, and
nothing here imports the port.  Later changes to the port do not reach it.
"""
