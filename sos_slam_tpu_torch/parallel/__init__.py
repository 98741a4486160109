"""Multi-device data parallelism over the point axis (port of
sos_slam_tpu/parallel/ and of __graft_entry__.py's multi-chip dry run).

  * `comm`: the collectives of the point-sharded GN step;
  * `sharded`: meshes over torch.distributed ranks and the sharded entry
    points (BA and VIO GN steps, trace, multi-hypothesis track);
  * `dryrun`: the tiny inputs of the JAX package's dry run, spawned ranks,
    and `python -m sos_slam_tpu_torch.parallel.dryrun N [--device cpu]`.
"""
