"""Sharding of the point axis over a mesh of devices (port of
``tsne_flink_tpu/parallel``): the single-controller mesh and the process
axis (:mod:`~tsne_flink_tpu_torch.parallel.mesh`), the sharded kNN
(:mod:`~tsne_flink_tpu_torch.parallel.knn`), the routed symmetrization
(:mod:`~tsne_flink_tpu_torch.parallel.symmetrize`) and the
multi-controller job (:mod:`~tsne_flink_tpu_torch.parallel.pipeline`)."""
