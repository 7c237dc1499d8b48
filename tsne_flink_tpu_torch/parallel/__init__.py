"""Sharding of the point axis over a mesh of devices (port of
``tsne_flink_tpu/parallel``).  Ported: the single-controller mesh
(:mod:`~tsne_flink_tpu_torch.parallel.mesh`)."""
