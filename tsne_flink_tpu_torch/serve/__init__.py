"""Out-of-sample serving (port of ``tsne_flink_tpu/serve``): the frozen
model (:mod:`serve.model`), the bucketed transform (:mod:`serve.transform`),
the micro-batch scheduler (:mod:`serve.sched`), the spool daemon
(:mod:`serve.daemon`) and N daemon replicas over one spool
(:mod:`serve.replicas`)."""
