"""The analysis tier of the PyTorch port (mirrors ``tsne_flink_tpu/
analysis``).  Ported so far: the arithmetic of the memory model
(``audit/plan.py``, ``audit/hbm.py``), which the runtime's OOM ladder,
the fleet's admission and the serve daemon's residency gate charge.  The
lint rules, the jaxpr auditors and the findings are ROADMAP queue A16."""
