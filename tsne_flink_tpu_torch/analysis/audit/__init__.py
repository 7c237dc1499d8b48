"""The memory model of a pipeline plan (the arithmetic part of the JAX
package's ``analysis/audit``)."""

from tsne_flink_tpu_torch.analysis.audit.plan import PlanConfig

__all__ = ["PlanConfig"]
