"""The analysis tier of the port (mirrors ``tsne_flink_tpu/analysis``):
the JAX package's three tiers, over the port's own tree.

* **graftlint** (:mod:`.core`, :mod:`.rules`) — pure-stdlib ``ast`` rules
  with a registry, per-rule suppression comments (``# graftlint:
  disable=<rule> -- <rationale>``, the JAX package's grammar) and
  JSON/human output: ``python -m tsne_flink_tpu_torch.analysis
  tsne_flink_tpu_torch`` exits 0 on a clean tree.  ``--suppressions``
  prints the ledger, ``--env-table`` the (empty) environment registry.
* **graftrace** (:mod:`.conc`) — the concurrency/protocol checks over
  ``runtime/ serve/ utils/`` (``--conc``), stdlib-only too.
* **graftcheck** (:mod:`.audit`) — ``--audit``: the memory model's
  findings, dtype contracts, the kernel-library build count, the
  sharding, determinism and comms audits, over tiny concrete runs
  recorded by :mod:`.audit.record` (PyTorch has no abstract trace of
  this code).  It imports torch and runs on the card unless ``--device
  cpu`` is given.

The CLI's ``--auditPlan`` runs the plan audit before a launch and refuses
a predicted OOM; ``--executionPlan`` writes the recorded op list of one
optimize iteration and one KL pass.  Not applicable, with the reasons in
ROADMAP §A16: ``jit-hygiene``, ``carry-hygiene``,
``bench-record-contract``, the compile audit's segment keys and cycle
reuse.  The lint and conc tiers import no torch (importing this package
imports only :mod:`.core`).
"""

from tsne_flink_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    RULES,
    render_human,
    render_json,
    rule,
    run,
)
