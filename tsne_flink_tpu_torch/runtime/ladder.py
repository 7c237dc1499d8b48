"""OOM degradation ladder — on a device OOM, pick the next-cheaper plan
(port of ``tsne_flink_tpu/runtime/ladder.py``: the same rungs in the same
order, the same records).

When a stage dies with an out-of-memory error, the ladder consults the
memory model (``analysis/audit/hbm.py``) and the supervisor relaunches
the failed stage with the accumulated overrides:

1. **shrink the kNN tile budget** (halve ``pick_knn_tiles``'s working-set
   budget, up to twice) — recall-invariant by the tile planner's
   contract, so it is always the first rung;
2. **switch affinity assembly to ``blocks``** — the memory-flat layout
   that never materializes the hub-widened [N, S] rows;
3. **demote repulsion** exact → bh → fft (quality changes, which is why
   it is the LAST rung and every demotion is recorded).

Every step is recorded as a :class:`Degradation` carrying the memory
model's predicted peak before/after where the model can express the
change.  On the card a rung is taken for its decision whether or not the
model predicts it to free memory (parity with the JAX ladder); a rung
that frees nothing shows before = after in its record.  Which rungs free
memory on the card is measured (PERF.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

#: repulsion demotion chain (ladder rung 3); fft is the floor.
REPULSION_DEMOTION = {"exact": "bh", "bh": "fft"}

#: how many times rung 1 may halve the tile budget before escalating.
MAX_TILE_SHRINKS = 2


@dataclass(frozen=True)
class Degradation:
    """One recorded ladder step (rides bench records and checkpoints)."""

    seq: int
    stage: str        # the stage whose OOM triggered the step
    action: str       # shrink-knn-tiles | assembly-blocks | repulsion-demote
    before: object
    after: object
    peak_hbm_before: int | None = None  # HBM-model prediction, when
    peak_hbm_after: int | None = None   # expressible for this action

    def as_dict(self) -> dict:
        return {"seq": self.seq, "stage": self.stage, "action": self.action,
                "before": self.before, "after": self.after,
                "peak_hbm_before": self.peak_hbm_before,
                "peak_hbm_after": self.peak_hbm_after}


def _predicted_peak(plan) -> int | None:
    """Plan-level peak estimate from the memory model — what admission
    charges for the plan (``analysis/audit/hbm.charged_peak_bytes``: the
    widest rows its run may build); None when the model cannot evaluate
    the plan.  The warning is no fallback on the device path: the
    estimate only fills the record."""
    try:
        from tsne_flink_tpu_torch.analysis.audit.hbm import \
            charged_peak_bytes
        return int(charged_peak_bytes(plan))
    except Exception as e:
        import sys
        print(f"WARNING: HBM model unavailable for the ladder "
              f"({type(e).__name__}: {e}); degrading blind", file=sys.stderr)
        return None


class OomLadder:
    """Degradation state machine over one run's
    :class:`~tsne_flink_tpu_torch.analysis.audit.plan.PlanConfig`.

    :meth:`demote` picks the next untried rung applicable to the failed
    stage and returns its :class:`Degradation` (None when exhausted);
    :meth:`overrides` is the accumulated override set the relaunch applies
    (``knn_tiles`` / ``assembly`` for ``utils/artifacts.prepare``,
    ``repulsion`` for the optimizer config).
    """

    def __init__(self, plan):
        self.plan = plan
        self.tile_shrinks = 0
        self.knn_tiles = None        # KnnTilePlan override, rung 1
        self.assembly = None         # "blocks" once rung 2 fires
        self.repulsion = None        # demoted backend once rung 3 fires
        #: the kNN graph's row-width bound, once observed
        self.width = None
        self.degradations: list[Degradation] = []

    def observe_width(self, width: int) -> None:
        """The kNN graph's row-width bound (``ops/affinities
        .width_bound``): later records' predicted peaks charge it where the
        plan pins no width.  The rungs' choices stay the plan's, as the
        JAX ladder makes them."""
        self.width = int(width)

    def _peak(self) -> int | None:
        plan = self.plan
        if self.width is not None and plan.sym_width is None:
            plan = replace(plan, sym_width=self.width)
        return _predicted_peak(plan)

    # ---- rungs -------------------------------------------------------------

    def _shrink_tiles(self, stage: str) -> Degradation | None:
        if self.tile_shrinks >= MAX_TILE_SHRINKS:
            return None
        from tsne_flink_tpu_torch.ops.knn_tiles import (DEFAULT_BUDGET_BYTES,
                                                        _FALLBACK_BUDGET,
                                                        pick_knn_tiles)
        p = self.plan
        base = DEFAULT_BUDGET_BYTES.get(p.backend, _FALLBACK_BUDGET)
        before = (self.knn_tiles or pick_knn_tiles(
            p.n, p.d, p.k, p.backend, hbm_bytes=base >> self.tile_shrinks,
            metric=p.metric))
        self.tile_shrinks += 1
        budget = base >> self.tile_shrinks
        after = replace(pick_knn_tiles(p.n, p.d, p.k, p.backend,
                                       hbm_bytes=budget, metric=p.metric),
                        source="override")
        self.knn_tiles = after
        return Degradation(
            seq=len(self.degradations), stage=stage,
            action="shrink-knn-tiles",
            before={"budget": base >> (self.tile_shrinks - 1),
                    **before.as_record()},
            after={"budget": budget, **after.as_record()})

    def _assembly_blocks(self, stage: str) -> Degradation | None:
        if self.assembly == "blocks":
            return None
        cur = self.plan.resolved_assembly()
        if cur == "blocks":
            return None  # already memory-flat; nothing cheaper on this rung
        peak0 = self._peak()
        self.plan = replace(self.plan, assembly="blocks")
        self.assembly = "blocks"
        return Degradation(
            seq=len(self.degradations), stage=stage,
            action="assembly-blocks", before=cur, after="blocks",
            peak_hbm_before=peak0, peak_hbm_after=self._peak())

    def _repulsion_demote(self, stage: str) -> Degradation | None:
        cur = self.repulsion or self.plan.resolved_repulsion()
        nxt = REPULSION_DEMOTION.get(cur)
        if nxt is None:
            return None
        peak0 = self._peak()
        self.plan = replace(self.plan, repulsion=nxt)
        self.repulsion = nxt
        return Degradation(
            seq=len(self.degradations), stage=stage,
            action="repulsion-demote", before=cur, after=nxt,
            peak_hbm_before=peak0, peak_hbm_after=self._peak())

    # ---- public ------------------------------------------------------------

    def demote(self, stage: str) -> Degradation | None:
        """The next ladder step for an OOM in ``stage``; records and
        returns it (None = ladder exhausted for that stage)."""
        if stage == "knn":
            rungs = (self._shrink_tiles, self._assembly_blocks)
        elif stage == "affinities":
            rungs = (self._assembly_blocks,)
        else:
            # optimize: only the repulsion working set can shrink without
            # re-running a completed prepare stage (assembly is baked into
            # the P arrays the optimizer already holds)
            rungs = (self._repulsion_demote,)
        for rung in rungs:
            deg = rung(stage)
            if deg is not None:
                self.degradations.append(deg)
                return deg
        return None

    def overrides(self) -> dict:
        """Accumulated prepare-stage overrides for the relaunch."""
        out = {}
        if self.knn_tiles is not None:
            out["knn_tiles"] = self.knn_tiles
        if self.assembly is not None:
            out["assembly"] = self.assembly
        return out

    def records(self) -> list[dict]:
        return [d.as_dict() for d in self.degradations]
