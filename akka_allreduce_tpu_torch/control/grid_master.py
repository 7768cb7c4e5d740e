"""Cluster-wide control plane — the reference's grid ``Master`` (SURVEY.md §3),
the port's own copy of the JAX package's ``control/grid_master.py``.

Discovers nodes via membership events, organizes them into lines (1D) or a 2D
grid of row/column lines (the butterfly topology, SURVEY.md §4.3), owns one
``LineMaster`` per line, and on any membership change bumps the config id and
re-runs the ``PrepareAllreduce`` -> ``ConfirmPreparation`` handshake so rounds
resume against the new peer set (SURVEY.md §4.5: within-round dropout needs NO
reconfiguration — thresholds absorb it; this path is for actual member loss or
late joiners).

Hierarchy (RESILIENCE.md "Scale — the pod-scale control plane"): this
class owns CROSS-SHARD structure only — membership, the shard layout
(control/pod.py's pure assignment functions), per-worker round-resume
floors, and the dims-2 start gates. Each shard's ``LineMaster`` owns its
own round sequence:

- **dims-1 shards free-run** — every line resumes past only what ITS
  OWN workers have seen (the per-worker floors), so a fast shard never
  drags a slow one's round numbers forward on a re-shard, and a re-shard
  that moves a worker between shards still never hands it a round id at
  or below one it already flushed;
- **dims-2 lines stay in lockstep** — the butterfly chains dim-0 output
  into dim-1 input BY ROUND NUMBER, so all lines share one resume point,
  and each COLUMN line carries a ``start_gate`` that holds round r until
  every ROW line has completed r (the one place a cross-shard barrier is
  load-bearing; everywhere else rounds free-run).

Worker addressing: each node runs one worker per grid dimension (the
reference's ``AllreduceDimensionNode``); worker id = ``node_id * dims + dim``.
"""

from __future__ import annotations

import logging
from typing import Any

from akka_allreduce_tpu_torch.config import (
    LineMasterConfig,
    MasterConfig,
    ThresholdConfig,
)
from akka_allreduce_tpu_torch.control.envelope import Envelope
from akka_allreduce_tpu_torch.control.line_master import LineMaster
from akka_allreduce_tpu_torch.control import pod
from akka_allreduce_tpu_torch.obs import metrics as obs_metrics
from akka_allreduce_tpu_torch.obs import trace as obs_trace
from akka_allreduce_tpu_torch.parallel.mesh import grid_factors
from akka_allreduce_tpu_torch.protocol import (
    DEFAULT_POLICY,
    CompleteAllreduce,
    ConfirmPreparation,
)

log = logging.getLogger(__name__)

_REORGANIZATIONS = obs_metrics.counter("master.reorganizations")
_SHARDS = obs_metrics.gauge("master.shards")


def dim_worker_id(node_id: int, dim: int, dims: int) -> int:
    return node_id * dims + dim


class GridMaster:
    """Membership + shard layout + reconfiguration handshake."""

    def __init__(
        self,
        threshold: ThresholdConfig,
        config: MasterConfig = MasterConfig(),
        line_master_config: LineMasterConfig = LineMasterConfig(),
        *,
        on_round_complete=None,  # LineMaster RoundObserver, fanned to all lines
        on_round_start=None,  # LineMaster RoundStartObserver, same fan-out
        on_reorganize=None,  # called when a reorganization replaces the lines
        epoch: int = -1,  # leadership epoch stamped onto Prepare/Start
    ) -> None:
        self.threshold = threshold
        self.config = config
        self.line_master_config = line_master_config
        self.on_round_complete = on_round_complete
        self.on_round_start = on_round_start
        self.on_reorganize = on_reorganize
        self.epoch = epoch
        # current RoundPolicy (control/adapt.py): new rounds AND new line
        # configurations start under it; set via set_policy
        self.policy = DEFAULT_POLICY
        self.nodes: set[int] = set()
        self.config_id = 0
        self.organized = False
        self.line_masters: dict[int, LineMaster] = {}
        self._line_of_worker: dict[int, int] = {}
        # line ids whose Starts are gated on the dim-0 lines (dims-2
        # columns) — the set handle_for_line refill()s on row completion
        self._gated_lines: set[int] = set()
        # global resume fallback: the highest round number ANY line of
        # any configuration began (dims-2 lines, whose numbering is
        # coupled by the chain, all resume from here)
        self.resume_round = 0
        # per-WORKER round high-water (dims-1 sharding): the highest
        # next_round of any replaced line that contained the worker.
        # A new shard resumes past only ITS members' floors — this is
        # what lets shards free-run — and the map rides the replicated
        # StateDigest so a standby takeover keeps every shard's sequence
        # instead of snapping all of them to the global max.
        self._resume_of_worker: dict[int, int] = {}
        self._completed_before_reorg = 0  # line-rounds of replaced configs

    # -- membership events (reference: Akka Cluster MemberUp/Unreachable) ----

    def member_up(self, node_id: int) -> list[Envelope]:
        if node_id in self.nodes:
            return []
        self.nodes.add(node_id)
        if not self.organized:
            if len(self.nodes) < self.config.node_num:
                return []
            return self._organize()
        # late joiner after initial organization: re-line immediately
        log.info("master: late joiner node %d -> reorganize", node_id)
        return self._organize()

    def member_unreachable(self, node_id: int) -> list[Envelope]:
        if node_id not in self.nodes:
            return []
        self.nodes.discard(node_id)
        if not self.organized:
            return []
        log.info("master: lost node %d -> reorganize", node_id)
        # degraded mode FIRST: in-flight rounds that already hold every
        # completion the surviving workers can deliver complete gracefully
        # (counted, flushed, watchdog retired) before the reorganization
        # abandons whatever genuinely cannot finish
        dims = self.config.dimensions
        gone = [dim_worker_id(node_id, d, dims) for d in range(dims)]
        for lm in self.line_masters.values():
            lm.member_unreachable(gone)
        if not self.nodes:
            # cluster emptied: fold the dying configuration's progress and
            # round high-water marks exactly as _organize would, so a later
            # repopulation neither undercounts nor reuses round numbers.
            # A promoted standby can reach here with ZERO live lines
            # (takeover marks the grid organized before any re-join lands,
            # then the detector expels the last known member) — its
            # digest-carried floors are already the high-water marks.
            self._fold_replaced_lines()
            self.organized = False
            for lm in self.line_masters.values():
                lm.abandon_open_spans()
            if self.on_reorganize is not None:
                self.on_reorganize()
            self.line_masters.clear()
            self._line_of_worker.clear()
            self._gated_lines.clear()
            return []
        return self._organize()

    def reorganize(self) -> list[Envelope]:
        """Force a fresh line organization + Prepare handshake with the
        current member set (e.g. a node process restarted under the same
        identity and needs its workers re-configured)."""
        if not self.organized or not self.nodes:
            return []
        return self._organize()

    # -- line organization ---------------------------------------------------

    def _fold_replaced_lines(self) -> None:
        """Roll the dying configuration's round high-waters into the
        per-worker floors (and the global fallback) and bank its
        completed-round budget — one definition for _organize and the
        cluster-emptied path."""
        if not self.line_masters:
            return
        for lm in self.line_masters.values():
            for w in lm.worker_ids:
                prev = self._resume_of_worker.get(w, 0)
                self._resume_of_worker[w] = max(prev, lm.next_round)
        self.resume_round = max(
            self.resume_round,
            max(lm.next_round for lm in self.line_masters.values()),
        )
        self._completed_before_reorg += sum(
            lm.total_completed for lm in self.line_masters.values()
        )

    def _shard_views(self, nodes: list[int]) -> list[list[int]]:
        """The dims-1 shard layout of a membership view — coordinate-
        anchored blocks when a pod grid is configured (boundaries never
        move, an expulsion only shrinks its own shard), else the
        balanced contiguous split. Both are PURE in the view."""
        cfg = self.config
        if cfg.grid_rows > 0:
            return pod.coordinate_shard_assignment(
                nodes, cfg.grid_rows, cfg.grid_cols, cfg.line_shards
            )
        return pod.shard_assignment(nodes, cfg.line_shards)

    def _grid_views(self, nodes: list[int]) -> tuple[list[list[int]], list[list[int]]]:
        """The dims-2 row and column membership of a view. With a pod
        grid configured the node id IS the coordinate (row-major over
        ``grid_rows x grid_cols`` — control/pod.py), so rows/columns are
        stable coordinate groups with holes where members died; without
        one, the historical most-square factorization of the live count."""
        cfg = self.config
        if cfg.grid_rows > 0:
            cols = cfg.grid_cols
            row_of: dict[int, list[int]] = {}
            col_of: dict[int, list[int]] = {}
            for n in nodes:
                row_of.setdefault(n // cols, []).append(n)
                col_of.setdefault(n % cols, []).append(n)
            rows_v = [row_of[r] for r in sorted(row_of)]
            cols_v = [col_of[c] for c in sorted(col_of)]
            return rows_v, cols_v
        rows, cols = grid_factors(len(nodes))
        grid = [nodes[r * cols : (r + 1) * cols] for r in range(rows)]
        rows_v = [grid[r] for r in range(rows)]
        cols_v = [[grid[r][c] for r in range(rows)] for c in range(cols)]
        return rows_v, cols_v

    def _organize(self) -> list[Envelope]:
        """(Re)partition nodes into lines; handshake every line."""
        # Fold the replaced lines' high-waters FIRST: a new configuration
        # never reuses an in-flight round number of any line that shared
        # a worker with it.
        self._fold_replaced_lines()
        self.config_id += 1
        _REORGANIZATIONS.inc()
        self.organized = True
        # the replaced lines' in-flight rounds are abandoned BY DESIGN:
        # close their open trace spans (else the round roots vanish
        # unrecorded) and let any watchdog retire their deadlines (else
        # every re-mesh reads as a stall)
        for lm in self.line_masters.values():
            lm.abandon_open_spans()
        if self.on_reorganize is not None:
            self.on_reorganize()
        self.line_masters.clear()
        self._line_of_worker.clear()
        self._gated_lines.clear()
        nodes = sorted(self.nodes)
        dims = self.config.dimensions
        lines: list[list[int]] = []  # each entry: worker ids of one line
        gated_from = None  # first line id whose Starts are dim-1 gated
        if dims == 1:
            # sharded round scheduling (RESILIENCE.md "Tier 6"/"Scale"):
            # split the membership into up to line_shards lines, each
            # owning a worker subset and running its own round sequence —
            # round fan-out stops being one LineMaster's job. Every
            # reorganization re-shards from the CURRENT view through the
            # pure assignment functions (control/pod.py), so the same
            # view yields the same shards on every rebuild.
            for shard in self._shard_views(nodes):
                lines.append([dim_worker_id(n, 0, 1) for n in shard])
        elif dims == 2:
            rows_v, cols_v = self._grid_views(nodes)
            # dim 0: one line per row; dim 1: one line per column
            for row in rows_v:
                lines.append([dim_worker_id(n, 0, 2) for n in row])
            gated_from = len(lines)
            for col in cols_v:
                lines.append([dim_worker_id(n, 1, 2) for n in col])
        else:
            raise ValueError(f"dimensions must be 1 or 2, got {dims}")

        out: list[Envelope] = []
        # Completed-round budget carried into the new lines: prior configs'
        # completions, split evenly (line count/shape may have changed — the
        # run-level target is ~max_rounds useful rounds per current line).
        prior_per_line = self._completed_before_reorg // len(lines)
        row_line_ids = list(range(gated_from)) if gated_from is not None else []
        _SHARDS.set(len(lines))
        for line_id, worker_ids in enumerate(lines):
            lm = LineMaster(
                self.threshold,
                self.line_master_config,
                line_id=line_id,
                on_round_complete=self.on_round_complete,
                on_round_start=self.on_round_start,
                epoch=self.epoch,
            )
            # the controller's current level survives a reorganization: a
            # re-mesh mid-incident must not silently reset to full fidelity
            lm.policy = self.policy
            self.line_masters[line_id] = lm
            for w in worker_ids:
                self._line_of_worker[w] = line_id
            if dims == 1:
                # per-shard resume: past everything THIS shard's workers
                # have seen, independent of the other shards' sequences
                from_round = max(
                    (self._resume_of_worker.get(w, 0) for w in worker_ids),
                    default=0,
                )
            else:
                # the butterfly's chain couples dim-0/dim-1 by round
                # number: every line shares the global resume point
                from_round = self.resume_round
            if gated_from is not None and line_id >= gated_from:
                # the dims-2 barrier: a column's round r starts only once
                # every row line has COMPLETED r — the Start then chases
                # chain data that exists (the node-side stash still
                # absorbs per-worker skew; this keeps the scheduler from
                # running column rounds that structurally cannot finish)
                lm.start_gate = self._row_gate(row_line_ids)
                self._gated_lines.add(line_id)
            out.extend(
                lm.prepare(
                    tuple(worker_ids),
                    self.config_id,
                    from_round,
                    completed_so_far=prior_per_line,
                )
            )
        log.info(
            "master: organized %d nodes into %d line(s), config %d, resume at %d",
            len(nodes),
            len(lines),
            self.config_id,
            self.resume_round,
        )
        return out

    def _row_gate(self, row_line_ids: list[int]):
        """Start gate for a column line: round r may start once every row
        line of THIS configuration has completed r. Bound to the line ids
        (not instances): the gate dies with the configuration, and ids
        index the current ``line_masters`` generation only."""

        def gate(r: int) -> bool:
            for lid in row_line_ids:
                lm = self.line_masters.get(lid)
                if lm is not None and lm.completed_up_to < r:
                    return False
            return True

        return gate

    # -- message routing -----------------------------------------------------

    def handle_for_line(self, line_id: int, msg: Any) -> list[Envelope]:
        lm = self.line_masters.get(line_id)
        if lm is None:
            return []
        ctx = obs_trace.current()
        watch_gates = self._gated_lines and line_id not in self._gated_lines
        horizon = lm.completed_up_to if watch_gates else -1
        if ctx is not None and ctx.sampled and obs_trace.enabled():
            # the grid-master layer of the round trace: dispatch of a
            # worker's confirm/complete back into the owning line
            with obs_trace.span(
                "grid_master.dispatch", line=line_id, msg=type(msg).__name__
            ):
                out = lm.handle(msg)
        else:
            out = lm.handle(msg)
        if watch_gates and lm.completed_up_to > horizon:
            # a row line's horizon MOVED: a column gate keyed on it may
            # have opened — refill the gated lines and carry their Starts
            # in the same dispatch (synchronous, no extra scheduling hop;
            # gated only on actual completion, not every row message —
            # the per-message gate sweep would be O(rows·cols) at pod
            # scale for dispatches that can never open anything)
            for gated_id in sorted(self._gated_lines):
                gated = self.line_masters.get(gated_id)
                if gated is not None:
                    out.extend(gated.refill())
        return out

    def handle(self, msg: Any) -> list[Envelope]:
        """Route a worker->master message to the owning line master."""
        if isinstance(msg, (ConfirmPreparation, CompleteAllreduce)):
            wid = msg.worker_id if isinstance(msg, ConfirmPreparation) else msg.src_id
            line_id = self._line_of_worker.get(wid)
            if line_id is None:
                return []
            return self.handle_for_line(line_id, msg)
        raise TypeError(f"master cannot handle {type(msg).__name__}")

    # -- replication (master HA, per-shard-aware) ----------------------------

    def lines_static_state(self) -> dict[str, list[int]]:
        """The slow half of the replicated shard state: each live line's
        worker set (changes only on reorganization — rides the digest's
        cached static half)."""
        return {
            str(lid): sorted(lm.worker_ids)
            for lid, lm in self.line_masters.items()
        }

    def resume_floor_state(self) -> dict[str, int]:
        """The per-worker resume floors (reorganization-paced too)."""
        return {str(w): r for w, r in sorted(self._resume_of_worker.items())}

    def lines_round_state(self) -> dict[str, int]:
        """The fast half: each live line's next round number — per tick,
        so a standby takeover resumes EVERY shard past its own sequence
        instead of snapping all of them to the global max."""
        return {
            str(lid): lm.next_round for lid, lm in self.line_masters.items()
        }

    def restore_shard_state(
        self,
        floors: dict | None,
        line_workers: dict | None,
        line_next: dict | None,
        *,
        fallback_round: int = 0,
        fallback_workers=(),
    ) -> None:
        """Adopt a replicated shard state (standby takeover): per-worker
        floors, raised by each replicated line's live next round over its
        worker set. The takeover's first reorganization then resumes
        every shard past ITS OWN high-water.

        A digest from a leader that predates the per-shard fields (no
        floors, no lines) falls back to flooring EVERY known worker at
        ``fallback_round`` (the digest's global next) — the legacy
        global-max takeover, never a round-number regression."""
        for w, r in (floors or {}).items():
            self._resume_of_worker[int(w)] = max(
                self._resume_of_worker.get(int(w), 0), int(r)
            )
        for lid, workers in (line_workers or {}).items():
            nxt = int((line_next or {}).get(lid, 0))
            for w in workers:
                self._resume_of_worker[int(w)] = max(
                    self._resume_of_worker.get(int(w), 0), nxt
                )
        if not floors and not line_workers:
            for w in fallback_workers:
                self._resume_of_worker[int(w)] = max(
                    self._resume_of_worker.get(int(w), 0), int(fallback_round)
                )

    # -- adaptive degradation (control/adapt.py) -------------------------------

    def set_policy(self, policy) -> None:
        """Adopt a new RoundPolicy: rounds started from now on (and any
        future line configuration) carry it; in-flight rounds keep the
        stamp they started under."""
        self.policy = policy
        for lm in self.line_masters.values():
            lm.policy = policy

    def worker_lags(self) -> dict[int, int]:
        """Per-worker contribution lag (rounds) across every line — the
        controller's straggler evidence (LineMaster.worker_lags). Shards
        are disjoint worker sets, so the merge is a union; the max guard
        covers the dims-2 case where a node's two dim workers would ever
        share an id (they cannot — belt and suspenders)."""
        out: dict[int, int] = {}
        for lm in self.line_masters.values():
            for w, lag in lm.worker_lags().items():
                out[w] = max(out.get(w, 0), lag)
        return out

    @property
    def total_completed(self) -> int:
        """Line-rounds completed across every configuration this master ran."""
        return self._completed_before_reorg + sum(
            lm.total_completed for lm in self.line_masters.values()
        )

    @property
    def is_done(self) -> bool:
        return bool(self.line_masters) and all(
            lm.is_done for lm in self.line_masters.values()
        )
