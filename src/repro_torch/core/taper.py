"""TAPER invocation driver (paper §1.1 def. 1, §3, §5).

One *invocation* enhances an existing partitioning for a workload snapshot by
running internal iterations of (extroversion field -> vertex swapping) until
convergence (paper: 6-8 iterations).  Repeated invocations against a drifting
workload implement eqn. (2):

    P_k^0(G) --Q1--> P_k^1(G, Q1) --Q2--> P_k^2(G, Q2) ...

The field runs on the device (``device``, default ``"cuda"``); swapping and
everything around it stays on the host in numpy.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field as dfield
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.rpq import RPQ
from repro_torch.core.swap import SwapConfig, SwapStats, swap_iteration
from repro_torch.core.tpstry import TPSTry, TrieArrays
from repro_torch.core.visitor import (SHARDED_BACKENDS, ExtroversionResult,
                                      extroversion_field)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import LabelledGraph
from repro_torch.utils import get_logger

log = get_logger("core.taper")

#: extroversion-field DP backends ordered by capability: serving loops
#: degrade left-to-right on repeated device failure (losing scale, keeping
#: availability) and probe back right-to-left once the fault clears.  The
#: bottom rung runs the plain field on the Taper's own device — on the card
#: when the Taper is on the card
FIELD_BACKEND_LADDER = ("cuda_sharded", "cuda", "torch")

Workload = Sequence[Tuple[RPQ, float]]


class InvocationAborted(RuntimeError):
    """Raised inside :meth:`Taper.invoke` when the caller's ``should_abort``
    hook fires — a watchdog cancelling a stalled/abandoned run.  The
    partition is untouched (enhancement only publishes via the report)."""


@dataclass
class TaperConfig:
    max_iterations: int = 8          # paper: converges within 6-8
    converge_rel_tol: float = 0.01   # stop when objective improves < 1%
    candidates_per_part: Optional[int] = None  # None = full queue (§5.5)
    rank_by: str = "extroversion"    # "extroversion" (paper) | "mass"
    family_threshold: float = 0.5
    family_max_size: int = 12
    balance_eps: float = 0.05
    min_gain: float = 0.0
    safe_introversion: float = 0.95  # §5.2.1 space heuristic
    depth_cap: Optional[int] = None  # §5.2.2 time heuristic (k < t)
    #: Dense per-destination external-mass matrix (matches the
    #: ``extroversion_field`` default).  True computes the (n, k) ``ext_to``
    #: in the device pass and the swap engine batch-gathers preference rows
    #: from it.  False selects the two-phase §Perf-T2 trade-off: the field
    #: skips the matrix and swap derives each candidate's preferences lazily
    #: from its own cut edges (cheaper for large k / short candidate queues).
    dense_ext_to: bool = True
    #: extroversion-field DP engine: "cuda" (the vm_step kernel; CUDA
    #: devices only) or "torch" (the plain fused field); None picks "cuda"
    #: on a CUDA device and "torch" on the CPU.  "cuda_sharded" /
    #: "torch_sharded" run either per shard of a process group, with a halo
    #: exchange between depths (every rank runs the invocation in full)
    field_backend: Optional[str] = None
    #: sharded backends only — how vertices are dealt to shards: "stripe"
    #: (contiguous id ranges), "partition" (dealt along the live TAPER
    #: partition vector, k -> S folded; OnlineTaper re-deals on commit) or
    #: "bfs" (locality order for graphs with no partition yet)
    shard_map_source: str = "stripe"
    #: sharded backends only — per-depth halo exchange: "sliced" (hot union
    #: plus per-shard-pair ring slices; bytes scale with what each shard
    #: reads) or "psum" (one all_reduce of the union frontier)
    halo_exchange: str = "sliced"
    #: skip a commit-time shard re-deal when fewer than this fraction of
    #: vertices would change shard (avoids repacking churn on converged
    #: partitions)
    redeal_min_moved_frac: float = 0.01
    star_max: int = 3
    trie_max_len: Optional[int] = None
    seed: int = 0

    def swap_config(self) -> SwapConfig:
        return SwapConfig(
            candidates_per_part=self.candidates_per_part,
            family_threshold=self.family_threshold,
            family_max_size=self.family_max_size,
            balance_eps=self.balance_eps,
            min_gain=self.min_gain,
            safe_introversion=self.safe_introversion,
            rank_by=self.rank_by,
        )


@dataclass
class TaperReport:
    """Trace of one TAPER invocation."""

    parts: List[np.ndarray] = dfield(default_factory=list)   # per iteration
    objective: List[float] = dfield(default_factory=list)    # total extroversion
    moves: List[int] = dfield(default_factory=list)
    stats: List[SwapStats] = dfield(default_factory=list)
    iterations: int = 0
    total_moves: int = 0
    #: host-clock seconds of each field evaluation (the result is read back
    #: to the host, so device work is included) and of each swap iteration
    field_seconds: List[float] = dfield(default_factory=list)
    swap_seconds: List[float] = dfield(default_factory=list)
    #: under a sharded field backend, each evaluation's halo statistics
    #: (the field's ``_precomputed["_halo_stats"]``: bytes per depth, halo
    #: ratio, shard map, exchange, shards, depth steps)
    halo_stats: List[Dict] = dfield(default_factory=list)

    @property
    def final_part(self) -> np.ndarray:
        return self.parts[-1]

    @property
    def improvement(self) -> float:
        if not self.objective or self.objective[0] <= 0:
            return 0.0
        return 1.0 - self.objective[-1] / self.objective[0]


class Taper:
    """Workload-aware partition enhancer over a graph that may mutate
    between invocations (``LabelledGraph.apply_mutations``)."""

    def __init__(self, g: LabelledGraph, k: int,
                 config: Optional[TaperConfig] = None,
                 device: DeviceLike = None):
        self.g = g
        self.k = k
        self.config = config or TaperConfig()
        self.device = resolve_device(device)
        # partition-independent precomputes shared across invocations; the
        # field also caches its device-resident edge arrays in here, so only
        # the partition vector is uploaded per iteration.  All of it is keyed
        # to the graph's mutation version: after ``g.apply_mutations`` the
        # host counts are re-fetched (the graph patches them incrementally)
        # and the visitor replaces its stale device buffers.
        self._pre = {
            "cnt": g.cached_neighbor_label_counts(),
            "lab_vcount": g.label_counts(),
        }
        self._g_version = g.version
        self._rng = np.random.default_rng(self.config.seed)
        # §4.2 lazy re-evaluation state: compiled trie + memoised fields are
        # reused across invocations while the TPSTry is unchanged.  The
        # per-instance signature (not just the trie's shared snapshot, which
        # any other Taper or caller may refresh) guards cache validity.
        self._trie_ref: Optional[TPSTry] = None
        self._trie_sig: Optional[Tuple] = None
        self._snapshot_key = f"taper:{id(self):x}"
        self._arrays_cache: Optional[TrieArrays] = None
        # single-entry memo: only a repeat evaluation of the latest
        # (trie, partition) pair can hit, and one ExtroversionResult is
        # O(n*N + m + n*k) floats — don't pin more than one
        self._field_memo: Optional[Tuple[Tuple, ExtroversionResult]] = None
        self._redeal_counter = 0
        # observability (optional; wired by the serving loop): when a
        # tracer is attached and ``trace_ctx`` is a sampled invocation
        # trace, field evaluations / swap iterations / shard re-deals emit
        # spans under it.  Both default to off — a bare Taper pays nothing.
        self.tracer = None
        self.trace_ctx = None

    def _span(self, name: str, **attrs):
        """Open a span on the attached invocation trace (no-op span when
        no tracer/context is wired)."""
        if self.tracer is None or self.trace_ctx is None:
            from repro_torch.obs.trace import NOOP_SPAN

            return NOOP_SPAN
        return self.tracer.start(name, self.trace_ctx, **attrs)

    def __del__(self):
        # release this instance's snapshot slot on a shared, long-lived trie
        trie = getattr(self, "_trie_ref", None)
        if trie is not None:
            trie.drop_snapshot(self._snapshot_key)

    @staticmethod
    def _tpstry_signature(trie: TPSTry) -> Tuple:
        """Cheap per-instance identity of a TPSTry's topology+probabilities."""
        return (
            tuple(nd.parent for nd in trie.nodes),
            tuple(nd.symbol for nd in trie.nodes),
            np.array([nd.p for nd in trie.nodes], dtype=np.float64).tobytes(),
        )

    def _sync_graph(self) -> None:
        """Refresh graph-derived host state after topology mutations.

        Device-buffer refresh happens inside ``repro_torch.core.visitor``
        (it compares the version recorded next to the buffers); here we
        re-fetch the incrementally-patched host count arrays and drop the
        field memo, which was computed against the old topology."""
        if self._g_version != self.g.version:
            self._pre["cnt"] = self.g.cached_neighbor_label_counts()
            self._pre["lab_vcount"] = self.g.label_counts()
            self._field_memo = None
            self._g_version = self.g.version

    def _frontier_mask(self, frontier: np.ndarray) -> np.ndarray:
        """Dirty-frontier candidate mask: the mutated vertices plus their
        1-hop neighbourhood (a mutation changes the extroversion of both
        endpoints' neighbourhoods)."""
        g = self.g
        mask = np.zeros(g.n, dtype=bool)
        vs = np.asarray(frontier, dtype=np.int64).reshape(-1)
        vs = vs[(vs >= 0) & (vs < g.n)]
        mask[vs] = True
        if vs.size:
            mask[g.dst[g.edge_indices_of(vs)].astype(np.int64)] = True
        return mask

    @property
    def _sharded(self) -> bool:
        return self.config.field_backend in SHARDED_BACKENDS

    def _group_shards(self) -> int:
        """Shard count of the field's process group: ``_pre["_group"]``'s
        size, else the default group's (every rank of it), else 1 — the
        one-rank group the sharded field would make."""
        import torch.distributed as dist

        group = self._pre.get("_group")
        if group is not None:
            return dist.get_world_size(group)
        return dist.get_world_size() if dist.is_initialized() else 1

    def _seed_shard_order(self, part: np.ndarray) -> None:
        """Resolve the sticky shard map now (idempotent) so the field memo
        key is stable from the first evaluation on."""
        cfg = self.config
        if (not self._sharded or cfg.shard_map_source == "stripe"
                or "_shard_order" in self._pre):
            return
        from repro_torch.graphs.sharded_packing import compute_shard_order

        self._pre["_shard_order"] = (
            f"{cfg.shard_map_source}:0",
            compute_shard_order(self.g, cfg.shard_map_source,
                                self._group_shards(), part=part))

    def maybe_redeal_shards(self, part: np.ndarray,
                            n_shards: Optional[int] = None) -> bool:
        """Refresh the sharded field's shard map along ``part``.

        Applies only under a sharded field backend with
        ``shard_map_source="partition"``.  Computes the fresh
        partition-dealt vertex order and installs it in the precompute
        dict; the next field evaluation re-packs (and re-uploads) along it
        — callers invoke this *off the invocation's critical path*
        (``OnlineTaper.commit_invocation`` does, right after the partition
        swap).  Skipped (returns ``False``) when fewer than
        ``redeal_min_moved_frac`` of vertices would change shard, so a
        converged partitioning never thrashes the packing."""
        cfg = self.config
        if not self._sharded or cfg.shard_map_source != "partition":
            return False
        if n_shards is None:
            n_shards = self._group_shards()
        from repro_torch.graphs.sharded_packing import partition_shard_order

        new_pos = partition_shard_order(part, n_shards)
        cur = self._pre.get("_shard_order")
        if cur is not None:
            _, cur_pos = cur
            n0 = min(cur_pos.shape[0], new_pos.shape[0])
            # the packing's true per-shard span (block-padded); the live
            # packing knows it exactly, else reconstruct from the default
            # block_n the field path uses
            sdev = self._pre.get("_shard_dev")
            if sdev is not None and sdev["sp"].n_shards == n_shards:
                span = sdev["sp"].n_local_pad
            else:
                nb = max(1, -(-new_pos.shape[0] // 128))
                span = -(-nb // n_shards) * 128
            moved = (float(np.mean(
                new_pos[:n0] // span != cur_pos[:n0] // span)) if n0 else 1.0)
            if moved < cfg.redeal_min_moved_frac:
                return False
        self._redeal_counter += 1
        self._pre["_shard_order"] = (
            f"partition:{self._redeal_counter}", new_pos)
        self._field_memo = None     # memoed field keyed on the old layout
        if self.tracer is not None and self.trace_ctx is not None:
            self.tracer.event("invocation.redeal", self.trace_ctx,
                              redeal_epoch=self._redeal_counter,
                              n_shards=int(n_shards))
        log.info("re-dealt shard map along partition (epoch %d)",
                 self._redeal_counter)
        return True

    def set_field_backend(self, backend: str) -> None:
        """Switch the extroversion-field DP engine in place.

        The serving loop's graceful-degradation ladder calls this to fall
        from ``cuda_sharded`` toward ``torch`` on repeated device failure
        (and to probe back up).  Device-resident caches in ``_pre`` are
        keyed per backend so they survive the round trip; only the field
        memo (keyed on the old backend) is dropped.  Every rung runs on the
        Taper's ``device``: ``torch`` on a CUDA Taper is the plain field on
        the card."""
        if backend not in FIELD_BACKEND_LADDER:
            raise ValueError(f"unknown field backend {backend!r}")
        if backend == self.config.field_backend:
            return
        self.config.field_backend = backend
        self._field_memo = None

    # -- workload handling ---------------------------------------------------
    def build_trie(self, workload: Workload) -> TPSTry:
        return TPSTry.from_workload(
            workload, max_len=self.config.trie_max_len, star_max=self.config.star_max
        )

    # -- the core API ----------------------------------------------------------
    def field(
        self, part: np.ndarray, trie: Union[TPSTry, TrieArrays]
    ) -> ExtroversionResult:
        self._sync_graph()
        arrays = (
            trie if isinstance(trie, TrieArrays) else trie.compile(self.g.label_names)
        )
        cfg = self.config
        # resolve the sticky shard map before keying the memo, so the first
        # sharded evaluation doesn't memoize under a pre-install key
        self._seed_shard_order(np.asarray(part))
        # §4.2 lazy re-evaluation: if neither the trie probabilities nor the
        # partition changed since the last evaluation, the field is reused
        # verbatim instead of recomputed
        memo_key = (
            arrays.topology_signature(),
            arrays.p.tobytes(),
            arrays.cond_p.tobytes(),
            np.asarray(part, dtype=np.int32).tobytes(),
            cfg.depth_cap, cfg.dense_ext_to, cfg.field_backend,
            cfg.halo_exchange, self._pre.get("_shard_order", (None,))[0],
            self.k, self.g.version,
        )
        if self._field_memo is not None and self._field_memo[0] == memo_key:
            return self._field_memo[1]
        with self._span("invocation.field",
                        backend=cfg.field_backend) as sp:
            fld = extroversion_field(
                self.g,
                arrays,
                part,
                self.k,
                depth_cap=cfg.depth_cap,
                _precomputed=self._pre,
                dense_ext_to=cfg.dense_ext_to,
                backend=cfg.field_backend,
                device=self.device,
                shard_map_source=cfg.shard_map_source,
                halo_exchange=cfg.halo_exchange,
            )
            hs = self._pre.get("_halo_stats")
            if hs:
                sp.set(halo_bytes_per_depth=hs.get("halo_bytes_per_depth", 0),
                       halo_ratio=hs.get("halo_ratio", 0.0),
                       depth_steps=hs.get("depth_steps", 0),
                       n_shards=hs.get("n_shards", 0))
                if self.tracer is not None and self.trace_ctx is not None:
                    # per-depth accounting: one instant marker per DP depth
                    # step, each carrying the bytes its halo exchange moved
                    for d in range(int(hs.get("depth_steps", 0))):
                        self.tracer.event(
                            "field.depth", self.trace_ctx, depth=d + 1,
                            halo_bytes=hs.get("halo_bytes_per_depth", 0))
        self._field_memo = (memo_key, fld)
        return fld

    def _timed_field(self, part, arrays, report: TaperReport):
        t0 = time.perf_counter()
        fld = self.field(part, arrays)
        report.field_seconds.append(time.perf_counter() - t0)
        if self._sharded:
            report.halo_stats.append(dict(self._pre["_halo_stats"]))
        return fld

    def invoke(
        self,
        part: np.ndarray,
        workload: Union[Workload, TPSTry, TrieArrays],
        max_iterations: Optional[int] = None,
        frontier: Optional[np.ndarray] = None,
        should_abort: Optional[Callable[[], bool]] = None,
    ) -> TaperReport:
        """One TAPER invocation (def. 1): enhance ``part`` for the workload.

        ``frontier`` (optional vertex-id array) runs a *mutation-local*
        invocation: the swap candidate queue is seeded only from the dirty
        frontier (the given vertices plus their 1-hop neighbourhood), and
        grows with each iteration's moved vertices so improvements can
        propagate outward — paper §5.5's queue pruning generalised to
        topology deltas.

        ``should_abort`` (optional zero-arg callable) is polled at iteration
        boundaries; returning True raises :class:`InvocationAborted` — the
        cooperative cancel a serving watchdog uses on an abandoned run, so
        the thread releases the graph-immutability window promptly instead
        of finishing work nobody will commit.
        """
        self._sync_graph()
        if should_abort is not None and should_abort():
            raise InvocationAborted("invocation aborted before start")
        if isinstance(workload, TrieArrays):
            arrays = workload
        elif isinstance(workload, TPSTry):
            # §4.2 lazy re-evaluation: skip recompiling (and, via the field
            # memo, recomputing) when the trie is unchanged.  The shared
            # snapshot is a fast pre-check only — another Taper (or caller)
            # may have re-snapshotted after a drift, so validity rests on
            # this instance's own signature of what it compiled.
            sig = None
            if (
                self._trie_ref is workload
                and self._arrays_cache is not None
            ):
                if not workload.changed_since_snapshot(
                        key=self._snapshot_key).any():
                    sig = self._tpstry_signature(workload)
            if sig is not None and sig == self._trie_sig:
                arrays = self._arrays_cache
            else:
                if self._trie_ref is not None and self._trie_ref is not workload:
                    # leaving a trie behind: release our slot on it
                    self._trie_ref.drop_snapshot(self._snapshot_key)
                arrays = workload.compile(self.g.label_names)
                self._trie_ref = workload
                self._trie_sig = self._tpstry_signature(workload)
                self._arrays_cache = arrays
            # private snapshot slot: never clobbers the default-slot snapshot
            # a caller may be polling for its own drift detection
            workload.snapshot(key=self._snapshot_key)
        else:
            arrays = self.build_trie(workload).compile(self.g.label_names)

        cfg = self.config
        part = np.asarray(part, dtype=np.int32).copy()
        report = TaperReport()
        report.parts.append(part.copy())

        fld = self._timed_field(part, arrays, report)
        report.objective.append(fld.total_extroversion)
        log.info(
            "taper invoke: n=%d k=%d trie_nodes=%d objective0=%.4f",
            self.g.n, self.k, arrays.n_nodes, fld.total_extroversion,
        )

        cand_mask = None
        if frontier is not None:
            cand_mask = self._frontier_mask(frontier)

        iters = max_iterations or cfg.max_iterations
        for it in range(iters):
            if should_abort is not None and should_abort():
                raise InvocationAborted(
                    f"invocation aborted at iteration {it + 1}")
            t0 = time.perf_counter()
            with self._span("invocation.swap", iteration=it + 1) as swap_sp:
                new_part, stats = swap_iteration(
                    self.g, part, fld, self.k, cfg.swap_config(), self._rng,
                    candidate_mask=cand_mask)
                swap_sp.set(moves=stats.moves)
            report.swap_seconds.append(time.perf_counter() - t0)
            if stats.moves == 0:
                log.info("iteration %d: no moves, converged", it + 1)
                break
            if cand_mask is not None:
                # let the frontier follow the moves: moved vertices and
                # their neighbourhoods become candidates next iteration
                moved_now = np.nonzero(new_part != part)[0]
                cand_mask |= self._frontier_mask(moved_now)
            part = new_part
            fld = self._timed_field(part, arrays, report)
            report.parts.append(part.copy())
            report.objective.append(fld.total_extroversion)
            report.moves.append(stats.moves)
            report.stats.append(stats)
            report.iterations = it + 1
            report.total_moves += stats.moves
            log.info(
                "iteration %d: moves=%d objective=%.4f (%.1f%% of start)",
                it + 1, stats.moves, fld.total_extroversion,
                100.0 * fld.total_extroversion / max(report.objective[0], 1e-30),
            )
            prev, cur = report.objective[-2], report.objective[-1]
            if prev > 0 and (prev - cur) / prev < cfg.converge_rel_tol and it >= 1:
                log.info("objective improvement < %.2f%%, stopping", 100 * cfg.converge_rel_tol)
                break
        return report
