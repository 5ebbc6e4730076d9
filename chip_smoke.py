#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on the machine with the card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit; build the CUDA kernels from the sources
   in the checkout (``nvcc``, ``sm_90a``, one process per source); count
   the tensor-core instructions (``HGMMA``, ``HMMA``) in the built
   attention libraries with ``cuobjdump -sass``: the bf16 kernel must have
   ``HGMMA`` (wgmma), the float32 kernel TF32 ``HMMA`` (its three-product
   mma.sync) and no ``HGMMA``;
2. each kernel against its plain PyTorch version on the card, over seeded
   shapes: ``vm_step`` (the transitions of workload tries: PQ, MQ, seeded
   label chains of one to four 32-column blocks and the row placement's
   677-node trie, 3 to 26 labels; empty rows, hub rows of 12k in-edges,
   all-cut weights, up to 100k rows), ``embedding_bag`` (d 8/17/64/128/256,
   H 1/3/8/9/64, an odd number of bags, the table and the output off their
   16-byte alignment, repeated, padded and out-of-range ids; bit for bit
   against the plain version on the CPU), ``segment_spmm`` (F 8/16/100 with
   float4 loads, 17 and a misaligned 100 with scalar loads, empty rows, a hub
   row of 10k edges, zero weights) and ``flash_attention``
   (Sq/Skv 1-1,111, causal and not, window None/1/17/64/129/200/1,024,
   GQA 1/2/4, D 32/64/128/256, float32 and bfloat16, rows with no valid
   key; bf16 goes to the wgmma kernel, float32 to the 3xTF32 one); then the
   plain scatter-adds (``scatter_sum``, ``vm_step_reference``,
   ``segment_spmm_reference``) twice on the card over 5M unsorted edges:
   bit for bit equal to each other and to the CPU's;
3. the paper's worked-example values through ``backend="cuda"``;
4. fig7 at N=2000 on the card (provgen and musicbrainz, hash start): the
   reference's final ipt exactly, and the kernel field bitwise equal to the
   plain field on the CPU; then online TAPER at N=2000
   (``benchmarks/online_topology.py``'s settings: an ``OnlineTaper`` over
   ten ticks of mixed mutations and a drifting workload, the kernel field):
   every tick's n, m, ipt, hash baseline, trigger and reason, and the four
   invocations, exactly the reference's; then the sharded field at N=2000
   on 4 gloo ranks spawned on the one card (``launch/mesh.py::run_ranks``;
   NCCL refuses two ranks on one card, so their CUDA tensors cross through
   pinned host buffers): fig7 through ``cuda_sharded`` (partition map,
   sliced exchange) with the reference's final ipt and the same partitions
   on every rank, and one field per shard map and exchange, each bitwise
   the ``cuda`` field; then the serving loop (``serve/``): the inline
   ``GraphQueryEngine`` over one fixed stream (musicbrainz N=2000, MQ1-3
   under the drift trigger, two mutation batches) with the ``cuda`` field
   on the card and the ``torch`` field on the CPU, every request's result,
   each partition after an invocation and the invocation count equal
   (4d); the degradation ladder on the card: four injected invocation
   faults walk ``cuda -> torch``, the ``torch`` rung's field on the card,
   a healthy commit probes back to ``cuda`` and the next commit launches
   ``vm_step`` (4e); ``benchmarks/serve_loop.py``'s setting with the
   ``cuda`` field (musicbrainz 20,000, 600 requests, 64 in flight, a
   mutation batch every 50), overlapped and then stop-the-world on the same
   stream, their throughput and latency printed (4f); then the replicated
   cluster (``serve/cluster.py``): the four chaos scenarios
   (``serve/chaos.py``: crash storm, slow follower, flash crowd, partition
   heal) with their clusters on the card, each green and its digest the
   JAX package's, its invocations launching ``vm_step`` on the ``cuda``
   rung (4g); ``benchmarks/cluster_failover.py``'s setting (musicbrainz
   20,000, heartbeat timeout 0.2 s, the ``cuda`` field): a follower cut
   off by a link partition heals by tail resync and is then bitwise its
   primary, a crashed primary's best follower promotes under epoch 2,
   answers and launches ``vm_step`` at its next invocation, a demoted node
   rejoined with its memory re-uploads its stale device inputs and
   evaluates the field bitwise like the promoted node, reads redirect
   around a crashed follower; the benchmark's three timing targets
   printed as met or NOT MET (4h);
5. path 1, TAPER at the paper's ProvGen scale: one ``Taper.invoke`` on
   ``provgen_like(1_000_000)``, k=8, PQ1-4, kernel field, with per-iteration
   field/kernel/swap times and each evaluation's split (its ``vm_step``
   launches, the rest of its wall time), a bitwise repeat of the field, one
   more evaluation under ``torch.profiler`` (host ops by self time, the
   device's busy time), and the kernel's time, bound, gather yardstick and
   plain-version time at those shapes; then the sharded field on that
   graph, each evaluation bitwise path 1's ``cuda`` field on the same
   partition: S=1 on an NCCL group in this process at the hash start and
   at the final partition, then 4 gloo ranks on the card at the final
   partition (partition map, sliced exchange, two evaluations a rank), with
   each evaluation's wall, exchange and ``vm_step`` device time, the halo
   bytes a depth and the halo ratio, the device memory before and after,
   and the kernel at shard 0's shapes (alpha the shard's rows and its
   halo); then the online path on that graph and final partition: an ``OnlineTaper`` over four ticks of mixed
   mutations (n/2000 new vertices and m/2000 churned edges a tick) with
   only the topology trigger live, so each invocation is mutation-local
   (3 iterations at most); per tick the host times of the batch,
   ``apply_mutations``, the arrival placement, the executor's patch, the
   swap and the field (its device inputs' rebuild apart), the ``vm_step``
   launches and their device time, the balance (at most 1.05) and ipt
   against the drifting hash baseline; then the patched graph against a
   fresh one built from its arrays (edges, reverse index, counts,
   ``vm_packing``, ``vm_csr`` with its row plan) and the patched executor
   against a rebuilt one, bit for bit, the kernel field on the final
   partition repeatable and equal to the plain field, the device memory
   no more than the first tick's plus the graph's growth, and the kernel
   at the path's last launch's shapes; then serving on path 1's graph and
   final partition: a ``ServingLoop`` with one worker and overlapped
   invocations (the ``cuda`` field, launched from the loop's invocation
   thread; the topology trigger only; snapshots and the WAL in a temporary
   directory; 5% of requests traced), a feeder keeping 64 PQ1-4 requests in
   flight and sending one mutation batch (n/2000 new vertices, m/2000
   churned edges) per invocation, two in all (cut from four to make room
   for the cluster path); every request answered,
   each invocation on the ``cuda`` rung with ``vm_step`` launches and
   requests served inside its window, its trace's field span on
   ``cuda``, the batched enumeration against the reference DFS on the
   final graph, and a restore from the snapshot and WAL bitwise the live
   loop; throughput in and out of the invocation windows, latency, the
   invocations' field, swap and commit times, snapshot and WAL bytes,
   restore time by part, the device's busy share and memory; then the
   replicated cluster on path 1's graph and final partition: an
   inline-driven primary ``ServingLoop`` (the ``cuda`` field, topology
   trigger only) and two followers bootstrapped from its seed snapshot on
   the card (``ClusterCoordinator``, heartbeat timeout 0.2 s, the default
   staleness bounds and hedging budgets); a fixed batch of 8 PQ1-4 reads
   routed; two mutation batches, each invocation committed and shipped,
   every follower then bitwise the primary (graph arrays, version,
   partition, dirty bits, invocations, RNG state); a third batch submitted
   and the primary crashed before it applies; the best follower promoted
   under epoch 2, bitwise the crashed primary, its first routed read (PQ1)
   answered, the next batch's invocation on its ``cuda`` rung from cold
   device inputs (their rebuild's seconds and bytes printed apart), its
   field tensors on ``cuda:0``; the zombie's snapshot publish fenced; the
   demoted node rejoined by a full bootstrap; every replica bitwise the
   promoted primary and the fixed batch routed equal to its own
   enumeration; per batch the apply, executor patch, follower applies and
   commit shipping latency, per invocation its field and swap, bootstrap,
   promotion, first answer and rejoin seconds, read batch times and hedged
   reads, device memory at five points, WAL and snapshot bytes, and the
   kernel at the promoted node's last launch's shapes;
6. path 2, DLRM serving at full ``dlrm-rm2`` width with ``multi_hot=8``
   (33,762,577 x 64 table on the card): 20 ``serve_p99`` and 3
   ``serve_bulk`` requests through ``serve_step``, kernel forward against
   plain forward, per-request latency and per-launch kernel time, one
   ``retrieval_step`` over 10^6 candidates, the bag kernel against its
   plain version on independent zipf ids over the whole table; the kernel's
   time, bound and ``F.embedding_bag``'s time on the zipf ids and at
   ``serve_bulk``;
7. path 3, TAPER's embedding-row placement (``benchmarks/dlrm_span.py``'s
   settings): ``coaccess_graph`` -> ``Taper.invoke`` (kernel field, 677-node
   trie) -> ``query_span``: the plain field's partitions and the JAX
   package's spans exactly, and the kernel's time, bound, gather yardstick
   and plain time at the path's shapes;
8. path 4, GCN inference (``gcn-cora``) on the ``ogb_products`` cell
   (2,449,029 nodes, 61,859,140 edges): three forwards, kernel forward
   against plain forward, and each kernel's time, bound, gather yardstick,
   plain time and library time at the path's shapes;
9. path 5, ``qwen3-4b`` serving at full width (bf16, random weights from
   seed 0): a batch of 4 requests of 4,096 tokens and one request of
   32,768 tokens, each prefilled through ``forward`` (one
   ``flash_attention`` launch per layer) and decoded greedily (16 and 8
   steps) from a copy of its cache; prefill and per-token decode times, the
   kernel's time per launch, its plain version's and SDPA's at both shapes,
   the kernel against the plain version on one captured layer's q/k/v at
   each shape, and the whole-path gate: the full-width model in float32 at
   2,048 tokens through the float32 kernel (its 36 launches counted) against
   the same forward through the plain version, and one decode step from its
   cache against the prefill; the float32 kernel's time at 4 x 4,096 with
   its bounds at the TF32 tensor-core and float32 CUDA-core rates and the
   time of SDPA's memory-efficient back end.

The gather yardstick of a ``segment_spmm`` or ``vm_step`` launch counts
the 32-byte sectors its live edges' gathered rows touch, once per edge,
beside every other input read once and the output written once; beside the
bound (each input byte once) it shows how much of a kernel's gap is the
graph's randomness.  Each path runs with every kernel's launch count set to
0 just before it and read just after; a path that launched none of its
kernels fails.  The line
before the last is the ``kernels`` JSON record (``vm_step`` on six paths:
the provgen invocation, the sharded field, the online path, the serving
path, the cluster path and the placement); the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: fig7 at N=2000 (benchmarks/fig7_convergence.py, BENCH_PR5..PR10.json)
FIG7_FINAL = {"provgen": 908300, "musicbrainz": 96536}
PQ = ["Entity.(Entity)*.Entity", "Agent.Activity.Entity.Entity.Activity.Agent",
      "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"]
PQ_FREQ = (0.4, 0.2, 0.2, 0.2)
MQ = ["Area.Artist.(Artist|Label).Area",
      "Artist.Credit.(Track|Recording).Credit.Artist",
      "Artist.Credit.Track.Medium"]
MQ_FREQ = (0.2, 0.3, 0.5)
#: benchmarks/online_topology.py at N=2000 on the card (BENCH_PR5..PR10.json,
#: online_topology/tick0..9): per tick n, m, ipt, the drifting hash
#: baseline's ipt, below it, invoked, reason; and the invocations in all
ONLINE_2000 = [
    (2002, 8976, 199000, 263979, True, False, "-"),
    (2004, 8986, 113836, 150725, True, False, "-"),
    (2006, 8998, 39768, 52338, True, True, "topology"),
    (2008, 9008, 11044, 12795, True, False, "-"),
    (2010, 9020, 28372, 36457, True, True, "workload"),
    (2012, 9032, 88714, 120210, True, False, "-"),
    (2014, 9044, 164200, 229778, True, True, "ipt"),
    (2016, 9056, 228322, 321839, True, False, "-"),
    (2018, 9068, 252401, 358224, True, False, "-"),
    (2020, 9078, 230615, 331805, True, True, "topology"),
]
ONLINE_2000_INVOCATIONS = 4
#: full-size cell: the paper's ProvGen scale (~1M vertices, paper §6.1)
FULL_N = 1_000_000
FULL_MAX_ITERS = 8
#: the online path on path 1's graph and partition: ticks of mixed
#: mutations (n/2000 new vertices, m/2000 churned edges a tick), queries
#: observed a tick, and the online invocations' iteration cap
ONLINE_TICKS = 4
ONLINE_BATCH = 300
ONLINE_MAX_ITERS = 3
#: slack per live tensor on the device-memory check of the online path:
#: the caching allocator counts a whole block as allocated, and leaves a
#: large block unsplit when less than 1 MiB of it would remain
ONLINE_MEM_SLACK = 1 << 20
#: the sharded field: gloo ranks sharing the card in the N=2000 phase and
#: on the full-size path (NCCL refuses two ranks on one card), the full-size
#: path's shard map and exchange, and its evaluations per rank count
SHARDED_RANKS = 4
SHARDED_MAPS = ("stripe", "partition", "bfs")
SHARDED_EXCHANGES = ("sliced", "psum")
SHARDED_FULL = ("partition", "sliced")
SHARDED_FULL_EVALS = 2
FIELD_NAMES = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to")
#: serving at N=2000 (phase 4d): rounds of requests through the inline
#: GraphQueryEngine (MQ1-3, the mix flipping half way), the rounds before
#: which a mutation batch is queued, and the drift trigger's threshold
SERVE_2000_ROUNDS = 8
SERVE_2000_BATCH = 30
SERVE_2000_MIXES = ((0.6, 0.3, 0.1), (0.1, 0.2, 0.7))
SERVE_2000_MUTATE_AT = (2, 5)
#: benchmarks/serve_loop.py's setting on the card (phase 4f)
SERVE_LOOP_N = 20000
SERVE_LOOP_REQUESTS = 600
SERVE_LOOP_MICRO_BATCH = 16
SERVE_LOOP_QUEUE = 128
SERVE_LOOP_IN_FLIGHT = 64
SERVE_LOOP_MUTATE_EVERY = 50
SERVE_LOOP_WARMUP = 32
#: serving at provgen 1M (path 5c): mutation batches (one invocation each;
#: two, cut from four to make room for the cluster path within the time
#: limit, each window still checked), completed requests before each batch, requests in flight and the
#: micro-batch, the path's cap, the trace sampling rate, the fixed
#: enumeration check's size and the progress lines' period.  After the
#: first batch of arrivals every micro-batch holding PQ2 takes 15-20 s,
#: whatever its size: PQ2's first chunk of 32 start vertices, the newest,
#: reaches hubs (17,327,460 frontier rows against 183,513 before), and the
#: duplicates of a query in a micro-batch pay one enumeration.  So a
#: micro-batch takes all 64 requests in flight (16 would serve a quarter as
#: many in the same time), and 64 more complete between a commit and the
#: next batch (400 would take minutes after the first batch)
SERVE_FULL_BATCHES = 2
SERVE_FULL_EVERY = 64
SERVE_FULL_IN_FLIGHT = 64
SERVE_FULL_MICRO_BATCH = 64
SERVE_FULL_CAP_S = 240.0
SERVE_FULL_SAMPLE = 0.05
SERVE_FULL_ENUM = 64
SERVE_FULL_LOG_S = 15.0
#: enumerations of the fixed batch in each arm of the field-beside-serving
#: measurement (alone, beside field evaluations, beside memoized calls)
SERVE_FULL_FIELD_REPS = 3
#: how soon after an invocation's window opens the worker is back in a
#: micro-batch (it starts the invocation's thread between micro-batches)
SERVE_FULL_DISPATCH_S = 0.05
#: how long any one wait of a serving phase may take before it fails
SERVE_WAIT_S = 120.0
#: the chaos scenarios on the card (phase 4g): each one's digest, the JAX
#: package's (SHA-256 over graph arrays, partition, dirty bits, RNG state,
#: counters and probe answers; tests/test_torch_chaos.py holds the port's
#: CPU run to it)
CHAOS_DIGESTS = {
    "crash_storm": "4758df45327b1c4f1551edd36bf76eb4ff4d0ea131e77f421f1aa90c1f14a717",
    "slow_follower": "e5a263a7918521e9a663f23d0d21bfaf684e2f87065982e694c3077f398a1dcb",
    "flash_crowd": "eeef98ee14101be81ba16b68e496dccfc7ae2667d4e29eb5408f1463bfdc1f83",
    "partition_heal": "3089839046207db048371c5dd27287e10f10d4cfae832f76e6eaad5da01f95e7",
}
#: benchmarks/cluster_failover.py's setting on the card (phase 4h): graph
#: size, reads a throughput leg, the catch-up tail's batches, the failover
#: leg's batches, heartbeat timeout, the promotion budget and micro-batch;
#: its targets: catch-up <= 4x the live apply (+0.25 s), first answer <=
#: heartbeat + budget, one-down reads >= 0.5x healthy
CLUSTER_N = 20000
CLUSTER_READS = 96
CLUSTER_TAIL = 40
CLUSTER_FAILOVER_BATCHES = 8
CLUSTER_HB_S = 0.2
CLUSTER_PROMOTION_BUDGET_S = 5.0
CLUSTER_MICRO_BATCH = 16
#: how long the failover leg waits for the promoted node's first invocation
CLUSTER_INVOKE_WAIT_S = 60.0
#: the replicated cluster at provgen 1M (path 5d): mutation batches
#: committed on the primary before it crashes, the fixed PQ1-4 read batch,
#: the path's cap
CLUSTER_FULL_BATCHES = 2
CLUSTER_FULL_READS = 8
CLUSTER_FULL_CAP_S = 300.0
#: kernel vs plain tolerance (float32; the sums run in different orders)
RTOL, ATOL = 1e-5, 1e-6
#: H100 SXM data-sheet peaks (NVIDIA H100 data sheet, dense, without
#: sparsity): HBM3 bytes/s, float32 (non-tensor) FLOP/s, bf16 and TF32
#: tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
#: embedding_bag and segment_spmm against their plain versions (the
#: tolerances of tests/test_torch_embedding_bag.py and
#: tests/test_torch_segment_spmm.py); model forwards kernel vs plain
BAG_RTOL, BAG_ATOL = 1e-4, 1e-5
SPMM_RTOL, SPMM_ATOL = 1e-4, 1e-4
DLRM_RTOL, DLRM_ATOL = 1e-5, 1e-6
GCN_RTOL, GCN_ATOL = 1e-4, 1e-5
#: DLRM serving: ids per field, requests per shape cell
DLRM_MULTI_HOT = 8
DLRM_REQUESTS = {"serve_p99": 20, "serve_bulk": 3}
#: row placement (benchmarks/dlrm_span.py): shards, and the spans the JAX
#: package's flow gives (hash, TAPER); tests/test_torch_dlrm.py holds the
#: port's CPU flow equal to that flow
SPAN_K = 64
SPAN_REFERENCE = (21.61865234375, 16.607177734375)
GCN_FORWARDS = 3
#: flash_attention against its plain version (tests/test_kernels.py's
#: tolerances per dtype)
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
#: ... and at the qwen3 path's shapes, where an output is ~0.01-0.04 (scores
#: ~N(0, 1) under QK-norm; a row averages thousands of v rows), at or below
#: bf16's 2e-2: the bf16 outputs within one bf16 step (2^-7 of the value)
#: plus 1e-3 of the output's RMS, and the same q, k, v in float32 at
#: ATTN_TOL["float32"]
ATTN_PATH_RTOL, ATTN_PATH_ATOL_RMS = 2.0 ** -7, 1e-3
#: qwen3-4b serving: request sets (batch, prompt tokens, greedy decode
#: steps).  A: train_4k's length; B: prefill_32k's length at batch 1 (the
#: cell's batch of 32 would need 155 GB of KV caches)
QWEN_SETS = {"4x4096": (4, 4096, 16), "1x32768": (1, 32768, 8)}
#: the full-width float32 whole-path gate: tokens, and the tolerance of the
#: logits through the kernel against those through the plain version
LM_GATE_TOKENS = 2048
LM_RTOL, LM_ATOL = 1e-4, 1e-4
#: the kernels' wrappers, by the name of their launch counter
KERNELS = {
    "vm_step": ("repro_torch.kernels.vm_step.ops", "vm_step"),
    "embedding_bag": ("repro_torch.kernels.embedding_bag.ops", "embedding_bag"),
    "segment_spmm": ("repro_torch.kernels.segment_spmm.ops", "segment_spmm_csr"),
    "flash_attention": ("repro_torch.kernels.flash_attention.ops", "flash_attention"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def _wrapper(name):
    import importlib

    module, attr = KERNELS[name]
    return getattr(importlib.import_module(module), attr)


def _launch_lock():
    from repro_torch.kernels import LAUNCH_LOCK

    return LAUNCH_LOCK


def reset_counts():
    """Every kernel's launch count to 0: a path starts here.  The counts
    are read and written under the wrappers' lock: the serving path
    launches from its invocation thread."""
    with _launch_lock():
        for name in KERNELS:
            _wrapper(name).launches = 0


def read_counts(path, needs):
    """The launch counts just after a path; fails if it launched none of
    the kernels in ``needs``."""
    with _launch_lock():
        counts = {name: _wrapper(name).launches for name in KERNELS}
    log(f"[{path}] kernel launches on the path: {counts}")
    for name in needs:
        check(counts[name] > 0, f"{path}: the path launched no {name} kernel")
    return counts


def _bound(bytes_moved, flops, peak_flops=PEAK_F32_FLOPS):
    """(bound in ms, "bytes" or "operations") on the data-sheet peaks."""
    t_b, t_f = bytes_moved / PEAK_BYTES_S, flops / peak_flops
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def device_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    from repro_torch.kernels.build import build_all

    t0 = time.perf_counter()
    libs = build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel source(s) ready in {dt:.2f} s")
    for name, lib in libs.items():
        report = lib.with_name(lib.name + ".log")
        text = report.read_text() if report.exists() else "(cached build)"
        for line in text.splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                log(f"[build] {name}: {line.strip()}")
            elif "spill" in line or "C7512" in line:
                log(f"[build] {name}: {line.strip()[:200]}")
    return libs


def tensor_core_instructions(libs):
    """``{library: (HGMMA count, HMMA count, TF32 HMMA count)}`` of the two
    attention kernels' libraries, from ``cuobjdump -sass``; fails unless the
    bf16 kernel has HGMMA (wgmma) and the float32 kernel has TF32 HMMA
    (``HMMA.1688.F32.TF32``: its three-TF32-product mma.sync) and no
    HGMMA.  That the float32 kernel's products carry float32 accuracy is
    held by its 2e-5 gate, not by the absence of tensor-core instructions."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in ("flash_attention_bf16", "flash_attention_f32"):
        sass = subprocess.run([tool, "-sass", str(libs[name])], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        counts[name] = (len(re.findall(r"\bHGMMA\b", sass)),
                        len(re.findall(r"\bHMMA\b", sass)),
                        len(re.findall(r"\bHMMA\.1688\.F32\.TF32\b", sass)))
        log(f"[build] {name}: {counts[name][0]} HGMMA, {counts[name][1]} HMMA "
            f"({counts[name][2]} HMMA.1688.F32.TF32) instructions in the SASS")
    check(counts["flash_attention_bf16"][0] > 0,
          "the bf16 attention kernel has no HGMMA (tensor-core) instruction")
    check(counts["flash_attention_f32"][2] > 0 and counts["flash_attention_f32"][0] == 0,
          "the float32 attention kernel has no TF32 HMMA, or has HGMMA")
    return counts


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------


def _trie_columns(workload, label_names):
    """T's column form ``(par, val)`` of a compiled workload trie."""
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.kernels.vm_step.ref import transition_columns

    arrays = TPSTry.from_workload(workload).compile(label_names)
    return transition_columns(arrays.parent, arrays.label, arrays.cond_p,
                              arrays.n_labels)


def _chain_trie(seed, L, n_queries, length):
    """Column form of the trie of ``n_queries`` seeded label chains of
    ``length`` labels over ``L`` labels."""
    import numpy as np
    from repro_torch.core.rpq import concat, label

    rng = np.random.default_rng(seed)
    w = [(concat(*(label(f"L{i}") for i in rng.integers(0, L, length))),
          1.0 / n_queries) for _ in range(n_queries)]
    return _trie_columns(w, [f"L{i}" for i in range(L)])


def _csr_case(torch, rng, n, e, par, val, hub=0, cut_frac=0.5, empty_frac=0.1,
              device="cuda"):
    """Seeded dst-sorted CSR inputs over a trie's column form ``(par,
    val)``: rows in ``empty_frac`` get no edges, ``hub`` edges all point at
    row 1, ``cut_frac`` of the weights are 0."""
    import numpy as np

    L, N = par.shape
    live = np.nonzero(rng.random(n) >= empty_frac)[0]
    dst = rng.choice(live, e)
    if hub:
        dst[:hub] = 1
    src = rng.integers(0, n, e)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    w = (rng.random(e) + 0.1).astype(np.float32)
    w[rng.random(e) < cut_frac] = 0.0
    t = lambda a, dt: torch.as_tensor(a, device=device).to(dt)  # noqa: E731
    return dict(
        alpha=t(rng.random((n, N)).astype(np.float32), torch.float32),
        par=t(par, torch.int32), val=t(val, torch.float32),
        row_ptr=t(row_ptr, torch.int32), src=t(src, torch.int32),
        w=t(w, torch.float32), row_label=t(rng.integers(0, L, n), torch.int32),
        dst=t(dst, torch.int64))


def _vm_args(c):
    """The wrapper's arguments: the CSR made once (checked and planned), as
    the field makes it."""
    import torch
    from repro_torch.kernels.segment_spmm.ops import EdgeCSR

    csr = EdgeCSR(c["row_ptr"], c["src"], torch.arange(c["src"].shape[0],
                                                       device=c["src"].device))
    return (c["alpha"], c["par"], c["val"], csr, c["w"], c["row_label"])


def _vm_plain(args):
    """The plain version of ``vm_step`` on the wrapper's arguments."""
    import torch
    from repro_torch.kernels.vm_step.ref import vm_step_reference

    alpha, par, val, csr, w, row_label = args
    row_ptr, src = csr.row_ptr, csr.src
    n_out = row_ptr.shape[0] - 1
    dst = torch.repeat_interleave(torch.arange(n_out, device=alpha.device),
                                  (row_ptr[1:] - row_ptr[:-1]).long())
    return vm_step_reference(alpha, par, val, src, dst, w, row_label[dst], n_out)


def _vm_bound(args):
    """(bound ms, by, bytes, FLOP, local edges, alpha bytes) of one
    ``vm_step`` launch: every input read once and the output written once
    (n_out rows); of alpha only the rows that live edges (w != 0) gather,
    which leaves out a shard's halo rows that only cut edges read; per local
    edge and trie column one gather-multiply, one scale and one add."""
    import torch

    alpha, par, val, csr, w, row_label = args
    N = alpha.shape[1]
    n_out = csr.row_ptr.shape[0] - 1
    L, E = par.shape[0], csr.src.shape[0]
    live = w != 0
    nz = int(live.sum())
    alpha_bytes = 4 * N * int(torch.unique(csr.src[live]).numel())
    bytes_moved = 4 * ((n_out + 1) + 2 * E + n_out + n_out * N + 2 * L * N) + alpha_bytes
    flops = 3 * nz * N
    return (*_bound(bytes_moved, flops), bytes_moved, flops, nz, alpha_bytes)


def _yardstick_text(gather_bytes, other_bytes, **times):
    """The gather-traffic yardstick of a launch: the bytes of the 32-byte
    sectors its live edges' gathered rows touch (one count per edge, as
    when no gathered row is found in L2), plus every other input read once
    and the output written once, its time at the HBM rate, and the share of
    it each of ``times`` (ms) reaches.  Beside the bound (each input byte
    once) it shows how much of a kernel's gap is the graph's randomness."""
    ms = (gather_bytes + other_bytes) / PEAK_BYTES_S * 1e3
    shares = ", ".join(f"{k} {ms / t:.3f}" for k, t in times.items())
    return (f"gather yardstick {gather_bytes} B of gathered sectors + {other_bytes} B "
            f"other, {ms:.4f} ms at {PEAK_BYTES_S / 1e12:.2f} TB/s; share reached: {shares}")


def _vm_gather_sectors(torch, args):
    """Bytes of the 32-byte sectors of alpha that one ``vm_step`` launch's
    live edges gather: lane c of an edge from s into a row of label l reads
    alpha[s, par[l, c]] for every column c < N."""
    import numpy as np

    alpha, par, val, csr, w, row_label = args
    row_ptr, src = csr.row_ptr, csr.src
    n, N = alpha.shape
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    lab = torch.repeat_interleave(row_label.long(), deg)
    live = w != 0
    base = alpha.data_ptr() % 32
    phase = ((base + src[live].long() * (4 * N)) % 32) // 4     # 0..7 floats
    par_np = par.cpu().numpy().astype(np.int64)
    # distinct sectors per (label, phase of the row start within a sector)
    table = np.array([[np.unique((4 * ph + 4 * par_np[l]) // 32).size
                       for ph in range(8)] for l in range(par_np.shape[0])], np.int64)
    sectors = torch.as_tensor(table, device=alpha.device)[lab[live], phase]
    return int(sectors.sum()) * 32


def kernel_sweep(torch) -> float:
    import numpy as np
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.kernels.vm_step.ops import vm_step

    pq = _trie_columns(_workload(PQ, PQ_FREQ), ["Entity", "Activity", "Agent"])
    mq = _trie_columns(_workload(MQ, MQ_FREQ),
                       musicbrainz_like(50, seed=13).label_names)
    cases = [
        # (name, n, e, (par, val), hub, cut_frac)
        ("provgen-PQ", 3000, 20000, pq, 0, 0.5),
        ("musicbrainz-MQ", 3000, 20000, mq, 0, 0.5),
        ("chains-L3", 3000, 20000, _chain_trie(1, 3, 8, 4), 0, 0.5),
        ("chains-L12-two-blocks", 3000, 20000, _chain_trie(2, 12, 16, 3), 0, 0.5),
        ("chains-L12-many-blocks", 3000, 20000, _chain_trie(3, 12, 40, 4), 0, 0.5),
        ("hub-12k", 20000, 60000, pq, 12000, 0.3),
        ("all-cut", 5000, 30000, pq, 0, 1.0),
        ("n100k-provgen-like", 100_000, 553_000, pq, 0, 0.5),
        ("n100k-musicbrainz-like", 100_000, 553_000, mq, 0, 0.5),
        ("placement-trie-hub-12k", 20000, 200_000, _span_columns(), 12000, 0.5),
    ]
    worst = 0.0
    for i, (name, n, e, (par, val), hub, cut) in enumerate(cases):
        c = _csr_case(torch, np.random.default_rng(100 + i), n, e, par, val,
                      hub=hub, cut_frac=cut)
        args = _vm_args(c)
        out = vm_step(*args)
        torch.cuda.synchronize()
        ref = _vm_plain(args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=RTOL, atol=ATOL))
        empty_rows = c["row_ptr"][1:] == c["row_ptr"][:-1]
        L, N = par.shape
        log(f"[kernel] vm_step {name}: n={n} E={e} N={N} L={L} "
            f"empty_rows={int(empty_rows.sum())} max_abs_err={err:.3e} "
            f"bitwise={bool(torch.equal(out, ref))} "
            f"allclose(rtol={RTOL}, atol={ATOL})={ok}")
        check(ok, f"vm_step kernel disagrees with its plain version on {name}")
        check(bool((out[empty_rows] == 0).all()),
              f"vm_step kernel wrote nonzero rows without edges on {name}")
        check(bool(torch.isfinite(out).all()), f"non-finite kernel output on {name}")
        worst = max(worst, err)
        if name == "n100k-provgen-like":
            # rows of even length: the kernel's cost per local edge without
            # the row-length skew of the main path's graph
            ms = _time_ms(torch, lambda: vm_step(*args), 20)
            nz = int((c["w"] != 0).sum())
            log(f"[kernel] vm_step {name} timing: {ms:.4f} ms, "
                f"{ms * 1e6 / nz:.3f} ns per local edge ({nz} local edges, "
                f"longest row {int((c['row_ptr'][1:] - c['row_ptr'][:-1]).max())})")
        del c, args, out, ref
    return worst


def _span_workload():
    """The row placement's workload: every ordered pair of the 26 fields
    (benchmarks/dlrm_span.py)."""
    from repro_torch.core.rpq import concat, label

    w = [(concat(label(f"F{i}"), label(f"F{j}")), 1.0)
         for i in range(26) for j in range(26) if i != j]
    return [(q, 1.0 / len(w)) for q, _ in w]


def _span_columns():
    """Column form of the row placement's 677-node trie over 26 labels."""
    return _trie_columns(_span_workload(), [f"F{f}" for f in range(26)])


def bag_sweep(torch) -> float:
    """``embedding_bag`` against its plain version on seeded shapes: every
    lane layout the kernel branches on (d 8/17/64/128/256: float4, float2
    and scalar rows, 2 to 32 lanes a bag, two passes at 256), slot tails
    (H 1/3/9 beside 8 and 64), an odd number of bags, the table one and two
    floats past a 16-byte boundary and the output one float past it;
    repeated ids (one row in every slot), -1 pads and ids past the table.
    Bit for bit against the plain version on the CPU, and within BAG_RTOL /
    BAG_ATOL of the plain version on the card."""
    import numpy as np
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference

    worst = 0.0
    V, B = 100_000, 4097
    for i, (d, H) in enumerate((d, H) for d in (8, 17, 64, 128, 256)
                               for H in (1, 3, 8, 9, 64)):
        rng = np.random.default_rng(300 + i)
        table = torch.as_tensor(rng.normal(size=(V, d)).astype(np.float32))
        ids = rng.integers(0, V, (B, H))
        ids[::3] = ids[::3, :1]                       # one row repeated H times
        ids[::5, -1] = -1                             # pad slots
        ids[::7, 0] = V + 11                          # past the table
        ids = torch.as_tensor(ids.astype(np.int32))
        ids_card = ids.to("cuda")
        for t_off, o_off in ((0, 0), (1, 1), (2, 0)):
            buf = torch.zeros(V * d + 4, device="cuda")
            tab = buf[t_off:t_off + V * d].view(V, d)
            tab.copy_(table)
            obuf = torch.empty(B * d + 4, device="cuda")
            for combiner in ("sum", "mean"):
                if o_off:
                    out = embedding_bag_cuda(tab, ids_card, combiner == "mean",
                                             out=obuf[o_off:o_off + B * d].view(B, d))
                else:
                    out = embedding_bag(tab, ids_card, combiner)
                torch.cuda.synchronize()
                ref = embedding_bag_reference(tab, ids_card, combiner)
                cpu = embedding_bag_reference(table, ids, combiner)
                err = float((out - ref).abs().max())
                ok = bool(torch.allclose(out, ref, rtol=BAG_RTOL, atol=BAG_ATOL))
                bitwise = bool(torch.equal(out.cpu(), cpu))
                log(f"[kernel] embedding_bag d={d} H={H} {combiner} table +{t_off} out "
                    f"+{o_off} floats: V={V} B={B} max_abs_err={err:.3e} "
                    f"allclose(rtol={BAG_RTOL}, atol={BAG_ATOL})={ok} bitwise vs the CPU "
                    f"plain version={bitwise}")
                check(ok and bitwise, f"embedding_bag kernel disagrees with its plain "
                                      f"version at d={d} H={H} {combiner}")
                worst = max(worst, err)
    return worst


def plain_repeat(torch):
    """The plain scatter-adds (``scatter_sum`` with and without a mask,
    ``vm_step_reference``, ``segment_spmm_reference`` with the chunk at its
    size and at 4,999 edges) twice on the card over unsorted destinations
    with a 10,000-edge hub row: the two results bit for bit equal, and equal
    to the CPU's."""
    import numpy as np
    import repro_torch.kernels.segment_spmm.ref as spmm_ref
    import repro_torch.models.gnn.common as common
    from repro_torch.kernels.vm_step.ref import vm_step_reference

    n, e = 100_000, 5_000_000
    rng = np.random.default_rng(900)
    dst = rng.integers(0, n // 2, e)
    dst[:10_000] = 5
    rng.shuffle(dst)
    dst = torch.as_tensor(dst)
    src = torch.as_tensor(rng.integers(0, n, e))
    mask = torch.as_tensor(rng.random(e) < 0.7)
    w = torch.as_tensor(rng.normal(size=e), dtype=torch.float32)
    L, N = 3, 23
    cases = {
        "scatter_sum": (common.scatter_sum, (torch.as_tensor(
            rng.normal(size=(e, 16)), dtype=torch.float32), dst, n)),
        "vm_step_reference": (vm_step_reference, (
            torch.as_tensor(rng.random((n, N)), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, N, (L, N)), dtype=torch.int32),
            torch.as_tensor(rng.random((L, N)), dtype=torch.float32), src, dst,
            w.abs(), torch.as_tensor(rng.integers(0, L, e)), n)),
        "segment_spmm_reference": (spmm_ref.segment_spmm_reference, (
            torch.as_tensor(rng.normal(size=(n, 100)), dtype=torch.float32),
            src.int(), dst.int(), w, n)),
    }
    cases["scatter_sum masked"] = (common.scatter_sum, cases["scatter_sum"][1] + (mask,))
    cases["segment_spmm_reference, 4,999-edge chunks"] = cases["segment_spmm_reference"]
    chunk = spmm_ref.CHUNK
    for name, (fn, args) in cases.items():
        spmm_ref.CHUNK = 4999 if "chunks" in name else chunk
        try:
            want = fn(*args)
            on_card = [a.to("cuda") if isinstance(a, torch.Tensor) else a for a in args]
            first, second = fn(*on_card), fn(*on_card)
            torch.cuda.synchronize()
        finally:
            spmm_ref.CHUNK = chunk
        repeat, same = bool(torch.equal(first, second)), bool(torch.equal(first.cpu(), want))
        log(f"[repeat] {name} on the card (E={e}, unsorted destinations, hub 10000): two "
            f"runs bitwise equal {repeat}; equal to the CPU's bitwise {same}")
        check(repeat and same, f"{name}: the plain version does not repeat on the card "
                               f"or differs from the CPU's")
        del on_card, first, second, want


def spmm_sweep(torch) -> float:
    """``segment_spmm`` against its plain version on seeded shapes."""
    import numpy as np
    from repro_torch.kernels.segment_spmm.ops import (csr_from_edges, segment_spmm_csr,
                                                      vector_width)
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_reference

    worst = 0.0
    n, e = 50_000, 500_000
    # F 8/16/100 with float4 loads; 17 and 100 on x one float into its
    # buffer with scalar loads
    for i, (F, offset) in enumerate(((8, 0), (16, 0), (100, 0), (17, 0), (100, 1))):
        rng = np.random.default_rng(400 + i)
        live = np.nonzero(rng.random(n) >= 0.1)[0]   # 10% of the rows get no edge
        dst = rng.choice(live, e)
        dst[:10_000] = live[1]                        # a hub row of 10k edges
        src = rng.integers(0, n, e)
        w = rng.normal(size=e).astype(np.float32)
        w[rng.random(e) < 0.2] = 0.0                  # masked edges
        t = lambda a, dt: torch.as_tensor(a, device="cuda").to(dt)  # noqa: E731
        buf = torch.zeros(n * F + 4, device="cuda")
        x = buf[offset:offset + n * F].view(n, F)
        x.copy_(t(rng.normal(size=(n, F)).astype(np.float32), torch.float32))
        csr = csr_from_edges(t(src, torch.int32), t(dst, torch.int32), n)
        wc = t(w, torch.float32)[csr.order].contiguous()
        out = segment_spmm_csr(x, csr, wc)
        torch.cuda.synchronize()
        # the plain version on the CPU: it adds in edge order, the kernel's
        # CSR order, so the two agree bit for bit
        ref = segment_spmm_reference(x.cpu(), torch.as_tensor(src), torch.as_tensor(dst),
                                     torch.as_tensor(w), n).to("cuda")
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=SPMM_RTOL, atol=SPMM_ATOL))
        bitwise = bool(torch.equal(out, ref))
        empty = csr.row_ptr[1:] == csr.row_ptr[:-1]
        log(f"[kernel] segment_spmm F={F} ({vector_width(x)}-float loads): n={n} E={e} "
            f"empty_rows={int(empty.sum())} hub=10000 max_abs_err={err:.3e} "
            f"allclose(rtol={SPMM_RTOL}, atol={SPMM_ATOL})={ok} bitwise={bitwise}")
        check(ok and bitwise, f"segment_spmm kernel disagrees with its plain version "
                              f"(CSR order, on the CPU) at F={F}")
        check(bool((out[empty] == 0).all()), "segment_spmm wrote nonzero empty rows")
        worst = max(worst, err)
    return worst


def _keys_per_row(sq, skv, causal, window):
    """How many keys each query row attends to (top-left causal, one-sided
    window)."""
    import numpy as np

    r = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, r + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, r - window + 1) if window is not None else np.zeros(sq, np.int64)
    return np.maximum(0, hi - lo)


def _attn_cases():
    """Seeded (b, sq, skv, kv, g, d, causal, window, dtype) cases."""
    import numpy as np

    fixed = [
        (1, 1, 1, 1, 1, 32, True, None, "float32"),
        (2, 1, 300, 2, 4, 64, False, None, "bfloat16"),          # one query row
        (1, 300, 1, 1, 2, 128, False, 17, "float32"),            # one key
        (1, 300, 100, 2, 2, 64, True, None, "float32"),          # rows past the last key
        (2, 129, 129, 2, 4, 128, True, 1024, "bfloat16"),
        (1, 257, 257, 1, 4, 256, True, 64, "float32"),
        (1, 100, 200, 1, 1, 256, False, 64, "bfloat16"),
        (1, 150, 100, 2, 2, 32, False, 17, "float32"),           # rows 116.. see no key
        (1, 1024, 1024, 2, 4, 128, True, None, "float32"),
        (2, 1024, 1024, 8, 4, 128, True, None, "bfloat16"),
        (1, 1024, 1024, 2, 2, 256, True, 1024, "bfloat16"),
        (1, 1024, 1024, 1, 1, 64, False, None, "float32"),
        # the tensor-core kernel: lengths off its 128-row tiles, Sq != Skv
        (1, 333, 517, 2, 2, 128, True, 200, "bfloat16"),
        (3, 77, 190, 1, 2, 32, False, 64, "bfloat16"),
        (1, 700, 650, 1, 1, 64, True, 129, "bfloat16"),
        (2, 1000, 1111, 2, 4, 256, False, 300, "bfloat16"),
        (1, 1100, 1100, 2, 4, 128, False, 1, "bfloat16"),
    ]
    rng = np.random.default_rng(500)
    drawn = [(int(rng.integers(1, 4)), int(rng.integers(1, 301)), int(rng.integers(1, 301)),
              int(rng.choice([1, 2])), int(rng.choice([1, 2, 4])), d,
              bool(rng.integers(0, 2)), [None, 17, 64, 1024][int(rng.integers(0, 4))], dt)
             for d in (32, 64, 128, 256) for dt in ("float32", "bfloat16") for _ in range(2)]
    return fixed + drawn


def attention_sweep(torch) -> dict:
    """``flash_attention`` against its plain version on seeded shapes;
    returns the largest error per dtype."""
    import numpy as np
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (b, sq, skv, kv, g, d, causal, window, dt) in enumerate(_attn_cases()):
        rng = np.random.default_rng(600 + i)
        dtype = getattr(torch, dt)
        q, k, v = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
                   .to(device="cuda", dtype=dtype)
                   for shape in ((b, sq, kv * g, d), (b, skv, kv, d), (b, skv, kv, d)))
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, causal, window)
        err = float((out.float() - ref.float()).abs().max())
        rtol, atol = ATTN_TOL[dt]
        ok = bool(torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol))
        dead = torch.as_tensor(_keys_per_row(sq, skv, causal, window) == 0)
        log(f"[kernel] flash_attention B={b} Sq={sq} Skv={skv} H={kv * g} KV={kv} D={d} "
            f"causal={causal} window={window} {dt}: max_abs_err={err:.3e} "
            f"rows without a key {int(dead.sum())} allclose(rtol={rtol}, atol={atol})={ok}")
        check(ok, f"flash_attention kernel disagrees with its plain version on case {i}")
        check(bool(torch.isfinite(out).all()), f"non-finite flash_attention output, case {i}")
        check(bool((out[:, dead.to(out.device)] == 0).all()),
              f"flash_attention: rows without a key are not 0 on case {i}")
        worst[dt] = max(worst[dt], err)
    return worst


# ---------------------------------------------------------------------------
# phase 3: paper values
# ---------------------------------------------------------------------------


def paper_values(device):
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.core.visitor import extroversion_field, vm_cell
    from repro_torch.graphs.generators import (paper_example_graph,
                                               paper_example_partition)

    g = paper_example_graph()
    w = [(parse_rpq("a.(b|c).(c|d)"), 0.5), (parse_rpq("(c|a).c.a"), 0.5)]
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    f = extroversion_field(g, arrays, paper_example_partition(), k=2,
                           backend="cuda", device=device)
    v3 = 2
    got = dict(pr=float(f.pr[v3]), extro_mass=float(f.extro_mass[v3]),
               extroversion=float(f.extroversion[v3]),
               introversion=float(f.introversion[v3]))
    want = dict(pr=0.5, extro_mass=0.0625, extroversion=0.125, introversion=0.875)
    log(f"[paper] v3 {got}")
    for k, v in want.items():
        check(abs(got[k] - v) <= 1e-7, f"paper value {k}(v3)={got[k]}, want {v}")
    row = vm_cell(g, arrays, [0, 1])
    check(max(abs(a - b) for a, b in zip(row, [0, 0, .25, .5, .25, 0])) <= 1e-7,
          f"VM row {row}")


# ---------------------------------------------------------------------------
# phase 4: fig7 at N=2000
# ---------------------------------------------------------------------------


def _workload(queries, freqs):
    from repro_torch.core.rpq import parse_rpq

    return [(parse_rpq(q), f) for q, f in zip(queries, freqs)]


def fig7(torch, device):
    import numpy as np
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.core.visitor import extroversion_field
    from repro_torch.graphs.generators import musicbrainz_like, provgen_like
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.workload.executor import QueryExecutor

    for name, gen, seed, w in (
            ("provgen", provgen_like, 11, _workload(PQ, PQ_FREQ)),
            ("musicbrainz", musicbrainz_like, 13, _workload(MQ, MQ_FREQ))):
        g = gen(2000, avg_degree=6.0, seed=seed)
        start = hash_partition(g.n, 8, seed=1)
        rep = Taper(g, 8, TaperConfig(max_iterations=8, seed=0),
                    device=device).invoke(start, w)
        ex = QueryExecutor(g)
        series = [round(ex.workload_ipt(w, p)) for p in rep.parts]
        final, want = series[-1], FIG7_FINAL[name]
        log(f"[fig7] {name} N=2000 iterations={rep.iterations} ipt={series} "
            f"final={final} reference={want} rel_diff={abs(final - want) / want:.5f}")
        check(final == want, f"fig7 {name}: final ipt {final}, reference {want}")
        # the kernel field against the plain field on the CPU, same state
        arrays = TPSTry.from_workload(w).compile(g.label_names)
        fc = extroversion_field(g, arrays, start, 8, backend="cuda", device=device)
        fp = extroversion_field(g, arrays, start, 8, backend="torch", device="cpu")
        same = all(np.array_equal(getattr(fc, k), getattr(fp, k))
                   for k in ("alpha", "pr", "edge_mass", "extro_mass",
                             "extroversion", "ext_to"))
        log(f"[fig7] {name} cuda field (card) == torch field (CPU) bitwise: {same}")
        check(same, f"fig7 {name}: the cuda field differs from the CPU field")


# ---------------------------------------------------------------------------
# phase 4b: online TAPER at N=2000
# ---------------------------------------------------------------------------


def online_2000(torch, device):
    """benchmarks/online_topology.py's settings with the kernel field: an
    OnlineTaper over a mixed mutation stream and a drifting workload, the
    executor's counts patched tick by tick; every tick's values are the
    reference's."""
    from repro_torch.core.online import OnlinePolicy, OnlineTaper
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.workload.executor import QueryExecutor
    from repro_torch.workload.stream import GraphMutationStream, WorkloadStream

    t_phase = time.perf_counter()
    g = musicbrainz_like(2000, 6.0, seed=13).copy()
    queries = [q for q, _ in _workload(MQ, MQ_FREQ)]
    ex = QueryExecutor(g)
    stream = WorkloadStream(queries, period=float(len(ONLINE_2000)), seed=3)
    muts = GraphMutationStream("mixed", seed=7, vertices_per_tick=max(2, g.n // 2000),
                               edges_per_tick=max(8, g.m // 2000))
    taper0 = Taper(g, 8, TaperConfig(max_iterations=4, seed=0), device=device)
    part0 = taper0.invoke(hash_partition(g.n, 8, seed=1), stream.workload()).final_part
    online = OnlineTaper(g, 8, part=part0, config=taper0.config, device=device,
                         policy=OnlinePolicy(cadence=4, dirty_fraction=0.05,
                                             drift_l1=0.35))
    online.observe(stream.sample(300))
    for q in queries:
        ex.traversals(q)
    for tick, want in enumerate(ONLINE_2000):
        stream.advance(1.0)
        online.observe(stream.sample(300))
        t0 = time.perf_counter()
        applied = g.apply_mutations(muts.next_batch(g))
        for q in queries:
            ex.traversals(q)
        t_maint = time.perf_counter() - t0
        online.ingest(applied)
        w_true = stream.workload()
        ipt_now = ex.workload_ipt(w_true, online.part)
        step = online.step(measured_ipt=ipt_now)
        if step.invoked:
            ipt_now = ex.workload_ipt(w_true, online.part)
        ipt_hash = ex.workload_ipt(w_true, hash_partition(g.n, 8, seed=1))
        got = (g.n, g.m, round(ipt_now), round(ipt_hash), bool(ipt_now < ipt_hash),
               step.invoked, step.reason or "-")
        log(f"[online2000] tick {tick}: n={got[0]} m={got[1]} ipt={got[2]} "
            f"hash_baseline={got[3]} below_baseline={got[4]} invoked={got[5]} "
            f"reason={got[6]} maintenance {t_maint * 1e3:.2f} ms; reference {want}")
        check(got == want, f"online N=2000 tick {tick}: {got}, reference {want}")
    log(f"[online2000] invocations={online.invocations} "
        f"(reference {ONLINE_2000_INVOCATIONS}); phase {time.perf_counter() - t_phase:.2f} s")
    check(online.invocations == ONLINE_2000_INVOCATIONS,
          f"online N=2000: {online.invocations} invocations, "
          f"reference {ONLINE_2000_INVOCATIONS}")


# ---------------------------------------------------------------------------
# phase 4c: the sharded field at N=2000, on gloo ranks sharing the card
# ---------------------------------------------------------------------------


def _field_digest(fld):
    """sha256 of each output of an extroversion field (dtype, shape, bytes)."""
    import hashlib

    import numpy as np

    out = {}
    for name in FIELD_NAMES:
        a = np.ascontiguousarray(getattr(fld, name))
        out[name] = hashlib.sha256(
            f"{a.dtype}{a.shape}".encode() + a.tobytes()).hexdigest()
    return out


def _sharded_2000_rank(rank, n_ranks, cases):
    """One rank of the N=2000 phase: fig7 through ``cuda_sharded``
    (partition map, sliced exchange), then one field evaluation per shard
    map and exchange at the hash start.  The workload comes as the parent's
    compiled trie, so trie columns match the parent's fields."""
    import torch
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.core.visitor import extroversion_field
    from repro_torch.kernels.vm_step.ops import vm_step

    vm_step.launches = 0
    out = {}
    for name, g, start, arrays in cases:
        rep = Taper(g, 8, TaperConfig(max_iterations=8, seed=0,
                                      field_backend="cuda_sharded",
                                      shard_map_source="partition",
                                      halo_exchange="sliced"),
                    device="cuda").invoke(start, arrays)
        fields, transport = {}, None
        for source in SHARDED_MAPS:
            for exchange in SHARDED_EXCHANGES:
                pre = {}
                fields[source, exchange] = _field_digest(extroversion_field(
                    g, arrays, start, 8, _precomputed=pre, backend="cuda_sharded",
                    device="cuda", shard_map_source=source, halo_exchange=exchange))
                transport = pre["_shard_exchange"]["transport"]
        out[name] = dict(parts=rep.parts, halo=rep.halo_stats[-1], fields=fields,
                         transport=transport)
    torch.cuda.synchronize()
    return out, vm_step.launches


def sharded_2000(torch, device):
    """fig7 at N=2000 with the sharded field on SHARDED_RANKS gloo ranks that
    share the card: the reference's final ipt exactly, the same partitions on
    every rank, and each shard map and exchange bitwise the cuda field."""
    import tempfile

    import numpy as np
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.core.visitor import extroversion_field
    from repro_torch.graphs.generators import musicbrainz_like, provgen_like
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.workload.executor import QueryExecutor

    t0 = time.perf_counter()
    cases, want, workloads = [], {}, {}
    for name, gen, seed, w in (
            ("provgen", provgen_like, 11, _workload(PQ, PQ_FREQ)),
            ("musicbrainz", musicbrainz_like, 13, _workload(MQ, MQ_FREQ))):
        g = gen(2000, avg_degree=6.0, seed=seed)
        start = hash_partition(g.n, 8, seed=1)
        arrays = TPSTry.from_workload(w).compile(g.label_names)
        cases.append((name, g, start, arrays))
        workloads[name] = w
        want[name] = _field_digest(extroversion_field(g, arrays, start, 8,
                                                      backend="cuda", device=device))
    with tempfile.TemporaryDirectory() as work:
        results = run_ranks(_sharded_2000_rank, SHARDED_RANKS, work, args=(cases,))
    launches = sum(r[1] for r in results)
    for name, g, _, _ in cases:
        ranks = [r[0][name] for r in results]
        parts = ranks[0]["parts"]
        check(all(len(r["parts"]) == len(parts) and all(
            np.array_equal(a, b) for a, b in zip(r["parts"], parts)) for r in ranks),
            f"sharded N=2000 {name}: the ranks' partitions differ")
        ex = QueryExecutor(g)
        series = [round(ex.workload_ipt(workloads[name], p)) for p in parts]
        halo = ranks[0]["halo"]
        log(f"[sharded2000] {name} S={SHARDED_RANKS} gloo ranks on the card "
            f"({ranks[0]['transport']}), partition map, sliced exchange: "
            f"iterations={len(parts) - 1} ipt={series} reference final "
            f"{FIG7_FINAL[name]}; halo {halo['halo_bytes_per_depth']} B a depth, "
            f"ratio {halo['halo_ratio']:.4f}")
        check(series[-1] == FIG7_FINAL[name],
              f"sharded N=2000 {name}: final ipt {series[-1]}, reference "
              f"{FIG7_FINAL[name]}")
        for key in ranks[0]["fields"]:
            same = all(r["fields"][key] == want[name] for r in ranks)
            log(f"[sharded2000] {name} {key[0]}/{key[1]}: every rank's "
                f"cuda_sharded field == cuda field bitwise: {same}")
            check(same, f"sharded N=2000 {name} {key}: differs from the cuda field")
    log(f"[sharded2000] vm_step launches in the ranks: {launches}; phase "
        f"{time.perf_counter() - t0:.2f} s")
    check(launches > 0, "sharded N=2000: no vm_step launch")


# ---------------------------------------------------------------------------
# phases 4d-4f: the serving loop on the card
# ---------------------------------------------------------------------------


def _wait_tickets(what, tickets, timeout=SERVE_WAIT_S):
    t_end = time.perf_counter() + timeout
    for t in tickets:
        check(t.wait(max(t_end - time.perf_counter(), 0.0)),
              f"{what}: a request did not complete within {timeout:.0f} s")


def _serve_2000_run(backend, device):
    """The fixed request stream of phase 4d through the inline engine:
    every RequestResult as (query, n_results, ipt), the partition after
    each invocation, the invocation count and the final stats."""
    import numpy as np
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.taper import TaperConfig
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.serve import GraphQueryEngine, ServeConfig
    from repro_torch.workload.stream import GraphMutationStream

    g = musicbrainz_like(2000, avg_degree=6.0, seed=13)
    scratch, batches = g.copy(), []
    muts = GraphMutationStream("mixed", seed=7, vertices_per_tick=4, edges_per_tick=16)
    for _ in SERVE_2000_MUTATE_AT:
        b = muts.next_batch(scratch)
        scratch.apply_mutations(b)
        batches.append(b)
    queries = [parse_rpq(q) for q in MQ]
    eng = GraphQueryEngine(
        g, hash_partition(g.n, 8, seed=1), 8,
        ServeConfig(min_requests_between_invocations=50, drift_threshold=0.2,
                    max_results_per_query=8,
                    taper=TaperConfig(max_iterations=4, seed=0, field_backend=backend)),
        device=device)
    rng = np.random.default_rng(5)
    results, parts = [], []
    for r in range(SERVE_2000_ROUNDS):
        if r in SERVE_2000_MUTATE_AT:
            eng.apply_mutations(batches.pop(0))
        mix = SERVE_2000_MIXES[0 if r < SERVE_2000_ROUNDS // 2 else 1]
        inv0 = eng.invocations
        out = eng.serve_batch([queries[i] for i in rng.choice(3, SERVE_2000_BATCH, p=mix)])
        results += [(x.query, x.n_results, x.ipt) for x in out]
        if eng.invocations != inv0:
            parts.append(eng.part.copy())
    return dict(results=results, parts=parts, invocations=eng.invocations,
                n=g.n, stats=eng.stats())


def serving_2000(torch, device):
    """The inline GraphQueryEngine over one fixed stream (musicbrainz N=2000
    seed 13, MQ1-3 under the drift trigger, two mutation batches): the
    ``cuda`` field on the card and the ``torch`` field on the CPU give the
    same results, partitions and invocations."""
    import numpy as np

    t0 = time.perf_counter()
    reset_counts()
    card = _serve_2000_run("cuda", device)
    launches = read_counts("serve2000", ["vm_step"])["vm_step"]
    cpu = _serve_2000_run("torch", "cpu")
    same_parts = (len(card["parts"]) == len(cpu["parts"]) and all(
        np.array_equal(a, b) for a, b in zip(card["parts"], cpu["parts"])))
    log(f"[serve2000] musicbrainz n={card['n']} k=8, {len(card['results'])} requests "
        f"in {SERVE_2000_ROUNDS} rounds, mutation batches before rounds "
        f"{SERVE_2000_MUTATE_AT}: invocations cuda {card['invocations']} / CPU torch "
        f"{cpu['invocations']}, total ipt {sum(r[2] for r in card['results'])} / "
        f"{sum(r[2] for r in cpu['results'])}; results equal "
        f"{card['results'] == cpu['results']}, partitions after each invocation "
        f"equal {same_parts}; cuda field_backend {card['stats']['field_backend']}, "
        f"vm_step launches {launches}; phase {time.perf_counter() - t0:.2f} s")
    check(card["invocations"] >= 2, "serve2000: fewer than 2 invocations")
    check(card["invocations"] == cpu["invocations"], "serve2000: invocation counts differ")
    check(card["results"] == cpu["results"], "serve2000: request results differ")
    check(same_parts, "serve2000: partitions after an invocation differ")
    check(card["stats"]["field_backend"] == "cuda"
          and card["stats"]["backend_fallbacks"] == 0,
          "serve2000: the card run left the cuda rung")


def ladder_on_card(torch, device):
    """The degradation ladder on the card (the twin of
    tests/test_faults.py's fallback test): four injected invocation faults
    walk ``cuda -> torch``, whose field runs on the card; a healthy commit
    probes back to ``cuda``, and one more invocation commits there through
    the kernel."""
    import repro_torch.core.visitor as visitor
    from repro_torch.core.online import OnlinePolicy
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.taper import TaperConfig
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.kernels.vm_step.ops import vm_step
    from repro_torch.serve import ServeLoopConfig, ServingLoop
    from repro_torch.serve.faults import SITE_INVOCATION, FaultInjector, InjectedFault

    t0 = time.perf_counter()
    mq1 = parse_rpq(MQ[0])
    fi = FaultInjector()
    loop = ServingLoop(
        musicbrainz_like(300, seed=21), 4,
        taper_config=TaperConfig(max_iterations=2, field_backend="cuda"),
        policy=OnlinePolicy(bootstrap_after_ticks=0, cadence=1, min_interval=0,
                            dirty_fraction=2.0, drift_l1=9e9, ipt_regression=9e9),
        config=ServeLoopConfig(micro_batch=4, overlap_invocations=False, faults=fi,
                               invocation_retry_backoff_s=0.0,
                               backend_fallback_after=2, backend_probe_after=1),
        device=device)
    fields = []                               # (backend, device of alpha)
    field = visitor._field

    def traced_field(*args, **kwargs):
        out = field(*args, **kwargs)
        fields.append((args[7], out[0].device))
        return out

    def pump_until(what, cond):
        t_end = time.perf_counter() + SERVE_WAIT_S
        while not cond():
            check(time.perf_counter() < t_end, f"ladder: {what} within {SERVE_WAIT_S:.0f} s")
            loop.submit(mq1)
            try:
                loop.pump()
            except InjectedFault:
                pass                      # the inline drive re-raises it

    visitor._field = traced_field
    try:
        fi.arm(SITE_INVOCATION, times=4)
        pump_until("4 injected faults", lambda: fi.fired_total() >= 4)
        s = loop.stats()
        log(f"[ladder] after 4 injected invocation faults: field_backend "
            f"{s['field_backend']}, backend_fallbacks {s['backend_fallbacks']}, "
            f"invocation_failures {s['invocation_failures']}, degraded {s['degraded']}, "
            f"served {s['completed']}")
        check(s["field_backend"] == "torch" and s["backend_fallbacks"] == 1
              and s["degraded"] == 1 and s["invocation_failures"] == 4,
              "ladder: the walk cuda -> torch did not happen as expected")
        n_fields = len(fields)
        pump_until("the probe back to cuda", lambda: loop.stats()["backend_recoveries"] >= 1)
        on_torch = fields[n_fields:]
        log(f"[ladder] healthy commit on the torch rung: field evaluations "
            f"{[(b, str(d)) for b, d in on_torch]}")
        check(on_torch and all(b == "torch" and d.type == "cuda" for b, d in on_torch),
              "ladder: the torch rung's field did not run on the card")
        s = loop.stats()
        check(s["field_backend"] == "cuda" and s["degraded"] == 0,
              "ladder: the probe did not climb back to cuda")
        with _launch_lock():
            l0 = vm_step.launches
        inv0, n_fields = loop.ot.invocations, len(fields)
        pump_until("one more commit on cuda", lambda: loop.ot.invocations > inv0)
        with _launch_lock():
            l1 = vm_step.launches
        on_cuda = fields[n_fields:]
        s = loop.stop()
    finally:
        visitor._field = field
    log(f"[ladder] probe recovered to {s['field_backend']} (backend_recoveries "
        f"{s['backend_recoveries']}); the next invocation's fields "
        f"{[(b, str(d)) for b, d in on_cuda]}, vm_step launches {l1 - l0}; "
        f"phase {time.perf_counter() - t0:.2f} s")
    check(on_cuda and all(b == "cuda" for b, _ in on_cuda) and l1 > l0,
          "ladder: the commit after the probe did not run the kernel")


def _serve_loop_run(device, overlap, schedule):
    """One run of benchmarks/serve_loop.py's setting with the ``cuda`` field:
    warm-up, then SERVE_LOOP_REQUESTS requests with a mutation batch of
    ``schedule`` every SERVE_LOOP_MUTATE_EVERY; returns (stats, wall,
    rejections)."""
    from repro_torch.core.online import OnlinePolicy
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.taper import TaperConfig
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.serve import ServeLoopConfig, ServingLoop
    from repro_torch.serve.metrics import ServeMetrics
    from repro_torch.workload.stream import WorkloadStream

    g = musicbrainz_like(SERVE_LOOP_N, avg_degree=6.0, seed=13)
    loop = ServingLoop(
        g, 8, taper_config=TaperConfig(max_iterations=3, field_backend="cuda"),
        policy=OnlinePolicy(bootstrap_after_ticks=0, cadence=6, min_interval=1,
                            dirty_fraction=0.02, drift_l1=0.6),
        config=ServeLoopConfig(micro_batch=SERVE_LOOP_MICRO_BATCH,
                               max_queue_depth=SERVE_LOOP_QUEUE,
                               overlap_invocations=overlap, batch_wait_s=0.002,
                               stop_timeout_s=SERVE_WAIT_S),
        device=device).start()
    ws = WorkloadStream([parse_rpq(q) for q in MQ], period=6.0, seed=3)
    rejections = [0]

    def drive(budget, sched):
        tickets, offered, n_sched = [], 0, len(sched)
        t_end = time.perf_counter() + SERVE_WAIT_S
        t0 = time.perf_counter()
        while offered < budget:
            check(time.perf_counter() < t_end, "serve_loop: the feeder stalled")
            pending = sum(1 for t in tickets if not t.done.is_set())
            chunk = min(budget - offered, max(0, SERVE_LOOP_IN_FLIGHT - pending))
            if chunk == 0:
                time.sleep(0.001)
                continue
            ws.advance(chunk / 100.0)
            for q in ws.sample(chunk):
                while True:
                    t = loop.submit(q)
                    if t.accepted:
                        break
                    rejections[0] += 1
                    check(time.perf_counter() < t_end, "serve_loop: admission stalled")
                    time.sleep(min(t.retry_after_s, 0.02))
                tickets.append(t)
            offered += chunk
            while sched and offered >= (n_sched - len(sched) + 1) * SERVE_LOOP_MUTATE_EVERY:
                loop.submit_mutations(sched.pop(0))
        _wait_tickets("serve_loop", tickets)
        return time.perf_counter() - t0

    try:
        drive(SERVE_LOOP_WARMUP, [])
        t_end = time.perf_counter() + SERVE_WAIT_S
        while loop.invocation_in_flight:
            check(time.perf_counter() < t_end, "serve_loop: the warm-up invocation stalled")
            time.sleep(0.005)
        loop.metrics = ServeMetrics(loop.cfg.metrics_window)
        wall = drive(SERVE_LOOP_REQUESTS, list(schedule))
    finally:
        stats = loop.stop()            # raises past its stop_timeout_s
    return stats, wall, rejections[0]


def serve_loop_setting(torch, device):
    """benchmarks/serve_loop.py's setting on the card (musicbrainz 20000,
    micro-batch 16, queue 128, 64 in flight, a mutation batch every 50 of
    600 requests, the ``cuda`` field): overlapped, then stop-the-world on
    the same pre-generated stream.  The ratio is printed, not gated."""
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.workload.stream import GraphMutationStream

    t0 = time.perf_counter()
    # the identical mutation stream for both runs, made on a scratch graph
    scratch = musicbrainz_like(SERVE_LOOP_N, avg_degree=6.0, seed=13)
    muts = GraphMutationStream("mixed", seed=7, vertices_per_tick=max(2, scratch.n // 4000),
                               edges_per_tick=max(8, scratch.m // 4000))
    schedule = []
    for _ in range(SERVE_LOOP_REQUESTS // SERVE_LOOP_MUTATE_EVERY):
        schedule.append(muts.next_batch(scratch))
        scratch.apply_mutations(schedule[-1])
    reset_counts()
    runs = {}
    for name, overlap in (("async", True), ("sync", False)):
        stats, wall, rej = _serve_loop_run(device, overlap, schedule)
        runs[name] = (stats, wall)
        log(f"[serve_loop] {name}: n={SERVE_LOOP_N} completed {stats['completed']} "
            f"in {wall:.3f} s, invocations {stats['invocations']} (failures "
            f"{stats['invocation_failures']}), rejected {rej}, p50 "
            f"{1e3 * stats['latency_p50_s']:.3f} ms, p99 "
            f"{1e3 * stats['latency_p99_s']:.3f} ms, ipt/request "
            f"{stats['ipt_per_request']:.3f}, stall {stats['invocation_stall_s']:.3f} s, "
            f"overlap {stats['invocation_overlap_s']:.3f} s, served during "
            f"invocations {stats['completed_during_invocation']}, field_backend "
            f"{stats['field_backend']}")
        check(stats["completed"] == SERVE_LOOP_REQUESTS and stats["invocations"] >= 1,
              f"serve_loop {name}: {stats['completed']} completed, "
              f"{stats['invocations']} invocations")
        check(stats["field_backend"] == "cuda" and stats["backend_fallbacks"] == 0
              and not stats["invocation_error"],
              f"serve_loop {name}: left the cuda rung ({stats['invocation_error']})")
    launches = read_counts("serve_loop", ["vm_step"])["vm_step"]
    a, s = runs["async"][0], runs["sync"]
    during = a["completed_during_invocation"] / max(a["invocation_overlap_s"], 1e-9)
    sync_qps = s[0]["completed"] / max(s[1], 1e-9)
    log(f"[serve_loop] during-invocation qps {during:.1f}, stop-the-world sustained "
        f"qps {sync_qps:.1f}, ratio {during / max(sync_qps, 1e-9):.3f} (not gated); "
        f"vm_step launches {launches}; phase {time.perf_counter() - t0:.2f} s")


# ---------------------------------------------------------------------------
# phases 4g-4h: the replicated cluster on the card
# ---------------------------------------------------------------------------


def _replica_state(ot):
    """What a replica holds equal to its primary: graph arrays, partition,
    dirty bits; n, version, invocation count and the swap RNG's state."""
    g = ot.g
    return ((g.labels, g.src, g.dst, g.row_ptr, ot.part, ot._dirty),
            (int(g.n), int(g.version), int(ot.invocations),
             repr(ot.taper._rng.bit_generator.state)))


def _same_state(a, b):
    """Two ``OnlineTaper``s' replicated state bitwise equal."""
    import numpy as np

    (xa, ma), (xb, mb) = _replica_state(a), _replica_state(b)
    return ma == mb and all(x.dtype == y.dtype and np.array_equal(x, y)
                            for x, y in zip(xa, xb))


def chaos_on_card(torch, device):
    """The four chaos scenarios with their clusters on the card: each
    green (no invariant error, no staleness violation), its digest the
    JAX package's, its invocations on the ``cuda`` rung launching
    ``vm_step`` with no ladder step."""
    import shutil
    import tempfile

    from repro_torch.serve.chaos import run_scenario

    t_phase = time.perf_counter()
    for name, digest in CHAOS_DIGESTS.items():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
        try:
            reset_counts()
            t0 = time.perf_counter()
            r = run_scenario(tmp, name, device=device)
            wall = time.perf_counter() - t0
            launches = read_counts(f"chaos {name}", ["vm_step"])["vm_step"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        st = r.stats
        log(f"[chaos] {name}: {wall:.3f} s; digest {r.digest} (pinned: "
            f"{'equal' if r.digest == digest else 'DIFFERENT'}); invariant errors "
            f"{r.invariant_errors}, staleness violations {r.staleness_violations}; "
            f"failovers {r.failovers}, rejoins {r.rejoins}, epoch {r.epoch}, seq "
            f"{r.watermark_seq} -> {r.final_seq}, shed raises {r.shed_raises}, breaker "
            f"trips {r.breaker_trips}, hedged reads {st['hedged_requests']}, faults "
            f"fired {r.faults_fired}; field_backend {st['field_backend']}, backend "
            f"fallbacks {st['backend_fallbacks']}; vm_step launches {launches}")
        check(r.ok, f"chaos {name}: {r.invariant_errors} {r.staleness_violations}")
        check(r.digest == digest, f"chaos {name}: digest {r.digest}, the JAX package's "
                                  f"is {digest}")
        check(st["field_backend"] == "cuda" and st["backend_fallbacks"] == 0
              and not st["invocation_error"],
              f"chaos {name}: left the cuda rung ({st['invocation_error']})")
    log(f"[chaos] phase {time.perf_counter() - t_phase:.2f} s")


def _cf_policy(quiet=False):
    """benchmarks/cluster_failover.py's policies: ``quiet`` freezes
    invocations after the bootstrap one."""
    from repro_torch.core.online import OnlinePolicy

    if quiet:
        return OnlinePolicy(bootstrap_after_ticks=0, cadence=10 ** 9, min_interval=10 ** 9,
                            dirty_fraction=1.0, drift_l1=9e9, ipt_regression=9e9)
    return OnlinePolicy(bootstrap_after_ticks=0, cadence=8, min_interval=1,
                        dirty_fraction=0.05, drift_l1=9e9, ipt_regression=9e9)


def _cf_cluster(device, tmp, n_followers=2, faults=None, quiet=False):
    """The benchmark's inline-driven cluster, the ``cuda`` field on every
    node."""
    from repro_torch.core.taper import TaperConfig
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.serve import ClusterConfig, ClusterCoordinator, ServeLoopConfig, ServingLoop

    g = musicbrainz_like(CLUSTER_N, avg_degree=6.0, seed=17)
    primary = ServingLoop(
        g, 8, taper_config=TaperConfig(max_iterations=3, field_backend="cuda"),
        policy=_cf_policy(quiet),
        config=ServeLoopConfig(micro_batch=CLUSTER_MICRO_BATCH, overlap_invocations=False,
                               snapshot_dir=tmp, faults=faults,
                               stop_timeout_s=SERVE_WAIT_S),
        device=device)
    return ClusterCoordinator(
        primary, config=ClusterConfig(n_followers=n_followers,
                                      heartbeat_timeout_s=CLUSTER_HB_S, faults=faults),
        policy=_cf_policy(quiet),
        taper_config=TaperConfig(max_iterations=3, field_backend="cuda"))


def _cf_reads(coord, budget, seed, queries=None):
    """``budget`` routed reads over the MQ mix, 8 at a time; (wall, served)."""
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.workload.stream import WorkloadStream

    ws = WorkloadStream(queries if queries is not None else [parse_rpq(q) for q in MQ],
                        period=6.0, seed=seed)
    served = 0
    t0 = time.perf_counter()
    while served < budget:
        ws.advance(0.1)
        batch = ws.sample(min(8, budget - served))
        coord.serve(batch, cls="hot")
        served += len(batch)
    return time.perf_counter() - t0, served


def _cf_tail(coord, n_batches):
    """The benchmark's mutation tail, made on a scratch copy of the graph."""
    from repro_torch.workload.stream import GraphMutationStream

    g = coord.primary.g
    scratch = g.copy()
    muts = GraphMutationStream(mode="mixed", seed=7, vertices_per_tick=max(2, g.n // 4000),
                               edges_per_tick=max(8, g.m // 4000))
    out = []
    for _ in range(n_batches):
        out.append(muts.next_batch(scratch))
        scratch.apply_mutations(out[-1])
    return out


def _met(ok):
    return "met" if ok else "NOT MET"


def cluster_failover_setting(torch, device):
    """benchmarks/cluster_failover.py's three legs with the ``cuda`` field
    (musicbrainz 20,000, k=8, heartbeat timeout 0.2 s): a follower cut off
    by a link partition heals by tail resync and is then bitwise its
    primary; a crashed primary's best follower promotes under epoch 2,
    answers, and its next invocation launches ``vm_step`` (and a demoted
    node rejoined with its memory re-uploads its stale device inputs and
    evaluates the field bitwise like the promoted node); with one follower
    crashed, reads redirect.  The benchmark's three timing targets are
    printed as met / NOT MET, not gated."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.serve.faults import SITE_LINK_PARTITION, FaultInjector

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_failover_")
    reset_counts()
    try:
        # -- leg 1: follower catch-up replay ------------------------------------
        fi = FaultInjector()
        coord = _cf_cluster(device, f"{tmp}/catchup", n_followers=1, faults=fi, quiet=True)
        try:
            _cf_reads(coord, 16, seed=1)            # the bootstrap invocation fires
            coord.pump()
            f = coord.followers[1]
            f.catch_up()
            fi.arm(f"{SITE_LINK_PARTITION}:replica-1")
            tail = _cf_tail(coord, CLUSTER_TAIL)
            t0 = time.perf_counter()
            for b in tail:
                check(coord.submit_mutations(b) is True, "cluster_failover: batch rejected")
                coord.pump()
            live_apply_s = time.perf_counter() - t0
            behind = f.seq_lag
            check(behind >= CLUSTER_TAIL, "cluster_failover: the follower was not cut off")
            fi.disarm(f"{SITE_LINK_PARTITION}:replica-1")
            t0 = time.perf_counter()
            while f.seq_lag > 0:
                check(time.perf_counter() - t0 < SERVE_WAIT_S,
                      "cluster_failover: catch-up did not finish")
                f.catch_up()
            catchup_s = time.perf_counter() - t0
            st = f.stats()
            same = _same_state(f.ot, coord.primary.ot)
            log(f"[cluster_failover] catch-up: {behind} batches behind a link partition, "
                f"live apply {live_apply_s:.3f} s, catch-up {catchup_s:.3f} s "
                f"({behind / max(catchup_s, 1e-9):.0f} batches/s; target <= 4x live + "
                f"0.25 s: {_met(catchup_s <= 4.0 * live_apply_s + 0.25)}); tail resyncs "
                f"{st['tail_resyncs']}, full resyncs {st['full_resyncs']}; follower "
                f"bitwise the primary: {same}")
            check(st["tail_resyncs"] >= 1 and st["full_resyncs"] == 0,
                  "cluster_failover: catch-up went through a snapshot re-fetch")
            check(same, "cluster_failover: the caught-up follower differs from the primary")
        finally:
            coord.stop()

        # -- leg 2: failover to first answer -------------------------------------
        coord = _cf_cluster(device, f"{tmp}/failover", n_followers=2)
        try:
            _cf_reads(coord, 32, seed=2)
            for b in _cf_tail(coord, CLUSTER_FAILOVER_BATCHES):
                coord.submit_mutations(b)
                coord.pump()
            q0 = parse_rpq(MQ[0])
            old_slot = coord.primary_slot
            t0 = time.perf_counter()
            coord.crash_primary()
            while coord.failovers == 0:
                check(time.perf_counter() - t0 < SERVE_WAIT_S,
                      "cluster_failover: no failover")
                coord.pump()
                time.sleep(0.01)
            detect_promote_s = time.perf_counter() - t0
            res = coord.serve([q0], cls="hot")
            first_answer_s = time.perf_counter() - t0
            promoted = coord.primary
            check(len(res) == 1 and len(res[0][0]) > 0,
                  "cluster_failover: empty first answer")
            check(coord.stats()["cluster_epoch"] == 2 and promoted._epoch == 2,
                  "cluster_failover: not at epoch 2")
            check(promoted.ot.taper.device.type == "cuda" and promoted._base_backend == "cuda",
                  "cluster_failover: the promoted node is not on the cuda rung")
            # the promoted node's next invocation: reads and the tail's
            # batches until it runs
            inv0, ev0 = promoted.ot.invocations, _wrapper("vm_step").launches
            t1, seed = time.perf_counter(), 20
            for b in _cf_tail(coord, 100):
                if promoted.ot.invocations > inv0:
                    break
                check(time.perf_counter() - t1 < CLUSTER_INVOKE_WAIT_S,
                      "cluster_failover: the promoted node did not invoke")
                coord.submit_mutations(b)
                _cf_reads(coord, 8, seed=seed)
                coord.pump()
                seed += 1
            promoted_launches = _wrapper("vm_step").launches - ev0
            pst = promoted.stats()
            log(f"[cluster_failover] failover: heartbeat timeout {CLUSTER_HB_S} s, "
                f"detect + promote {detect_promote_s:.3f} s, first answer "
                f"{first_answer_s:.3f} s ({len(res[0][0])} paths; target <= heartbeat + "
                f"{CLUSTER_PROMOTION_BUDGET_S:.0f} s: "
                f"{_met(first_answer_s <= CLUSTER_HB_S + CLUSTER_PROMOTION_BUDGET_S)}); "
                f"epoch 2, promoted slot {coord.primary_slot}; its next invocation after "
                f"{time.perf_counter() - t1:.3f} s: {promoted.ot.invocations - inv0} "
                f"invocations, vm_step launches {promoted_launches}, field_backend "
                f"{pst['field_backend']}, fallbacks {pst['backend_fallbacks']}")
            check(promoted.ot.invocations > inv0 and promoted_launches > 0
                  and pst["field_backend"] == "cuda" and pst["backend_fallbacks"] == 0,
                  "cluster_failover: the promoted node's invocation did not launch vm_step "
                  "on the cuda rung")
            # the demoted node rejoined with its memory: its device inputs are
            # a stale version's; the next field re-uploads them and equals the
            # promoted node's bitwise
            f = coord.rejoin_demoted(slot=old_slot, reuse_state=True)
            f.catch_up()
            check(_same_state(f.ot, promoted.ot),
                  "cluster_failover: the rejoined node differs from the primary")
            key0 = f.ot.taper._pre.get("_dev_key")
            arrays = promoted.ot.taper.build_trie(promoted.ot.sketch.workload(
                promoted.ot.policy.min_freq)).compile(promoted.g.label_names)
            fa = promoted.ot.taper.field(promoted.ot.part, arrays)
            fb = f.ot.taper.field(f.ot.part, arrays)
            key1 = f.ot.taper._pre.get("_dev_key")
            same = all(np.array_equal(getattr(fa, k), getattr(fb, k)) for k in FIELD_NAMES
                       if getattr(fa, k) is not None)
            log(f"[cluster_failover] rejoin with its memory: device inputs at version "
                f"{None if key0 is None else key0[0]} before, {key1[0]} after "
                f"(graph version {f.g.version}); its field == the promoted node's "
                f"bitwise: {same}")
            check(key0 is not None and key0[0] != f.g.version and key1[0] == f.g.version,
                  "cluster_failover: the rejoined node did not re-upload its stale inputs")
            check(same, "cluster_failover: the rejoined node's field differs")
        finally:
            coord.stop()

        # -- leg 3: read throughput with one crashed follower -----------------------
        coord = _cf_cluster(device, f"{tmp}/degraded", n_followers=2, quiet=True)
        try:
            _cf_reads(coord, 16, seed=3)            # warm: bootstrap + caches
            g = coord.primary.g
            own = coord.router.owners()
            mix = [parse_rpq(q) for q in MQ]
            for lab in range(g.n_labels):
                vs = np.nonzero(g.labels == lab)[0]
                if vs.size == 0:
                    continue
                slot = int(np.argmax(np.bincount(own[vs], minlength=coord.n_replicas)))
                if slot != coord.primary_slot:
                    mix.append(parse_rpq(f"{g.label_names[lab]}.{g.label_names[lab]}"))
            healthy_wall, healthy_served = _cf_reads(coord, CLUSTER_READS, seed=4,
                                                     queries=mix)
            by_slot = dict(coord.router.routed_by_slot)
            victim = max(coord.followers, key=lambda s: by_slot.get(s, 0))
            check(by_slot.get(victim, 0) > 0,
                  f"cluster_failover: owner routing sent no read to a follower ({by_slot})")
            coord.followers[victim].crash()
            hurt_wall, hurt_served = _cf_reads(coord, CLUSTER_READS, seed=5, queries=mix)
            healthy_qps = healthy_served / max(healthy_wall, 1e-9)
            hurt_qps = hurt_served / max(hurt_wall, 1e-9)
            ratio = hurt_qps / max(healthy_qps, 1e-9)
            rst = coord.router.stats()
            log(f"[cluster_failover] degraded reads: healthy {healthy_qps:.1f} qps, one "
                f"follower down {hurt_qps:.1f} qps, ratio {ratio:.3f} (target >= 0.5: "
                f"{_met(ratio >= 0.5)}); dead redirects {rst['dead_redirects']}, hedged "
                f"reads {rst['hedged_requests']}, read failovers {rst['read_failovers']}")
            check(rst["dead_redirects"] >= 1,
                  "cluster_failover: no read routed to the crashed follower")
        finally:
            coord.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = read_counts("cluster_failover", ["vm_step"])["vm_step"]
    log(f"[cluster_failover] vm_step launches {launches}; phase "
        f"{time.perf_counter() - t_phase:.2f} s")


# ---------------------------------------------------------------------------
# phase 5: the main path at full size
# ---------------------------------------------------------------------------


class _KernelTimer:
    """Records CUDA events around every call of a kernel's wrapper that a
    path makes (no synchronisation), and the last arguments of each
    distinct argument shape; the wrapper's own launch count is untouched."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.events, self.last_args = torch, fn, [], None
        self.shapes, self.args_by_shape, self.host_t = [], {}, []

    def __call__(self, *args, **kwargs):
        self.host_t.append(time.perf_counter())
        ev0 = self.torch.cuda.Event(enable_timing=True)
        ev1 = self.torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = self.fn(*args, **kwargs)
        ev1.record()
        self.events.append((ev0, ev1))
        self.last_args = args
        key = tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))
        self.shapes.append(key)
        self.args_by_shape[key] = args
        return out

    def ms_by_shape(self):
        """{argument shapes: [ms of each launch]} (synchronise first)."""
        out = {}
        for key, (a, b) in zip(self.shapes, self.events):
            out.setdefault(key, []).append(a.elapsed_time(b))
        return out


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def full_size(torch, device):
    import numpy as np
    import repro_torch.core.visitor as visitor
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.core.visitor import extroversion_field
    from repro_torch.graphs.generators import provgen_like
    from repro_torch.graphs.metrics import partition_balance
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.kernels.vm_step.ops import vm_step
    from repro_torch.workload.executor import QueryExecutor

    t0 = time.perf_counter()
    g = provgen_like(FULL_N, avg_degree=6.0, seed=11)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    part0 = hash_partition(g.n, 8, seed=1)
    g.vm_csr()
    t_pack = time.perf_counter() - t0
    w = _workload(PQ, PQ_FREQ)
    log(f"[full] provgen_like n={g.n} m={g.m} k=8 hash start; generate "
        f"{t_gen:.2f} s, hash partition + vm packing {t_pack:.2f} s; "
        f"cuts: metis_like start skipped (host-bound), max_iterations="
        f"{FULL_MAX_ITERS}")

    timer = _KernelTimer(torch, vm_step)
    visitor.vm_step = timer
    try:
        taper = Taper(g, 8, TaperConfig(max_iterations=FULL_MAX_ITERS, seed=0),
                      device=device)
        reset_counts()                              # the path starts here
        t0 = time.perf_counter()
        rep = taper.invoke(part0, w)
        t_inv = time.perf_counter() - t0
        launches = read_counts("full", ["vm_step"])["vm_step"]  # ... ends here
    finally:
        visitor.vm_step = vm_step
    torch.cuda.synchronize()
    evals = len(rep.field_seconds)
    per_eval = launches // max(evals, 1)
    check(per_eval * evals == launches == len(timer.events),
          f"{launches} launches over {evals} field evaluations")
    kern_ms = [sum(a.elapsed_time(b) for a, b in timer.events[i * per_eval:(i + 1) * per_eval])
               for i in range(evals)]

    t0 = time.perf_counter()
    ex = QueryExecutor(g)
    ipt = [ex.workload_ipt(w, p) for p in rep.parts]
    t_ipt = time.perf_counter() - t0
    for i in range(evals):
        swap = (f"swap {rep.swap_seconds[i - 1]:.3f} s, moves {rep.moves[i - 1]}, "
                if i else "")
        log(f"[full] iteration {i}: {swap}field {rep.field_seconds[i]:.4f} s "
            f"(kernel {kern_ms[i]:.3f} ms over {per_eval} launches), "
            f"ipt {ipt[i]:.0f}")
        # the field's split: its vm_step launches on the device, and the
        # rest of its wall time (host work, and device work outside vm_step)
        log(f"[full] field split, evaluation {i}: vm_step {kern_ms[i]:.3f} ms, "
            f"the rest {rep.field_seconds[i] * 1e3 - kern_ms[i]:.3f} ms "
            f"({1 - kern_ms[i] / (rep.field_seconds[i] * 1e3):.4f} of the field)")
    if len(rep.swap_seconds) > rep.iterations:
        log(f"[full] final swap (no moves): {rep.swap_seconds[-1]:.3f} s")
    field_s, swap_s = sum(rep.field_seconds), sum(rep.swap_seconds)
    log(f"[full] invocation {t_inv:.2f} s: {rep.iterations} iterations, "
        f"{rep.total_moves} moves, field {field_s:.3f} s "
        f"(kernel {sum(kern_ms):.3f} ms), swap {swap_s:.3f} s; "
        f"ipt {ipt[0]:.0f} -> {ipt[-1]:.0f} ({ipt[-1] / ipt[0]:.4f}); "
        f"ipt scoring {t_ipt:.2f} s; balance "
        f"{partition_balance(rep.final_part, 8):.4f}; vm_step launches {launches}")
    check(ipt[-1] < ipt[0], "the invocation did not reduce ipt")
    check(partition_balance(rep.final_part, 8) <= 1.0 + 0.05 + 1e-9,
          "final partition breaks the 5% balance bound")

    # the field twice on the same partition: bitwise repeatable
    final = rep.final_part
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    f1 = extroversion_field(g, arrays, final, 8, _precomputed=taper._pre,
                            device=device)
    f2 = extroversion_field(g, arrays, final, 8, _precomputed=taper._pre,
                            device=device)
    names = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to")
    for k in names:
        a = getattr(f1, k)
        check(np.array_equal(a, getattr(f2, k)), f"field {k} not bitwise repeatable")
        check(bool(np.isfinite(a).all()), f"field {k} not finite")
    check(f1.alpha.shape == (g.n, arrays.n_nodes) and f1.edge_mass.shape == (g.m,)
          and f1.ext_to.shape == (g.n, 8), "field output shapes")
    # the plain torch field on the card, same partition
    fp = extroversion_field(g, arrays, final, 8, _precomputed=taper._pre,
                            backend="torch", device=device)
    same = all(np.array_equal(getattr(f1, k), getattr(fp, k)) for k in names)
    log(f"[full] field twice on the final partition: bitwise equal; "
        f"cuda field == plain torch field on the card bitwise: {same}")
    check(same, "full-size cuda field differs from the plain field")
    # one more evaluation under the profiler: where the field's time goes
    prof = _profile_step(torch, lambda: extroversion_field(
        g, arrays, final, 8, _precomputed=taper._pre, device=device), top=8)
    busy = "none traced" if prof["busy_ms"] is None else f"{prof['busy_ms']:.3f} ms"
    log(f"[full] one field evaluation under torch.profiler: wall {prof['wall_ms']:.3f} ms, "
        f"device busy {busy} over {prof['device_ops']} device ops, "
        f"{prof['host_ops']} top-level aten ops; by self host time: "
        + "; ".join(f"{name} {ms:.3f} ms x{cnt}" for name, ms, cnt in prof["top"]))

    # the kernel at the main path's shapes: its last launch's arguments; the
    # graph and its final partition go on to the online path
    return dict(launches=launches, graph=g, part=final,
                **_vm_at_path_shapes(torch, "full", timer.last_args))


def _vm_at_path_shapes(torch, path, args):
    """The kernel's time, its plain version's, its bound and its error on
    the arguments of a path's last launch."""
    from repro_torch.kernels.vm_step.ops import vm_step

    alpha, par, val, csr, wt, row_label = args
    row_ptr, src, plan = csr.row_ptr, csr.src, csr.plan
    n_in, N = alpha.shape
    n = row_ptr.shape[0] - 1                      # output rows
    L, E = par.shape[0], src.shape[0]
    ms = _time_ms(torch, lambda: vm_step(*args), 20)
    plain_ms = _time_ms(torch, lambda: _vm_plain(args), 3)
    out_k, out_p = vm_step(*args), _vm_plain(args)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(bool(torch.allclose(out_k, out_p, rtol=RTOL, atol=ATOL)),
          f"{path}: vm_step kernel disagrees with its plain version")
    bound_ms, bound_by, bytes_moved, flops, nz, alpha_bytes = _vm_bound(args)
    gathered = _vm_gather_sectors(torch, args)
    # every input but alpha (gathered) read once, the output written once
    other = bytes_moved - alpha_bytes
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n, device=deg.device), deg)
    local_deg = torch.bincount(rows[wt != 0], minlength=n)
    log(f"[{path}] vm_step rows: longest row {int(deg.max())} edges "
        f"({int(local_deg.max())} local); mean {E / n:.2f} edges "
        f"({nz / n:.2f} local); {ms * 1e6 / max(nz, 1):.3f} ns per local edge; "
        f"{plan.runs.shape[0] - 1} runs, {plan.long_rows.shape[0]} rows on the "
        f"long-row path")
    halo = f" (alpha {n_in} rows: the shard's and its halo)" if n_in != n else ""
    halo += f", live edges read {alpha_bytes // (4 * N)} alpha rows,"
    log(f"[{path}] vm_step at n={n}{halo} E={E} N={N} L={L} (local edges {nz}): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({bytes_moved} B, {flops} FLOP), max_abs_err {err:.3e} "
        f"bitwise={bool(torch.equal(out_k, out_p))}; "
        f"{_yardstick_text(gathered, other, kernel=ms)}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                err=err)


# ---------------------------------------------------------------------------
# phase 5a: the sharded field at full size
# ---------------------------------------------------------------------------


def _sharded_evals(torch, g, arrays, parts, pre, reps=1, **kw):
    """``cuda_sharded`` evaluations of ``g`` at each partition of ``parts``
    (``reps`` each): per evaluation its digest, host wall time, exchange
    time, ``vm_step`` launches and their device time (CUDA events)."""
    import repro_torch.core.visitor as visitor
    from repro_torch.core.visitor import extroversion_field
    from repro_torch.kernels.vm_step.ops import vm_step

    timer = _KernelTimer(torch, vm_step)
    visitor.vm_step = timer
    evals = []
    try:
        for part in parts:
            for _ in range(reps):
                k0 = len(timer.events)
                t0 = time.perf_counter()
                fld = extroversion_field(g, arrays, part, 8, _precomputed=pre,
                                         backend="cuda_sharded", device="cuda", **kw)
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                evals.append(dict(
                    digest=_field_digest(fld), wall=wall,
                    exchange=pre["_shard_exchange"]["seconds"],
                    launches=len(timer.events) - k0,
                    kernel_ms=sum(a.elapsed_time(b) for a, b in timer.events[k0:])))
    finally:
        visitor.vm_step = vm_step
    return evals, timer.last_args


def _sharded_full_rank(rank, n_ranks, g, part, arrays):
    """One gloo rank of the full-size path on the card: SHARDED_FULL_EVALS
    evaluations at path 1's final partition; rank 0 then times the kernel
    at its shard's shapes."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.vm_step.ops import vm_step

    source, exchange = SHARDED_FULL
    pre = {}
    mem0 = torch.cuda.memory_allocated()
    vm_step.launches = 0
    t0 = time.perf_counter()
    evals, args = _sharded_evals(torch, g, arrays, [part], pre,
                                 reps=SHARDED_FULL_EVALS,
                                 shard_map_source=source, halo_exchange=exchange)
    launches = vm_step.launches
    wall = time.perf_counter() - t0
    mem1 = torch.cuda.memory_allocated()
    # rank 0 times the kernel alone on the card: the others have finished
    # their work and wait at the second barrier until it is done
    torch.cuda.synchronize()
    dist.barrier()
    kernel = (_vm_at_path_shapes(torch, f"sharded{n_ranks}", args) if rank == 0
              else None)
    dist.barrier()
    return dict(evals=evals, launches=launches, wall=wall, mem=(mem0, mem1),
                halo=pre["_halo_stats"], uploads=pre["_shard_uploads"],
                transport=pre["_shard_exchange"]["transport"], kernel=kernel,
                shapes=(int(args[0].shape[0]), int(args[3].row_ptr.shape[0] - 1)))


def _eval_text(e):
    return (f"wall {e['wall']:.4f} s, exchange {e['exchange']:.4f} s, vm_step "
            f"{e['launches']} launches {e['kernel_ms']:.3f} ms")


def sharded_full(torch, device, g, part):
    """The sharded field on path 1's provgen-1M graph, bitwise path 1's cuda
    field on the same partition: S=1 on an NCCL group in this process at the
    hash start and at the final partition, then SHARDED_RANKS gloo ranks
    sharing the card at the final partition (partition map, sliced)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.core.visitor import extroversion_field
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.launch.mesh import make_smoke_group, run_ranks

    t_path = time.perf_counter()
    g = g.copy()                 # path 1's graph stays as the online path wants it
    w = _workload(PQ, PQ_FREQ)
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    part0 = hash_partition(g.n, 8, seed=1)
    want = [_field_digest(extroversion_field(g, arrays, p, 8, backend="cuda",
                                             device=device)) for p in (part0, part)]
    torch.cuda.empty_cache()

    # S=1: an NCCL group of this process
    group = make_smoke_group(device)
    pre = {"_group": group}
    mem0 = torch.cuda.memory_allocated()
    reset_counts()                                   # the path starts here
    evals, args1 = _sharded_evals(torch, g, arrays, [part0, part], pre)
    counts = read_counts("sharded1", ["vm_step"])    # ... S=1 ends here
    mem1 = torch.cuda.memory_allocated()
    hs = pre["_halo_stats"]
    for what, e, d in zip(("hash start", "final partition"), evals, want):
        same = e["digest"] == d
        log(f"[sharded1] S=1 ({pre['_shard_exchange']['transport']}), {what}: "
            f"{_eval_text(e)}; == path 1's cuda field bitwise: {same}")
        check(same, f"sharded S=1 at the {what}: differs from the cuda field")
    log(f"[sharded1] halo {hs['halo_bytes_per_depth']} B a depth ({hs['n_frontier']} "
        f"frontier rows), full field {hs['full_field_bytes_per_depth']} B, ratio "
        f"{hs['halo_ratio']:.6f}; device memory {mem0} B before, {mem1} B after")
    shard = pre["_shard_dev"]["shard"]
    shard_bytes, _ = _live_bytes(torch, shard)
    del shard
    del pre, args1
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # S = SHARDED_RANKS gloo ranks sharing the card, at the final partition
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        results = run_ranks(_sharded_full_rank, SHARDED_RANKS, work,
                            args=(g.copy(), part, arrays))
    t_ranks = time.perf_counter() - t0
    r0 = results[0]
    for rank, r in enumerate(results):
        for i, e in enumerate(r["evals"]):
            same = e["digest"] == want[1]
            log(f"[sharded{SHARDED_RANKS}] rank {rank} evaluation {i} "
                f"({r['transport']}, {SHARDED_FULL[0]} map, {SHARDED_FULL[1]}): "
                f"{_eval_text(e)}; == path 1's cuda field bitwise: {same}")
            check(same, f"sharded S={SHARDED_RANKS} rank {rank}: differs from the "
                        f"cuda field")
        log(f"[sharded{SHARDED_RANKS}] rank {rank}: alpha rows {r['shapes'][0]} "
            f"(its {r['shapes'][1]} and the halo), device memory {r['mem'][0]} B "
            f"before, {r['mem'][1]} B after; uploads {r['uploads']}")
    hs = r0["halo"]
    log(f"[sharded{SHARDED_RANKS}] halo {hs['halo_bytes_per_depth']} B a depth "
        f"({hs['hot_rows']} hot rows, {hs['sliced_rows']} sliced rows, "
        f"{hs['n_frontier']} frontier rows), full field "
        f"{hs['full_field_bytes_per_depth']} B, ratio {hs['halo_ratio']:.6f}; "
        f"ranks {t_ranks:.2f} s (spawn, graph, packing, evaluations)")
    launches = counts["vm_step"] + sum(r["launches"] for r in results)
    check(all(r["launches"] > 0 for r in results), "a sharded rank launched no vm_step")
    log(f"[sharded] vm_step launches: S=1 {counts['vm_step']}, S={SHARDED_RANKS} "
        f"{[r['launches'] for r in results]}; the S=1 shard's device inputs "
        f"{shard_bytes} B; path {time.perf_counter() - t_path:.1f} s")
    del g
    return dict(launches=launches, **r0["kernel"])


# ---------------------------------------------------------------------------
# phase 5b: online TAPER on path 1's graph
# ---------------------------------------------------------------------------


def _live_bytes(torch, *tensor_sets):
    """(bytes, count) of the distinct device tensors in the given dicts and
    tuples (a CSR counted with its plan), each storage once."""
    from repro_torch.kernels.segment_spmm.ops import EdgeCSR

    seen = {}
    for ts in tensor_sets:
        for t in (ts.values() if isinstance(ts, dict) else ts):
            if isinstance(t, EdgeCSR):
                parts = (t.row_ptr, t.src, t.order, t.plan.runs, t.plan.long_rows)
            else:
                parts = (t,)
            for p in parts:
                if isinstance(p, torch.Tensor) and p.is_cuda:
                    seen[p.data_ptr()] = p.numel() * p.element_size()
    return sum(seen.values()), len(seen)


def online_full(torch, device, g, part):
    """An OnlineTaper on path 1's graph and final partition: ticks of mixed
    mutations, only the topology trigger live (so every invocation is
    mutation-local), the kernel field over each version's rebuilt CSR and
    row plan; then the patched graph, the patched executor and the field
    held against fresh builds, and the device memory against the graph's
    growth."""
    import numpy as np
    import repro_torch.core.visitor as visitor
    from repro_torch.core.online import OnlinePolicy, OnlineTaper
    from repro_torch.core.taper import TaperConfig
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.core.visitor import extroversion_field
    from repro_torch.graphs.graph import LabelledGraph
    from repro_torch.graphs.metrics import partition_balance
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.kernels.vm_step.ops import vm_step
    from repro_torch.workload.executor import QueryExecutor
    from repro_torch.workload.stream import GraphMutationStream, WorkloadStream

    t_path = time.perf_counter()
    queries = [q for q, _ in _workload(PQ, PQ_FREQ)]
    stream = WorkloadStream(queries, period=float(ONLINE_TICKS), seed=3)
    muts = GraphMutationStream("mixed", seed=7, vertices_per_tick=g.n // 2000,
                               edges_per_tick=g.m // 2000)
    policy = OnlinePolicy(dirty_fraction=0.01, cadence=1000, drift_l1=2.0,
                          ipt_regression=float("inf"))
    online = OnlineTaper(g, 8, part=part, policy=policy, device=device,
                         config=TaperConfig(max_iterations=ONLINE_MAX_ITERS, seed=0))
    n0, m0 = g.n, g.m
    t0 = time.perf_counter()
    ex = QueryExecutor(g)
    for q in queries:
        ex.traversals(q)
    t_ex0 = time.perf_counter() - t0
    online.observe(stream.sample(ONLINE_BATCH))
    log(f"[online] provgen n={g.n} m={g.m} k=8 from path 1's final partition; "
        f"{ONLINE_TICKS} ticks of {muts.vertices_per_tick} new vertices and "
        f"{muts.edges_per_tick} churned edges, {ONLINE_BATCH} observed queries a "
        f"tick; OnlinePolicy(dirty_fraction=0.01, cadence=1000, drift_l1=2.0, "
        f"ipt_regression=inf); max_iterations={ONLINE_MAX_ITERS}; executor "
        f"counts for PQ1-4 built in {t_ex0:.2f} s")

    uploads = []
    device_inputs = visitor._device_inputs

    def timed_inputs(g_, pre, cnt, lab_vcount, dev):
        if pre.get("_dev_key") == (g_.version, dev):
            return device_inputs(g_, pre, cnt, lab_vcount, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = device_inputs(g_, pre, cnt, lab_vcount, dev)
        torch.cuda.synchronize()
        uploads.append(time.perf_counter() - t)
        return out

    timer = _KernelTimer(torch, vm_step)
    visitor.vm_step, visitor._device_inputs = timer, timed_inputs
    mem, invoked_ticks = [], 0
    try:
        reset_counts()                              # the path starts here
        for tick in range(ONLINE_TICKS):
            stream.advance(1.0)
            online.observe(stream.sample(ONLINE_BATCH))
            t0 = time.perf_counter()
            batch = muts.next_batch(g)
            t1 = time.perf_counter()
            applied = g.apply_mutations(batch)
            t2 = time.perf_counter()
            online.ingest(applied)
            t3 = time.perf_counter()
            for q in queries:
                ex.traversals(q)
            t4 = time.perf_counter()
            w_true = stream.workload()
            ipt_now = ex.workload_ipt(w_true, online.part)
            dirty = int(online._dirty.sum())
            n_up, n_ev = len(uploads), len(timer.events)
            t5 = time.perf_counter()
            step = online.step(measured_ipt=ipt_now)
            t_step = time.perf_counter() - t5
            torch.cuda.synchronize()
            rep = step.report
            kern = [a.elapsed_time(b) for a, b in timer.events[n_ev:]]
            line = (f"[online] tick {tick}: n={g.n} m={g.m} dirty={dirty} "
                    f"reason={step.reason or '-'}; host: batch {t1 - t0:.3f} s, "
                    f"apply_mutations {t2 - t1:.3f} s, ingest (arrival placement) "
                    f"{t3 - t2:.3f} s, executor patch {t4 - t3:.3f} s")
            if rep is not None:
                invoked_ticks += 1
                ipt_now = ex.workload_ipt(w_true, online.part)
                bal = partition_balance(online.part, 8)
                line += (f"; invocation {t_step:.3f} s: {rep.iterations} iterations, "
                         f"{rep.total_moves} moves, swap {sum(rep.swap_seconds):.3f} s, "
                         f"field {sum(rep.field_seconds):.3f} s (device inputs "
                         f"rebuilt in {sum(uploads[n_up:]):.3f} s), vm_step "
                         f"{len(kern)} launches {sum(kern):.3f} ms; balance {bal:.4f}")
                check(bal <= 1.0 + 0.05 + 1e-9,
                      f"online tick {tick}: balance {bal} breaks the 5% bound")
            ipt_hash = ex.workload_ipt(w_true, hash_partition(g.n, 8, seed=1))
            log(line + f"; ipt {ipt_now:.0f}, hash baseline {ipt_hash:.0f}")
            if "_dev" in online.taper._pre:
                mem.append((tick, torch.cuda.memory_allocated(),
                            _live_bytes(torch, online.taper._pre["_dev"],
                                        timer.last_args or ())))
            timer.args_by_shape.clear()
        launches = read_counts("online", ["vm_step"])["vm_step"]  # ... ends here
    finally:
        visitor.vm_step, visitor._device_inputs = vm_step, device_inputs
    check(invoked_ticks >= 1 and online.invocations == invoked_ticks,
          f"online: {online.invocations} invocations over {ONLINE_TICKS} ticks")

    # the device memory: one version's buffers held, the old ones freed
    (t_a, mem_a, (live_a, _)), (t_b, mem_b, (live_b, count_b)) = mem[0], mem[-1]
    allowed = mem_a + (live_b - live_a) + count_b * ONLINE_MEM_SLACK
    log(f"[online] device memory allocated after tick {t_a}: {mem_a} B, after "
        f"tick {t_b}: {mem_b} B; the graph's device arrays grew by "
        f"{live_b - live_a} B (n {n0} -> {g.n}, m {m0} -> {g.m}); allowed "
        f"{allowed} B (with {count_b} x {ONLINE_MEM_SLACK} B of allocator "
        f"blocks); one stale version's buffers would add {live_a} B")
    check(mem_b <= allowed, "online: device memory grew past the graph's growth "
          "(a stale version's buffers were kept)")

    # the patched graph against a fresh one built from its arrays
    t0 = time.perf_counter()
    fresh = LabelledGraph(n=g.n, labels=g.labels.copy(), label_names=g.label_names,
                          src=g.src.copy(), dst=g.dst.copy())
    pairs = [("src", g.src, fresh.src), ("dst", g.dst, fresh.dst),
             ("row_ptr", g.row_ptr, fresh.row_ptr),
             ("reverse_edge_index", g.reverse_edge_index, fresh.reverse_edge_index),
             ("neighbour-label counts", g.cached_neighbor_label_counts(),
              fresh.neighbor_label_counts())]
    (p, dl, ic, dg), (fp, fdl, fic, fdg) = g.vm_packing(), fresh.vm_packing()
    pairs += [(f"vm_packing.{k}", getattr(p, k), getattr(fp, k))
              for k in ("src", "dst_local", "meta", "pad_mask", "order")]
    pairs += [("vm_packing dst_label", dl, fdl), ("vm_packing inv_cnt", ic, fic),
              ("vm_packing dst_global", dg, fdg)]
    c, fc = g.vm_csr(), fresh.vm_csr()
    pairs += [(f"vm_csr.{k}", getattr(c, k), getattr(fc, k))
              for k in ("row_ptr", "src", "order")]
    pairs += [("vm_csr.plan.runs", c.plan.runs, fc.plan.runs),
              ("vm_csr.plan.long_rows", c.plan.long_rows, fc.plan.long_rows)]
    for name, a, b in pairs:
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"online: patched {name} differs from a fresh graph's")
    log(f"[online] patched graph == fresh graph bitwise ({len(pairs)} arrays: edges, "
        f"row_ptr, reverse index, counts, vm_packing, vm_csr with its plan of "
        f"{c.plan.runs.shape[0] - 1} runs and {c.plan.long_rows.shape[0]} long rows); "
        f"fresh build and compare {time.perf_counter() - t0:.2f} s")
    del fresh, pairs, fp, fdl, fic, fdg, fc

    # the patched executor against a fresh one
    t0 = time.perf_counter()
    ex2 = QueryExecutor(g)
    for q in queries:
        check(np.array_equal(ex.traversals(q), ex2.traversals(q)),
              f"online: patched traversal counts of {q.to_text()} differ from a rebuild")
    t_rebuild = time.perf_counter() - t0
    log(f"[online] executor: patched counts for PQ1-4 == rebuilt counts bitwise; "
        f"rebuild {t_rebuild:.3f} s (first build {t_ex0:.3f} s)")
    del ex2

    # the kernel field on the final partition: repeatable, and the plain field
    arrays = TPSTry.from_workload(_workload(PQ, PQ_FREQ)).compile(g.label_names)
    pre = online.taper._pre
    f1 = extroversion_field(g, arrays, online.part, 8, _precomputed=pre, device=device)
    f2 = extroversion_field(g, arrays, online.part, 8, _precomputed=pre, device=device)
    fpl = extroversion_field(g, arrays, online.part, 8, _precomputed=pre,
                             backend="torch", device=device)
    for k in ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to"):
        a = getattr(f1, k)
        check(bool(np.isfinite(a).all()), f"online: field {k} not finite")
        check(np.array_equal(a, getattr(f2, k)), f"online: field {k} not repeatable")
        check(np.array_equal(a, getattr(fpl, k)),
              f"online: cuda field {k} differs from the plain field")
    log(f"[online] final field (n={g.n}, N={arrays.n_nodes}): cuda twice bitwise "
        f"equal, == plain torch field on the card bitwise; vm_step launches "
        f"{launches}; path {time.perf_counter() - t_path:.1f} s")
    del f1, f2, fpl
    return dict(launches=launches, **_vm_at_path_shapes(torch, "online", timer.last_args))


# ---------------------------------------------------------------------------
# phase 5c: serving on path 1's graph, invocations overlapped with requests
# ---------------------------------------------------------------------------


def _serve_full_feed(loop, g, ws, muts, t_cap):
    """The feeder: SERVE_FULL_IN_FLIGHT requests outstanding (a rejection
    retried after its hint), one mutation batch after SERVE_FULL_EVERY
    completed requests and then after each committed invocation and
    SERVE_FULL_EVERY more, until SERVE_FULL_BATCHES invocations have
    committed.  Returns (tickets, rejections, batch send times)."""
    tickets, outstanding, rejections, sent = [], [], 0, []
    next_at, seen = SERVE_FULL_EVERY, 0
    t0 = t_log = time.perf_counter()
    while True:
        commits = loop.ot.invocations
        if time.perf_counter() - t_log >= SERVE_FULL_LOG_S:
            t_log = time.perf_counter()
            log(f"[serve] at {t_log - t0:.1f} s: {loop.metrics.completed} requests "
                f"completed, {len(sent)} batches sent, {commits} commits, invocation in "
                f"flight {loop.invocation_in_flight}, queue depth {loop.requests.depth()}")
        check(time.perf_counter() < t_cap,
              f"serve: not done within the {SERVE_FULL_CAP_S:.0f} s cap ({len(sent)} "
              f"batches sent, {commits} commits, {loop.metrics.completed} requests "
              f"completed)")
        check(commits <= len(sent), "serve: an invocation ran without a batch")
        outstanding = [t for t in outstanding if not t.done.is_set()]
        for q in ws.sample(max(0, SERVE_FULL_IN_FLIGHT - len(outstanding))):
            while True:
                t = loop.submit(q)
                if t.accepted:
                    break
                rejections += 1
                check(time.perf_counter() < t_cap, "serve: admission stalled")
                time.sleep(min(t.retry_after_s, 0.02))
            tickets.append(t)
            outstanding.append(t)
        if commits > seen:                  # the last batch's invocation committed
            seen, next_at = commits, loop.metrics.completed + SERVE_FULL_EVERY
        if commits >= SERVE_FULL_BATCHES:
            return tickets, rejections, sent
        if len(sent) == commits and loop.metrics.completed >= next_at:
            # generated against the live graph: the previous batch has been
            # applied (its invocation committed) and none is pending
            check(loop.submit_mutations(muts.next_batch(g)) is True,
                  "serve: ingest rejected a batch")
            sent.append(time.perf_counter())
        time.sleep(0.001)


def _invocations_from_traces(loop, host_t):
    """Each committed invocation as its trace shows it: the run's window
    (from the end of the ``invocation.snapshot`` span to the end of its
    last field or swap span, on the perf_counter clock), the field and swap
    spans, the commit span's start, and the kernel launches made inside
    the window (``host_t``: the host time of each launch), in the order
    the invocations began."""
    off = time.perf_counter() - time.monotonic()      # span clock -> perf_counter
    tracer = loop.obs.tracer
    out = []
    for root in tracer.spans(name="invocation"):
        kids = tracer.spans(trace_id=root["trace_id"])
        named = {n: [k for k in kids if k["name"] == n] for n in (
            "invocation.snapshot", "invocation.field", "invocation.swap",
            "invocation.commit")}
        run = named["invocation.field"] + named["invocation.swap"]
        t0 = named["invocation.snapshot"][0]["t1"] + off
        t1 = max(k["t1"] for k in run) + off
        commit = named["invocation.commit"]
        out.append(dict(
            attrs=root["attrs"], fields=named["invocation.field"],
            swaps=named["invocation.swap"], t0=t0, t1=t1,
            t_commit=commit[0]["t0"] + off if commit else float("nan"),
            launches=sum(t0 <= h <= t1 for h in host_t)))
    return out


def _field_beside_serving(torch, loop, fixed):
    """The worker's enumeration of the fixed batch alone; beside field
    evaluations run back to back on another thread (two partitions in turn,
    so none is memoized: each launches vm_step and copies its results to
    pageable host memory); and beside back-to-back copies of one field's
    results from the card to pageable host memory, the copies alone.
    Returns the enumeration times of each arm, and for the two threads
    their count of evaluations / copy rounds, mean wall and bytes a round."""
    import threading

    import numpy as np

    taper, ex = loop.ot.taper, loop.executor
    arrays = taper.build_trie(loop.ot.sketch.workload(loop.ot.policy.min_freq)).compile(
        loop.g.label_names)
    p0 = loop.part
    p1 = p0.copy()
    p1[: p1.size // 100] = (p1[: p1.size // 100] + 1) % loop.k
    fld = taper.field(p0, arrays)                 # warm: the first call is cold
    outs = [torch.from_numpy(np.ascontiguousarray(getattr(fld, name))).to(taper.device)
            for name in FIELD_NAMES if getattr(fld, name) is not None]
    copy_bytes = sum(t.numel() * t.element_size() for t in outs)

    def enum_times():
        out = []
        for _ in range(SERVE_FULL_FIELD_REPS):
            t0 = time.perf_counter()
            ex.enumerate_paths_many(fixed, max_results=loop.cfg.max_results_per_query,
                                    part=p0)
            out.append(time.perf_counter() - t0)
        return out

    def beside(work):
        stop, walls = threading.Event(), []

        def body():
            while not stop.is_set():
                t0 = time.perf_counter()
                work(len(walls))
                walls.append(time.perf_counter() - t0)

        t = threading.Thread(target=body, name="beside-serving", daemon=True)
        t.start()
        try:
            times = enum_times()
        finally:
            stop.set()
            t.join(SERVE_WAIT_S)
        check(not t.is_alive(), f"serve: the thread beside serving did not stop "
                                f"within {SERVE_WAIT_S:.0f} s")
        return times, len(walls), sum(walls) / max(len(walls), 1)

    alone = enum_times()
    fields = beside(lambda i: taper.field((p0, p1)[i % 2], arrays))
    copies = beside(lambda i: [t.cpu() for t in outs])
    torch.cuda.synchronize()
    return alone, fields, copies, copy_bytes


def serving_full(torch, device, g, part):
    """A ServingLoop on path 1's graph and final partition: one worker,
    invocations overlapped on their own thread with the kernel field, a
    feeder keeping requests in flight and sending one mutation batch per
    invocation; durability and tracing on.  Then every request answered,
    each invocation on the ``cuda`` rung with vm_step launches and requests
    served inside its window, the batched enumeration against the
    reference DFS, the field's effect on the worker, and a restore from the
    snapshot and WAL bitwise the live loop.  Invocation windows, field and
    swap times come from the loop's own traces."""
    import shutil
    import tempfile

    import numpy as np
    import repro_torch.core.visitor as visitor
    from repro_torch.core.online import OnlinePolicy
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.taper import TaperConfig
    from repro_torch.kernels.vm_step.ops import vm_step
    from repro_torch.serve import ServeLoopConfig, ServingLoop
    from repro_torch.serve.snapshot import load_serving_snapshot
    from repro_torch.workload.stream import GraphMutationStream, WorkloadStream

    t_path = time.perf_counter()
    queries = [parse_rpq(q) for q in PQ]
    ws = WorkloadStream(queries, mode="static", static_freqs=PQ_FREQ, seed=3)
    muts = GraphMutationStream("mixed", seed=7, vertices_per_tick=g.n // 2000,
                               edges_per_tick=g.m // 2000)

    def policy():
        # the online path's: the topology trigger only
        return OnlinePolicy(dirty_fraction=0.01, cadence=10 ** 9, drift_l1=2.0,
                            ipt_regression=float("inf"))

    def taper_config():
        return TaperConfig(max_iterations=ONLINE_MAX_ITERS, seed=0, field_backend="cuda")

    snap_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    loop = ServingLoop(g, 8, part=part, taper_config=taper_config(), policy=policy(),
                       config=ServeLoopConfig(n_workers=1, overlap_invocations=True,
                                              micro_batch=SERVE_FULL_MICRO_BATCH,
                                              snapshot_dir=snap_dir, snapshot_keep=2,
                                              trace_sample_rate=SERVE_FULL_SAMPLE,
                                              stop_timeout_s=SERVE_WAIT_S),
                       device=device)
    n0, m0 = g.n, g.m
    log(f"[serve] provgen n={n0} m={m0} k=8 from path 1's final partition; "
        f"ServingLoop(n_workers=1, overlap_invocations=True, micro_batch "
        f"{loop.cfg.micro_batch}, queue {loop.cfg.max_queue_depth}, field cuda, "
        f"max_iterations {ONLINE_MAX_ITERS}, topology trigger only, snapshots kept 2, "
        f"trace sampling {SERVE_FULL_SAMPLE}); feeder: {SERVE_FULL_IN_FLIGHT} in flight "
        f"over PQ1-4 at {PQ_FREQ}, {SERVE_FULL_BATCHES} batches of "
        f"{muts.vertices_per_tick} new vertices and {muts.edges_per_tick} churned "
        f"edges, the first after {SERVE_FULL_EVERY} requests, each later one after "
        f"a commit and {SERVE_FULL_EVERY} more")

    # the worker's micro-batches (start, end, requests, frontier rows): the
    # loop traces a micro-batch only when one of its requests is sampled,
    # so a host timer wraps the batched enumeration; the kernel's launches
    # are timed by CUDA events (and stamped with the host time they began)
    batches, enumerate_many = [], loop.executor.enumerate_paths_many

    def timed_batch(queries, *args, **kwargs):
        t0 = time.perf_counter()
        out = enumerate_many(queries, *args, **kwargs)
        stats = kwargs.get("stats") or {}
        batches.append((t0, time.perf_counter(), len(queries), stats.get("frontier_rows", 0)))
        return out

    loop.executor.enumerate_paths_many = timed_batch
    # the traces carry no frontier size: it is read off each invocation's inputs
    frontiers, begin_invocation = [], loop.ot.begin_invocation

    def begin(reason="manual"):
        pending = begin_invocation(reason)
        if pending is not None:
            frontiers.append(-1 if pending.frontier is None else int(pending.frontier.size))
        return pending

    loop.ot.begin_invocation = begin
    timer = _KernelTimer(torch, vm_step)
    visitor.vm_step = timer
    try:
        reset_counts()                              # the path starts here
        t_start = time.perf_counter()
        loop.start()
        try:
            tickets, rejections, sent = _serve_full_feed(
                loop, g, ws, muts, t_start + SERVE_FULL_CAP_S)
            _wait_tickets("serve", tickets)
        finally:
            t_served = time.perf_counter()
            stats = loop.stop(drain=True)           # raises past stop_timeout_s
        launches = read_counts("serve", ["vm_step"])["vm_step"]  # ... ends here
    finally:
        visitor.vm_step = vm_step
        loop.executor.enumerate_paths_many = enumerate_many
        loop.ot.begin_invocation = begin_invocation
    torch.cuda.synchronize()
    t_stop = time.perf_counter()
    mem1 = torch.cuda.memory_allocated()

    # every request answered; each invocation committed on the cuda rung
    done = [t.submitted_s + t.latency_s for t in tickets]
    lat = np.asarray([t.latency_s for t in tickets])
    ipt = np.asarray([t.ipt for t in tickets], np.float64)
    check(all(t.done.is_set() and t.paths is not None for t in tickets)
          and stats["completed"] == len(tickets),
          f"serve: {stats['completed']} of {len(tickets)} requests completed")
    invs = _invocations_from_traces(loop, timer.host_t)
    check(len(invs) == len(frontiers) == SERVE_FULL_BATCHES
          and loop.ot.invocations == SERVE_FULL_BATCHES
          and all(r["attrs"].get("committed") for r in invs),
          f"serve: {len(invs)} invocation traces, {loop.ot.invocations} commits, "
          f"{SERVE_FULL_BATCHES} batches")
    check(stats["backend_fallbacks"] == 0 and stats["field_backend"] == "cuda"
          and stats["invocation_failures"] == 0 and not stats["invocation_error"],
          f"serve: left the cuda rung or failed ({stats['invocation_error']})")
    check(sum(r["launches"] for r in invs) == len(timer.host_t) == launches,
          f"serve: {len(timer.host_t)} vm_step launches, {launches} counted, "
          f"{[r['launches'] for r in invs]} inside the invocation windows")
    in_window, window_s = 0, 0.0
    for i, r in enumerate(invs):
        k_in = sum(r["t0"] <= d <= r["t1"] for d in done)
        win = r["t1"] - r["t0"]
        busy = sum(max(0.0, min(b[1], r["t1"]) - max(b[0], r["t0"])) for b in batches)
        # one micro-batch in service over the whole window: it began at the
        # window's start (the worker takes its next micro-batch as soon as
        # it has started the invocation's thread) and ended after it
        spanning = [b for b in batches
                    if b[0] <= r["t0"] + SERVE_FULL_DISPATCH_S and b[1] >= r["t1"]]
        in_window += k_in
        window_s += win
        backends = sorted({f["attrs"].get("backend") for f in r["fields"]})
        log(f"[serve] invocation {i} ({r['attrs'].get('reason')}, rung {backends}): window "
            f"{win:.3f} s, field {sum(f['duration_s'] for f in r['fields']):.3f} s over "
            f"{len(r['fields'])} evaluations, swap "
            f"{sum(w['duration_s'] for w in r['swaps']):.3f} s over {len(r['swaps'])} "
            f"iterations, frontier {frontiers[i]} vertices, "
            f"{sum(w['attrs'].get('moves', 0) for w in r['swaps'])} moves, vm_step "
            f"launches {r['launches']}; {k_in} requests completed inside the window, "
            f"the worker serving {busy:.3f} s of it ({busy / max(win, 1e-9):.3f}); "
            f"commit latency {r['t_commit'] - r['t1']:.4f} s")
        check(r["attrs"].get("reason") == "topology" and backends == ["cuda"]
              and r["launches"] > 0,
              f"serve: invocation {i} did not run vm_step on the cuda rung")
        if not k_in and spanning:
            b = spanning[0]
            log(f"[serve] invocation {i}: NOT MET: no request completed inside the "
                f"window; the one worker spent it in one micro-batch of {b[2]} "
                f"requests ({b[3]} frontier rows, {b[1] - b[0]:.3f} s) that began "
                f"{b[0] - r['t0']:.4f} s after the window's start and ended "
                f"{b[1] - r['t1']:.3f} s after its end")
        # requests complete inside every window, but where one micro-batch
        # is in service over the whole window: the worker served throughout
        check(k_in > 0 or spanning,
              f"serve: no request completed during invocation {i} and the worker "
              f"was not serving throughout it")
    wall = t_served - t_start
    out_s = max(wall - window_s, 1e-9)
    kern_ms = sum(a.elapsed_time(b) for a, b in timer.events)
    field_s = sum(f["duration_s"] for r in invs for f in r["fields"])
    log(f"[serve] {len(tickets)} requests in {wall:.3f} s ({len(tickets) / wall:.1f} qps), "
        f"{in_window} inside invocation windows ({window_s:.3f} s, "
        f"{in_window / max(window_s, 1e-9):.1f} qps) and {len(tickets) - in_window} "
        f"outside ({out_s:.3f} s, {(len(tickets) - in_window) / out_s:.1f} qps); "
        f"rejections {rejections}; latency p50 {1e3 * np.percentile(lat, 50):.3f} ms, "
        f"p99 {1e3 * np.percentile(lat, 99):.3f} ms; ipt per request "
        f"{ipt.mean():.4f}; stall {stats['invocation_stall_s']:.3f} s, overlap "
        f"{stats['invocation_overlap_s']:.3f} s; n {n0} -> {g.n}, m {m0} -> {g.m}")
    service = np.asarray([b[1] - b[0] for b in batches])
    log(f"[serve] {len(batches)} micro-batches: service time mean "
        f"{service.mean():.4f} s, p50 {np.percentile(service, 50):.4f} s, max "
        f"{service.max():.4f} s; frontier rows a batch mean "
        f"{np.mean([b[3] for b in batches]):.0f}, max {max(b[3] for b in batches)}")
    log(f"[serve] device: vm_step {len(timer.events)} launches {kern_ms:.3f} ms "
        f"({kern_ms / (1e3 * wall):.6f} of the serving wall busy in the kernel); "
        f"the field spans {field_s:.3f} s over "
        f"{sum(len(r['fields']) for r in invs)} evaluations ({field_s / wall:.4f} of "
        f"the wall, an upper bound of the busy share); device memory allocated "
        f"{mem0} B before, {mem1} B after")
    tracer = loop.obs.tracer
    log(f"[serve] traces: {len(invs)} invocation traces, field spans "
        f"{[len(r['fields']) for r in invs]}; {tracer.sampled_traces} sampled of "
        f"{tracer.sampled_traces + tracer.unsampled_traces} traces")

    # the batched enumeration against the reference DFS on the final graph
    t0 = time.perf_counter()
    fixed = WorkloadStream(queries, mode="static", static_freqs=PQ_FREQ,
                           seed=11).sample(SERVE_FULL_ENUM)
    many = loop.executor.enumerate_paths_many(
        fixed, max_results=loop.cfg.max_results_per_query, part=loop.part)
    t_many = time.perf_counter() - t0
    ref = {q.qhash: loop.executor.enumerate_paths_ref(
        q, max_results=loop.cfg.max_results_per_query, part=loop.part) for q in queries}
    same = all(got == ref[q.qhash] for q, got in zip(fixed, many))
    log(f"[serve] enumerate_paths_many over {SERVE_FULL_ENUM} PQ1-4 requests "
        f"({t_many:.3f} s) == enumerate_paths_ref (paths and ipt): {same}")
    check(same, "serve: batched enumeration differs from the reference DFS")

    # the field's effect on the worker: the enumeration beside field
    # evaluations, and beside the field's copies to pageable memory alone
    alone, fields, copies, copy_bytes = _field_beside_serving(torch, loop, fixed)
    a = float(np.median(alone))
    log(f"[serve] field beside serving: the {SERVE_FULL_ENUM}-request enumeration "
        f"alone {[round(x, 4) for x in alone]} s; beside {fields[1]} field evaluations "
        f"(mean {fields[2]:.4f} s each) {[round(x, 4) for x in fields[0]]} s, median "
        f"x{float(np.median(fields[0])) / a:.3f}; beside {copies[1]} rounds of copying "
        f"one field's results ({copy_bytes} B) to pageable memory (mean "
        f"{copies[2]:.4f} s each) {[round(x, 4) for x in copies[0]]} s, median "
        f"x{float(np.median(copies[0])) / a:.3f}")

    # restore from the snapshot and the WAL: bitwise the live loop
    loop.snapshot(sync=True)
    snap = loop._snapshotter
    snap.wait(timeout=SERVE_WAIT_S)
    t0 = time.perf_counter()
    load_serving_snapshot(snap_dir)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = ServingLoop.restore(snap_dir, taper_config=taper_config(),
                                   policy=policy(), device=device)
    t_restore = time.perf_counter() - t0
    res = restored.restore_result
    rg, a_sk, b_sk = restored.g, loop.ot.sketch, restored.ot.sketch
    pairs = [("part", loop.part, restored.part), ("labels", g.labels, rg.labels),
             ("src", g.src, rg.src), ("dst", g.dst, rg.dst),
             ("row_ptr", g.row_ptr, rg.row_ptr)]
    t0 = time.perf_counter()
    pairs += [(f"traversals {q.to_text()}", loop.executor.traversals(q),
               restored.executor.traversals(q)) for q in queries]
    t_trav = time.perf_counter() - t0
    bad = [name for name, a, b in pairs if a.dtype != b.dtype or not np.array_equal(a, b)]
    sketch_same = (a_sk.counts == b_sk.counts and a_sk._stamp == b_sk._stamp
                   and a_sk._ticks == b_sk._ticks)
    log(f"[serve] durability: {snap.saved} snapshots, the last {snap.last_bytes} B "
        f"published in {snap.last_wall_s:.3f} s (capture {snap.last_capture_s:.3f} s); "
        f"WAL {snap.journal.appended} records, {snap.journal.appended_bytes} B appended; "
        f"restore {t_restore:.3f} s: load {t_load:.3f} s, replay {res.replay_wall_s:.3f} s "
        f"({res.replayed} batches), rebuild {t_restore - t_load - res.replay_wall_s:.3f} s; "
        f"executor counts for PQ1-4 (both loops) {t_trav:.3f} s; bitwise: "
        f"graph version {rg.version == g.version}, arrays and counts "
        f"{not bad} {bad}, sketch {sketch_same}")
    check(rg.version == g.version and rg.n == g.n and not bad and sketch_same,
          f"serve: the restored loop differs from the live one ({bad})")
    restored.stop(drain=False)
    shutil.rmtree(snap_dir, ignore_errors=True)
    log(f"[serve] vm_step launches {launches}; path {time.perf_counter() - t_path:.1f} s "
        f"(serving {wall:.1f} s, stop {t_stop - t_served:.1f} s)")
    return dict(launches=launches, **_vm_at_path_shapes(torch, "serve", timer.last_args))


# ---------------------------------------------------------------------------
# phase 5d: the replicated cluster on path 1's graph
# ---------------------------------------------------------------------------


def _device_names(torch, tensors):
    """The devices of the tensors (a CSR's with its plan) in a dict."""
    from repro_torch.kernels.segment_spmm.ops import EdgeCSR

    out = set()
    for t in tensors.values():
        parts = ((t.row_ptr, t.src, t.order, t.plan.runs, t.plan.long_rows)
                 if isinstance(t, EdgeCSR) else (t,))
        out |= {str(p.device) for p in parts if isinstance(p, torch.Tensor)}
    return out


def cluster_full(torch, device, g, part):
    """A replicated cluster on path 1's graph and final partition: an
    inline-driven primary ``ServingLoop`` (the ``cuda`` field, topology
    trigger only, snapshots and the WAL in a temporary directory) and two
    WAL-shipped followers bootstrapped from its seed snapshot.  Routed PQ1-4
    reads; two mutation batches, each follower bitwise the primary after
    each commit; a third batch dies with the primary, which crashes; the
    best follower promotes under epoch 2, bitwise the crashed primary,
    answers, and runs the next batch's invocation on the ``cuda`` rung from
    cold device inputs; the zombie's snapshot publish is fenced; the demoted
    node rejoins by a full bootstrap; every replica ends bitwise the
    promoted primary, and the fixed read batch routed equals its own
    enumeration."""
    import gc
    import shutil
    import tempfile

    import repro_torch.core.visitor as visitor
    from repro_torch.core.online import OnlinePolicy, OnlineTaper
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.taper import TaperConfig
    from repro_torch.kernels.vm_step.ops import vm_step
    from repro_torch.serve import ClusterConfig, ClusterCoordinator, ServeLoopConfig, ServingLoop
    from repro_torch.serve.replication import FollowerReplica
    from repro_torch.workload.stream import GraphMutationStream, WorkloadStream

    t_path = time.perf_counter()
    t_cap = t_path + CLUSTER_FULL_CAP_S

    def within(what):
        check(time.perf_counter() < t_cap,
              f"cluster: {what} not done within the {CLUSTER_FULL_CAP_S:.0f} s cap")

    queries = [parse_rpq(q) for q in PQ]
    fixed = WorkloadStream(queries, mode="static", static_freqs=PQ_FREQ,
                           seed=11).sample(CLUSTER_FULL_READS)
    muts = GraphMutationStream("mixed", seed=7, vertices_per_tick=g.n // 2000,
                               edges_per_tick=g.m // 2000)
    # the online path's policy: the topology trigger only
    policy = OnlinePolicy(dirty_fraction=0.01, cadence=10 ** 9, drift_l1=2.0,
                          ipt_regression=float("inf"))
    snap_dir = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    mem = []

    def memory(point):
        torch.cuda.synchronize()
        mem.append((point, torch.cuda.memory_allocated()))

    # instruments: each device-input rebuild (seconds, bytes), each
    # invocation's run (node, cold or warm, report, rebuilds, launches),
    # each follower apply and commit shipping latency, read batch times
    uploads, invs, applies, reads = [], [], [], []
    device_inputs, run_invocation = visitor._device_inputs, OnlineTaper.run_invocation
    timer = _KernelTimer(torch, vm_step)

    def timed_inputs(g_, pre, cnt, lab_vcount, dev, with_csr=True):
        if pre.get("_dev_key") == (g_.version, dev) and (not with_csr or "csr" in pre["_dev"]):
            return device_inputs(g_, pre, cnt, lab_vcount, dev, with_csr)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = device_inputs(g_, pre, cnt, lab_vcount, dev, with_csr)
        torch.cuda.synchronize()
        uploads.append((time.perf_counter() - t, _live_bytes(torch, out)[0]))
        return out

    def timed_run(ot, pending, should_abort=None):
        cold = "_dev" not in ot.taper._pre
        n_up, n_ev = len(uploads), len(timer.events)
        t0 = time.perf_counter()
        rep = run_invocation(ot, pending, should_abort)
        torch.cuda.synchronize()
        # the node by its slot, not the node itself: the path's device
        # memory readings must not count a demoted node held here
        invs.append(dict(slot=coord.primary_slot if ot is coord.primary.ot else None,
                         cold=cold, wall=time.perf_counter() - t0, report=rep,
                         uploads=uploads[n_up:], events=timer.events[n_ev:],
                         frontier=-1 if pending.frontier is None
                         else int(pending.frontier.size)))
        timer.args_by_shape.clear()                 # only the last launch's args
        return rep

    def watch_follower(f):
        for kind in ("_apply_group", "_apply_commit"):
            fn = getattr(f, kind)

            def timed(frame, fn=fn, kind=kind):
                t0 = time.perf_counter()
                fn(frame)
                applies.append((f.name, kind, t0, time.perf_counter()))
            setattr(f, kind, timed)

    def read(what, qs):
        t0 = time.perf_counter()
        out = coord.serve(qs, cls="hot")
        reads.append((what, len(qs), time.perf_counter() - t0))
        return out

    def run_batch(i):
        """One mutation batch through the primary: applied (journaled,
        shipped), its executor patched, then one PQ1 request a pump until
        the topology trigger's invocation has committed; the commit shipped
        to every follower, each then bitwise the primary."""
        node = coord.primary
        inv0, n_apply, n_inv = node.ot.invocations, len(applies), len(invs)
        t0 = time.perf_counter()
        batch = muts.next_batch(node.g)
        t1 = time.perf_counter()
        check(coord.submit_mutations(batch) is True, f"cluster: batch {i} rejected")
        coord.pump()
        t2 = time.perf_counter()
        for q in queries:
            node.executor.traversals(q)
        t3 = time.perf_counter()
        while node.ot.invocations == inv0:
            within(f"batch {i}'s invocation")
            node.submit(queries[0])
            coord.pump()
        t4 = time.perf_counter()
        while not all(f.commit_index == coord.hub.stats()["retained_commits"]
                      and f.applied_seq == node._applied_seq
                      for f in coord.followers.values()):
            within(f"batch {i}'s shipping")
            coord.pump()
        pub = [t for t in publishes if t >= t3]
        f_apply = {}
        for name, kind, a, b in applies[n_apply:]:
            f_apply.setdefault(name, {}).setdefault(kind, []).append(b - a)
        ship = [b - pub[0] for _, kind, a, b in applies[n_apply:]
                if kind == "_apply_commit" and pub]
        r = invs[n_inv] if len(invs) > n_inv else None
        same = {f.name: _same_state(f.ot, node.ot) for f in coord.followers.values()}
        log(f"[cluster] batch {i} on slot {coord.primary_slot}: n={node.g.n} "
            f"m={node.g.m}; generate {t1 - t0:.3f} s, primary apply (journal, apply, "
            f"ship) {t2 - t1:.3f} s, executor patch for PQ1-4 {t3 - t2:.3f} s; "
            f"follower applies "
            + ", ".join(f"{n} group {sum(v.get('_apply_group', [])):.3f} s commit "
                        f"{sum(v.get('_apply_commit', [])):.4f} s"
                        for n, v in sorted(f_apply.items()))
            + f"; commit shipping latency {[round(x, 4) for x in ship]} s; followers "
            f"bitwise the primary {same}")
        check(r is not None and r["slot"] == coord.primary_slot,
              f"cluster: batch {i}'s invocation did not run on the primary")
        rep = r["report"]
        kern = [a.elapsed_time(b) for a, b in r["events"]]
        log(f"[cluster] invocation {node.ot.invocations} on slot {coord.primary_slot} "
            f"({'cold' if r['cold'] else 'warm'} device inputs): {r['wall']:.3f} s until "
            f"{t4 - t3:.3f} s committed; frontier {r['frontier']} vertices, "
            f"{rep.iterations} iterations, {rep.total_moves} moves; field "
            f"{[round(x, 4) for x in rep.field_seconds]} s (device inputs rebuilt "
            f"{[(round(s, 4), b) for s, b in r['uploads']]} s / B), swap "
            f"{[round(x, 4) for x in rep.swap_seconds]} s; vm_step {len(kern)} launches "
            f"{sum(kern):.3f} ms")
        check(len(kern) > 0, f"cluster: batch {i}'s invocation launched no vm_step")
        check(all(same.values()), f"cluster: a follower differs from the primary after "
                                  f"batch {i}")
        return r

    reset_counts()                                  # the path starts here
    memory("before the cluster")
    bootstrap = FollowerReplica.bootstrap.__func__
    boot_s = []

    def timed_bootstrap(cls, *args, **kwargs):
        t0 = time.perf_counter()
        f = bootstrap(cls, *args, **kwargs)
        boot_s.append(time.perf_counter() - t0)
        return f

    visitor.vm_step, visitor._device_inputs = timer, timed_inputs
    OnlineTaper.run_invocation = timed_run
    FollowerReplica.bootstrap = classmethod(timed_bootstrap)
    coord = old = None
    try:
        t0 = time.perf_counter()
        primary = ServingLoop(
            g, 8, part=part,
            taper_config=TaperConfig(max_iterations=ONLINE_MAX_ITERS, seed=0,
                                     field_backend="cuda"),
            policy=policy, config=ServeLoopConfig(
                overlap_invocations=False, snapshot_dir=snap_dir,
                stop_timeout_s=SERVE_WAIT_S),
            device=device)
        t1 = time.perf_counter()
        coord = ClusterCoordinator(primary, ClusterConfig(n_followers=2,
                                                          heartbeat_timeout_s=CLUSTER_HB_S))
        t2 = time.perf_counter()
        FollowerReplica.bootstrap = classmethod(bootstrap)
        publishes, publish_commit = [], coord.hub.publish_commit

        def timed_publish(*args, **kwargs):
            publishes.append(time.perf_counter())
            return publish_commit(*args, **kwargs)

        coord.hub.publish_commit = timed_publish
        for f in coord.followers.values():
            watch_follower(f)
        memory("after the bootstrap")
        devices = {f.name: str(f.ot.taper.device) for f in coord.followers.values()}
        log(f"[cluster] provgen n={g.n} m={g.m} k=8 from path 1's final partition; primary "
            f"ServingLoop(overlap_invocations=False, field cuda, max_iterations "
            f"{ONLINE_MAX_ITERS}, topology trigger only) built in {t1 - t0:.3f} s; "
            f"ClusterCoordinator(n_followers=2, heartbeat_timeout_s={CLUSTER_HB_S}, "
            f"staleness {coord.cfg.max_staleness_versions}, hedging budgets "
            f"{coord.cfg.slo_budget_s}) in {t2 - t1:.3f} s: seed snapshot "
            f"{t2 - t1 - sum(boot_s):.3f} s, follower bootstraps "
            f"{[round(s, 3) for s in boot_s]} s; followers on {devices}")
        check(len(boot_s) == 2 and set(devices.values()) == {str(primary.ot.taper.device)},
              f"cluster: followers on {devices}, the primary on {primary.ot.taper.device}")
        del primary                                 # the coordinator holds it

        before = read("fixed PQ1-4 batch", fixed)
        check(len(before) == len(fixed), "cluster: the fixed batch went unanswered")
        for i in (1, 2):
            run_batch(i)

        # the primary crashes with a batch submitted but never applied
        old, old_slot = coord.primary, coord.primary_slot
        seq, n_old = old._applied_seq, old.g.n
        check(coord.submit_mutations(muts.next_batch(old.g)) is True,
              "cluster: the lost batch was rejected")
        t_crash = time.perf_counter()
        coord.crash_primary()
        while coord.failovers == 0:
            within("the failover")
            coord.pump()
            time.sleep(0.01)
        t_promoted = time.perf_counter()
        memory("after the failover")
        promoted = coord.primary
        first = read("first answer after the crash (PQ1)", [queries[0]])
        t_first = time.perf_counter()
        log(f"[cluster] failover: detection + promotion {t_promoted - t_crash:.3f} s "
            f"(heartbeat timeout {CLUSTER_HB_S} s), first answer "
            f"{t_first - t_crash:.3f} s ({len(first[0][0])} paths); slot {old_slot} -> "
            f"{coord.primary_slot} at epoch {promoted._epoch}, seq {promoted._applied_seq} "
            f"(crashed primary at {seq}), n {promoted.g.n} (crashed primary at {n_old}); "
            f"promoted loop's rung {promoted._base_backend} on "
            f"{promoted.ot.taper.device}")
        check(promoted is not old and promoted._epoch == 2 and coord.hub.current_epoch == 2
              and promoted._applied_seq == seq and _same_state(promoted.ot, old.ot),
              "cluster: the promoted node is not bitwise the crashed primary at epoch 2")
        check(promoted._base_backend == "cuda" and promoted.ot.taper.device.type == "cuda",
              "cluster: the promoted node is not on the cuda rung")
        check(len(first) == 1 and len(first[0][0]) > 0, "cluster: empty first answer")

        r = run_batch(3)
        pst = promoted.stats()
        on = _device_names(torch, promoted.ot.taper._pre["_dev"])
        check(r["cold"] and pst["field_backend"] == "cuda"
              and pst["backend_fallbacks"] == 0 and on == {"cuda:0"},
              f"cluster: the promoted node's invocation (cold {r['cold']}, rung "
              f"{pst['field_backend']}, fallbacks {pst['backend_fallbacks']}, field "
              f"tensors on {on}) is not the cold cuda run on the card")

        # the zombie's snapshot publish is fenced
        fw0 = old.stats()["fenced_writes"]
        old.snapshot(sync=True)
        zst = old.stats()
        log(f"[cluster] zombie snapshot publish: fenced writes {fw0} -> "
            f"{zst['fenced_writes']}, its epoch {zst['epoch']}, the cluster's "
            f"{zst['cluster_epoch']}")
        check(zst["fenced_writes"] > fw0 and zst["epoch"] == 1 and zst["cluster_epoch"] == 2,
              "cluster: the zombie's snapshot publish was not fenced")

        # the demoted node rejoins by a full bootstrap from the promoted
        # node's snapshot
        wal = (old._journal.appended_bytes, promoted._journal.appended_bytes)
        snaps = (old._snapshotter.saved, old._snapshotter.last_bytes,
                 promoted._snapshotter.saved, promoted._snapshotter.last_bytes)
        old = None
        t0 = time.perf_counter()
        f = coord.rejoin_demoted(slot=old_slot, reuse_state=False)
        t_rejoin = time.perf_counter() - t0
        gc.collect()                                # the demoted loop's buffers
        memory("after the rejoin")
        for f in coord.followers.values():
            f.catch_up()
        same = {f.name: (_same_state(f.ot, promoted.ot), str(f.ot.taper.device))
                for f in coord.followers.values()}
        log(f"[cluster] rejoin of slot {old_slot} (full bootstrap) {t_rejoin:.3f} s; "
            f"replicas bitwise the promoted primary, on: {same}")
        check(all(s for s, _ in same.values())
              and {d for _, d in same.values()} == {str(promoted.ot.taper.device)},
              "cluster: a replica differs from the promoted primary")
        direct = promoted.executor.enumerate_paths_many(
            fixed, max_results=coord.cfg.max_results_per_query, part=promoted.ot.part)
        routed = read("fixed PQ1-4 batch", fixed)
        check(routed == direct, "cluster: routed reads differ from the primary's own")
        launches = read_counts("cluster", ["vm_step"])["vm_step"]  # ... ends here
        rst = coord.router.stats()
    finally:
        visitor.vm_step, visitor._device_inputs = vm_step, device_inputs
        OnlineTaper.run_invocation = run_invocation
        FollowerReplica.bootstrap = classmethod(bootstrap)
        try:
            if coord is not None:
                coord.stop()
        finally:
            shutil.rmtree(snap_dir, ignore_errors=True)
    memory("at the end")
    log(f"[cluster] reads: "
        + "; ".join(f"{w} ({n} requests) {s:.3f} s" for w, n, s in reads)
        + f"; hedged requests {rst['hedged_requests']}, read failovers "
          f"{rst['read_failovers']}, staleness fallbacks {rst['staleness_fallbacks']}, "
          f"routed by slot {rst['routed_by_slot']}")
    log(f"[cluster] WAL appended: crashed primary {wal[0]} B, promoted {wal[1]} B; "
        f"snapshots: crashed primary {snaps[0]} (last {snaps[1]} B), promoted "
        f"{snaps[2]} (last {snaps[3]} B); device memory allocated: "
        + ", ".join(f"{p} {b} B" for p, b in mem))
    log(f"[cluster] {len(invs)} invocations, vm_step launches {launches}; path "
        f"{time.perf_counter() - t_path:.1f} s")
    # the kernel at the promoted node's shapes: its invocation launched last
    return dict(launches=launches, **_vm_at_path_shapes(torch, "cluster", timer.last_args))


# ---------------------------------------------------------------------------
# phase 6: DLRM serving at full width
# ---------------------------------------------------------------------------


def _unique_rows(torch, ids, V):
    u = torch.unique(ids)
    return int(((u >= 0) & (u < V)).sum())


def _bag_times(torch, table, ids, V, reps, plain_reps=0):
    """The bag kernel's time per launch on ``ids`` (sum), its bound (ids
    and distinct rows read once, the output written once; one add per slot
    and column), ``F.embedding_bag``'s time and its largest difference, and
    with ``plain_reps`` the plain version's time."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference

    nb, H = ids.shape
    d = table.shape[1]
    ms = _time_ms(torch, lambda: embedding_bag(table, ids), reps)
    lib = lambda: torch.nn.functional.embedding_bag(ids, table, mode="sum")  # noqa: E731
    library_ms = _time_ms(torch, lib, reps)
    lib_err = float((lib() - embedding_bag(table, ids)).abs().max())
    plain_ms = (_time_ms(torch, lambda: embedding_bag_reference(table, ids), plain_reps)
                if plain_reps else None)
    rows = _unique_rows(torch, ids, V)
    bytes_moved = 4 * (nb * H + rows * d + nb * d)
    bound_ms, bound_by = _bound(bytes_moved, nb * H * d)
    # the yardstick of a launch whose rows are never found in L2: every
    # bag reads each of its distinct valid rows once
    srt = torch.sort(ids, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    per_bag = int((first & (srt >= 0) & (srt < V)).sum())
    yard_ms = 4 * (nb * H + per_bag * d + nb * d) / PEAK_BYTES_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, lib_err=lib_err,
                bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_moved, bags=nb, H=H,
                d=d, rows=rows, per_bag=per_bag, yard_ms=yard_ms)


def _bag_text(t):
    plain = "" if t["plain_ms"] is None else f", plain {t['plain_ms']:.4f} ms"
    return (f"bags {t['bags']}, H={t['H']}, d={t['d']}, distinct rows {t['rows']}: kernel "
            f"{t['ms']:.4f} ms ({t['bound_ms'] / t['ms']:.3f} of the bound){plain}, "
            f"F.embedding_bag {t['library_ms']:.4f} ms (max diff to the kernel "
            f"{t['lib_err']:.3e}), bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"({t['bytes']} B); rows read once per bag ({t['per_bag']}, none from L2) "
            f"{t['yard_ms']:.4f} ms, the kernel at {t['yard_ms'] / t['ms']:.3f} of it")


def dlrm_serving(torch, device):
    import dataclasses
    import math

    import numpy as np
    import repro_torch.models.dlrm as dlrm
    from repro_torch.configs.base import DLRM_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.data.recsys import ClickLogPipeline
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference
    from repro_torch.models.gnn.common import mlp_apply

    cfg = dataclasses.replace(get_config("dlrm-rm2"), multi_hot=DLRM_MULTI_HOT)
    shapes = {s.name: s for s in DLRM_SHAPES}
    V, d = cfg.total_rows(), cfg.embed_dim
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dlrm.init(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    log(f"[dlrm] {cfg.name} multi_hot={cfg.multi_hot}: table {V} x {d} float32 "
        f"({V * d * 4 / 1e9:.2f} GB) + MLPs, {cfg.n_params()} parameters, "
        f"initialised on the card in {t_init:.2f} s")

    t0 = time.perf_counter()
    requests = {}
    for seed, (name, count) in enumerate(DLRM_REQUESTS.items(), start=1):
        pipe = ClickLogPipeline(cfg, shapes[name].dim("batch"), seed=seed)
        requests[name] = [next(pipe) for _ in range(count)]
    log(f"[dlrm] click-log requests {', '.join(f'{k} {len(v)} x B={shapes[k].dim('batch')}' for k, v in requests.items())} "
        f"generated on the host in {time.perf_counter() - t0:.2f} s")

    def upload(req):
        return {k: torch.as_tensor(v, device=device) for k, v in req.items()
                if k != "labels"}

    timer = _KernelTimer(torch, embedding_bag)
    dlrm.embedding_bag = timer
    latency, split, last = {}, {}, {}
    try:
        reset_counts()                              # the path starts here
        for name, reqs in requests.items():
            latency[name], split[name] = [], []
            for req in reqs:
                t0 = time.perf_counter()
                batch = upload(req)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                prob = dlrm.serve_step(params, batch, cfg)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                prob = prob.cpu()
                t3 = time.perf_counter()
                latency[name].append(t3 - t0)
                split[name].append((t1 - t0, t2 - t1, t3 - t2))
            last[name] = (batch, prob)
        counts = read_counts("dlrm", ["embedding_bag"])  # ... and ends here
    finally:
        dlrm.embedding_bag = embedding_bag
    torch.cuda.synchronize()
    check(counts["embedding_bag"] == sum(len(r) for r in requests.values()),
          "one embedding_bag launch per request")
    per_launch = timer.ms_by_shape()
    for name, lat in latency.items():
        B = shapes[name].dim("batch")
        ids_shape = (B * cfg.n_sparse, cfg.multi_hot)
        ms = [v for k, v in per_launch.items() if k[1] == ids_shape][0]
        med = sorted(range(len(lat)), key=lat.__getitem__)[len(lat) // 2]
        # the bag kernel's bound on the last request's ids (as at serve_bulk below)
        ids = last[name][0]["sparse"].reshape(-1, cfg.multi_hot)
        nb, H = ids.shape
        bound_ms, bound_by = _bound(4 * (nb * H + _unique_rows(torch, ids, V) * d + nb * d),
                                    nb * H * d)
        log(f"[dlrm] {name} B={B}: request latency (upload, serve_step, read "
            f"back) ms {[round(x * 1e3, 3) for x in lat]}; median "
            f"{lat[med] * 1e3:.3f} ms = upload {split[name][med][0] * 1e3:.3f} + "
            f"serve_step {split[name][med][1] * 1e3:.3f} + read back "
            f"{split[name][med][2] * 1e3:.3f}; embedding_bag per launch ms "
            f"{[round(x, 4) for x in ms]} (median {sorted(ms)[len(ms) // 2]:.4f}), "
            f"bound {bound_ms:.4f} ms by {bound_by} on the last request's ids; "
            f"{device_line()}")

    # kernel forward against plain forward on the same batch
    def plain_bag(table, ids):
        return embedding_bag_reference(table, ids)

    worst = 0.0
    for name, (batch, prob) in last.items():
        check(prob.shape == (shapes[name].dim("batch"),), f"{name}: output shape")
        check(bool(torch.isfinite(prob).all() and ((prob >= 0) & (prob <= 1)).all()),
              f"{name}: probabilities outside [0, 1]")
        dlrm.embedding_bag = plain_bag
        try:
            plain = dlrm.serve_step(params, batch, cfg).cpu()
        finally:
            dlrm.embedding_bag = embedding_bag
        err = float((prob - plain).abs().max())
        ok = bool(torch.allclose(prob, plain, rtol=DLRM_RTOL, atol=DLRM_ATOL))
        log(f"[dlrm] {name}: kernel forward vs plain forward max_abs_err={err:.3e} "
            f"bitwise={bool(torch.equal(prob, plain))} allclose(rtol={DLRM_RTOL}, "
            f"atol={DLRM_ATOL})={ok}; mean click probability {float(prob.mean()):.4f}")
        check(ok, f"{name}: kernel forward disagrees with the plain forward")

    # retrieval: one user against 10^6 candidates
    n_cand = shapes["retrieval_cand"].dim("n_candidates")
    gen = torch.Generator(device=device).manual_seed(3)
    cand = torch.randn((n_cand, d), generator=gen, device=device) / math.sqrt(d)
    query = {"dense": torch.as_tensor(requests["serve_p99"][0]["dense"][:1], device=device)}
    t0 = time.perf_counter()
    vals, idx = dlrm.retrieval_step(params, query, cand, top_k=100)
    torch.cuda.synchronize()
    t_ret = time.perf_counter() - t0
    bot_cpu = [{k: v.cpu() for k, v in p.items()} for p in params["bot"]]
    user = mlp_apply(bot_cpu, query["dense"].cpu(), final_act=True)
    cvals, cidx = torch.topk(cand.cpu() @ user[0], 100)
    ok = bool(torch.allclose(vals.cpu(), cvals, rtol=DLRM_RTOL, atol=DLRM_ATOL))
    same = set(idx.tolist()) == set(cidx.tolist())
    log(f"[dlrm] retrieval_step over {n_cand} candidates: {t_ret * 1e3:.3f} ms "
        f"(host clock, first call); top-100 scores vs the CPU allclose={ok}, "
        f"same top-100 set={same}")
    check(ok, "retrieval scores disagree with the CPU's")
    del cand

    # the bag kernel on independent zipf ids over the whole table
    rng = np.random.default_rng(7)
    offsets = dlrm.table_offsets(cfg)
    Bz = 16384
    cols = [np.minimum((v * rng.random((Bz, cfg.multi_hot)) ** 3.0).astype(np.int64),
                       v - 1) + offsets[f] for f, v in enumerate(cfg.vocab_sizes)]
    zipf = torch.as_tensor(np.stack(cols, axis=1).reshape(-1, cfg.multi_hot)
                           .astype(np.int32), device=device)
    table = params["embedding"]
    out = embedding_bag(table, zipf)
    ref = embedding_bag_reference(table, zipf)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = bool(torch.allclose(out, ref, rtol=BAG_RTOL, atol=BAG_ATOL))
    check(ok, "embedding_bag disagrees with its plain version on zipf ids")
    worst = max(worst, err)
    zipf_times = _bag_times(torch, table, zipf, V, 10)
    log(f"[dlrm] embedding_bag on independent zipf ids over the whole table: "
        f"{_bag_text(zipf_times)}; max_abs_err={err:.3e} allclose(rtol={BAG_RTOL}, "
        f"atol={BAG_ATOL})={ok}; max row id {int(zipf.max())}; {device_line()}")
    del zipf, out, ref

    # the kernel at serve_bulk's shapes: the last bulk request's ids
    ids = last["serve_bulk"][0]["sparse"].reshape(-1, cfg.multi_hot)
    t = _bag_times(torch, table, ids, V, 10, plain_reps=3)
    ms, plain_ms, library_ms = t["ms"], t["plain_ms"], t["library_ms"]
    bound_ms, bound_by = t["bound_ms"], t["bound_by"]
    log(f"[dlrm] embedding_bag at serve_bulk: {_bag_text(t)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {device_line()}")
    return dict(launches=counts["embedding_bag"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                err=worst)


# ---------------------------------------------------------------------------
# phase 7: TAPER's embedding-row placement
# ---------------------------------------------------------------------------


def row_placement(torch, device):
    import dataclasses

    import numpy as np
    import repro_torch.core.visitor as visitor
    from repro_torch.configs.registry import get_config
    from repro_torch.core.taper import Taper, TaperConfig
    from repro_torch.data.recsys import ClickLogPipeline
    from repro_torch.graphs.partition import hash_partition
    from repro_torch.kernels.vm_step.ops import vm_step
    from repro_torch.models.dlrm import coaccess_graph, query_span

    base = get_config("dlrm-rm2")
    cfg = dataclasses.replace(base.reduced(), vocab_sizes=tuple(
        min(v, 1000) for v in base.vocab_sizes))
    pipe = ClickLogPipeline(cfg, batch=1024, seed=0, n_segments=32, p_segment=0.95)
    batches = [next(pipe)["sparse"] for _ in range(4)]
    t0 = time.perf_counter()
    g, row_of_vertex = coaccess_graph(cfg, batches, max_rows_per_field=1000)
    t_graph = time.perf_counter() - t0
    w = _span_workload()
    part0 = hash_partition(g.n, SPAN_K, seed=1)

    def config(**kw):
        return TaperConfig(max_iterations=5, balance_eps=0.2, family_max_size=26,
                           seed=0, **kw)

    timer = _KernelTimer(torch, vm_step)
    visitor.vm_step = timer
    try:
        reset_counts()                              # the path starts here
        t0 = time.perf_counter()
        rep = Taper(g, SPAN_K, config(), device=device).invoke(part0, w)
        t_inv = time.perf_counter() - t0
        counts = read_counts("placement", ["vm_step"])  # ... and ends here
    finally:
        visitor.vm_step = vm_step
    torch.cuda.synchronize()
    kern_ms = [a.elapsed_time(b) for a, b in timer.events]
    t0 = time.perf_counter()
    rep_plain = Taper(g, SPAN_K, config(field_backend="torch"),
                      device=device).invoke(part0, w)
    t_plain = time.perf_counter() - t0
    same = (len(rep.parts) == len(rep_plain.parts)
            and all(np.array_equal(a, b) for a, b in zip(rep.parts, rep_plain.parts)))

    place0 = hash_partition(cfg.total_rows(), SPAN_K, seed=1)
    place1 = place0.copy()
    place1[row_of_vertex] = rep.final_part
    evals = [next(pipe)["sparse"] for _ in range(4)]
    span0 = float(np.mean([query_span(place0, b, SPAN_K) for b in evals]))
    span1 = float(np.mean([query_span(place1, b, SPAN_K) for b in evals]))
    alpha_shape = timer.last_args[0].shape
    log(f"[placement] co-access graph n={g.n} undirected edges={g.m // 2} "
        f"({t_graph:.2f} s host), trie nodes {alpha_shape[1]}, k={SPAN_K}")
    log(f"[placement] invocation {t_inv:.2f} s: {rep.iterations} iterations, "
        f"{rep.total_moves} moves, field {sum(rep.field_seconds):.3f} s "
        f"(kernel {sum(kern_ms):.3f} ms over {len(kern_ms)} launches, "
        f"{min(kern_ms):.4f}-{max(kern_ms):.4f} ms each), swap "
        f"{sum(rep.swap_seconds):.3f} s; plain-field invocation {t_plain:.2f} s; "
        f"partitions equal to the plain field's: {same}")
    log(f"[placement] query span over 4 x 1024 requests: hash {span0!r} -> TAPER "
        f"{span1!r} (reduction {1 - span1 / span0:.4f}); the JAX package's flow "
        f"gives {SPAN_REFERENCE[0]!r} -> {SPAN_REFERENCE[1]!r}")
    check(same, "placement: the kernel field's partitions differ from the "
                "plain field's")
    check((span0, span1) == SPAN_REFERENCE,
          f"placement spans {(span0, span1)} differ from the reference's "
          f"{SPAN_REFERENCE}")
    # the kernel at the path's shapes: its last launch's arguments
    return dict(launches=counts["vm_step"],
                **_vm_at_path_shapes(torch, "placement", timer.last_args))


# ---------------------------------------------------------------------------
# phase 8: GCN inference at ogb_products
# ---------------------------------------------------------------------------


def gcn_inference(torch, device):
    import repro_torch.models.gnn.gcn as gcn
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.data.graphs import batch_to_device, random_graph_batch
    from repro_torch.kernels.segment_spmm.kernel import segment_spmm_cuda
    from repro_torch.kernels.segment_spmm.ops import segment_spmm_csr, vector_width
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_reference
    from repro_torch.models.gnn import api

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("gcn-cora")
    shape = [s for s in GNN_SHAPES if s.name == "ogb_products"][0]
    t0 = time.perf_counter()
    host = random_graph_batch(cfg, shape, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = batch_to_device(host, device)
    del host
    params = api.init(cfg, shape, seed=0, device=device)
    csr = gcn.graph_csr(batch)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    n, E = batch["node_feat"].shape[0], batch["edge_src"].shape[0]
    log(f"[gcn] {cfg.name} on {shape.name}: n={n} E={E} d_feat="
        f"{batch['node_feat'].shape[1]} classes={cfg.n_classes}; graph generated "
        f"in {t_gen:.2f} s (host), uploaded + CSR built in {t_up:.2f} s")

    timer = _KernelTimer(torch, segment_spmm_csr)
    gcn.segment_spmm_csr = timer
    lat = []
    try:
        reset_counts()                              # the path starts here
        for _ in range(GCN_FORWARDS):
            t0 = time.perf_counter()
            logits = gcn.forward(params, batch, cfg, csr=csr)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        counts = read_counts("gcn", ["segment_spmm"])  # ... and ends here
    finally:
        gcn.segment_spmm_csr = segment_spmm_csr
    check(counts["segment_spmm"] == 2 * GCN_FORWARDS, "two launches per forward")
    check(logits.shape == (n, cfg.n_classes) and bool(torch.isfinite(logits).all()),
          "gcn logits: shape or non-finite values")
    per_launch = timer.ms_by_shape()
    for key, ms in per_launch.items():
        log(f"[gcn] segment_spmm at x {key[0]}: ms per launch {[round(x, 4) for x in ms]}")
    log(f"[gcn] forward (host clock, synchronised) s {[round(x, 4) for x in lat]}")

    # kernel forward against plain forward (the plain SpMM takes the edges in
    # chunks of 2^22, so its message tensor stays at 1.7 GB)
    gcn.segment_spmm_csr = lambda x, csr, w: segment_spmm_csr_reference(  # noqa: E731
        x, csr.row_ptr, csr.src, w)
    try:
        plain = gcn.forward(params, batch, cfg, csr=csr)
    finally:
        gcn.segment_spmm_csr = segment_spmm_csr
    torch.cuda.synchronize()
    err = float((logits - plain).abs().max())
    ok = bool(torch.allclose(logits, plain, rtol=GCN_RTOL, atol=GCN_ATOL))
    log(f"[gcn] kernel forward vs plain forward (whole graph): max_abs_err={err:.3e} "
        f"allclose(rtol={GCN_RTOL}, atol={GCN_ATOL})={ok}; predicted-class "
        f"histogram {torch.bincount(logits.argmax(-1), minlength=cfg.n_classes).tolist()}")
    check(ok, "gcn kernel forward disagrees with the plain forward")

    # each launch shape of the path: kernel, plain, library, bound
    out = None
    for key, args in sorted(timer.args_by_shape.items(), key=lambda kv: -kv[0][0][1]):
        x, csr, w = args
        row_ptr, src = csr.row_ptr, csr.src
        F = x.shape[1]
        # the kernel alone, and through the wrapper (host-side checks only:
        # the CSR was checked once, when it was built)
        vec = vector_width(x)
        ms = _time_ms(torch, lambda: segment_spmm_cuda(x, row_ptr, src, w, vec), 10)
        wrapper_ms = _time_ms(torch, lambda: segment_spmm_csr(x, csr, w), 10)
        plain_ms = _time_ms(torch, lambda: segment_spmm_csr_reference(x, row_ptr, src, w), 2)
        with warnings.catch_warnings():             # "beta state" notices
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(row_ptr, src, w, size=(n, n))
        library_ms = _time_ms(torch, lambda: torch.sparse.mm(A, x), 10)
        k_out = segment_spmm_csr(x, csr, w)
        lib_err = float((torch.sparse.mm(A, x) - k_out).abs().max())
        p_err = float((segment_spmm_csr_reference(x, row_ptr, src, w) - k_out).abs().max())
        live = w != 0
        srcs = int(torch.unique(src[live]).numel())
        nnz = int(live.sum())
        bytes_moved = 4 * ((n + 1) + 2 * E + srcs * F + n * F)
        flops = 2 * nnz * F
        bound_ms, bound_by = _bound(bytes_moved, flops)
        start = x.data_ptr() % 32 + src[live].long() * (4 * F)
        gathered = int(((start + 4 * F - 1) // 32 - start // 32 + 1).sum()) * 32
        other = bytes_moved - 4 * srcs * F
        log(f"[gcn] segment_spmm at F={F} (n={n}, E={E}, nonzero weights {nnz}, "
            f"distinct sources {srcs}): kernel {ms:.4f} ms (through the wrapper "
            f"{wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms "
            f"(max diff {p_err:.3e}), torch.sparse.mm {library_ms:.4f} ms (max diff "
            f"{lib_err:.3e}), bound {bound_ms:.4f} ms by {bound_by} ({bytes_moved} B, "
            f"{flops} FLOP), {vec}-float loads; "
            f"{_yardstick_text(gathered, other, kernel=ms, torch_sparse_mm=library_ms)}")
        check(p_err <= SPMM_ATOL + SPMM_RTOL * float(k_out.abs().max()),
              f"segment_spmm disagrees with its plain version at F={F}")
        del A, k_out
        if out is None:                             # the widest launch: F = 100
            out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms, err=max(err, p_err))
    log(f"[gcn] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    out["launches"] = counts["segment_spmm"]
    return out


# ---------------------------------------------------------------------------
# phase 9: qwen3-4b serving at full width
# ---------------------------------------------------------------------------


def _sdpa_ms(torch, q, k, v, out_k):
    """Time of ``F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)`` on q, k, v (moved to its (B, heads, S, D) layout
    first, outside the timing) and its largest difference from the kernel's
    output.  Only the fused back ends may run: the math one would hold a
    137 GB score tensor at 32k tokens.  In float32 only the memory-efficient
    back end runs, and it takes no GQA: k and v are repeated to the query
    heads first, outside the timing."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    gqa = q.dtype != torch.float32
    if not gqa:
        kt, vt = (t.repeat_interleave(q.shape[2] // k.shape[2], dim=1) for t in (kt, vt))

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=gqa)

    backends = ([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                 SDPBackend.EFFICIENT_ATTENTION] if gqa else [SDPBackend.EFFICIENT_ATTENTION])
    with sdpa_kernel(backends):
        ms = _time_ms(torch, call, 5)
        diff = float((call().transpose(1, 2).float() - out_k.float()).abs().max())
    return ms, diff


def _attn_at_path_shape(torch, args, reps, time_f32=False):
    """Kernel, plain version and SDPA on one captured layer's q, k, v; the
    kernel against the plain version; the bound of the work.  The same q,
    k, v in float32 go through the float32 kernel, which ``time_f32`` also
    times (with its plain version, SDPA's memory-efficient back end and its
    bounds: three TF32 products at the tensor-core peak, and beside it one
    float32 product at the CUDA-core peak)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    q, k, v = args
    B, S, H, D = q.shape
    out_k = flash_attention(q, k, v)
    out_p = flash_attention_reference(q, k, v)
    torch.cuda.synchronize()
    err = float((out_k.float() - out_p.float()).abs().max())
    rms = float(out_p.float().square().mean().sqrt())
    rtol, atol = ATTN_TOL["bfloat16"]
    ok = bool(torch.allclose(out_k.float(), out_p.float(), rtol=rtol, atol=atol))
    ok_rms = bool(torch.allclose(out_k.float(), out_p.float(), rtol=ATTN_PATH_RTOL,
                                 atol=ATTN_PATH_ATOL_RMS * rms))
    del out_p
    pairs = int(_keys_per_row(S, S, True, None).sum())
    flops = 4 * D * pairs * B * H
    q32, k32, v32 = (t.float() for t in args)
    o32_k = flash_attention(q32, k32, v32)
    o32_p = flash_attention_reference(q32, k32, v32)
    err32 = float((o32_k - o32_p).abs().max())
    rtol32, atol32 = ATTN_TOL["float32"]
    ok32 = bool(torch.allclose(o32_k, o32_p, rtol=rtol32, atol=atol32))
    del o32_p
    f32 = None
    if time_f32:
        ms32 = _time_ms(torch, lambda: flash_attention(q32, k32, v32), reps)
        plain32 = _time_ms(torch, lambda: flash_attention_reference(q32, k32, v32), 2)
        lib32, lib_diff32 = _sdpa_ms(torch, q32, k32, v32, o32_k)
        bytes32 = 4 * (2 * q.numel() + k.numel() + v.numel())
        # the least time: the three TF32 products on the tensor cores; beside
        # it, the one float32 product on the CUDA cores
        bound32, by32 = _bound(bytes32, 3 * flops, PEAK_TF32_FLOPS)
        cuda_core32, _ = _bound(bytes32, flops, PEAK_F32_FLOPS)
        f32 = dict(ms=ms32, plain_ms=plain32, bound_ms=bound32, bound_by=by32,
                   library_ms=lib32, err=err32)
        log(f"[qwen3] flash_attention_f32 at B={B} S={S} H={H} KV={k.shape[2]} D={D} "
            f"float32 (the same q/k/v): kernel {ms32:.4f} ms ({flops / ms32 / 1e9:.2f} "
            f"TFLOP/s, {ms32 / lib32:.3f}x SDPA's time), plain {plain32:.4f} ms, SDPA "
            f"(memory-efficient back end) {lib32:.4f} ms (max diff to the kernel "
            f"{lib_diff32:.3e}), bound {bound32:.4f} ms by {by32} (3 x {flops} FLOP at the "
            f"TF32 tensor-core {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; {bound32 / ms32:.3f} of "
            f"it), {cuda_core32:.4f} ms for one product at the float32 CUDA-core "
            f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s; max_abs_err vs plain {err32:.3e}; "
            f"{device_line()}")
    del q32, k32, v32, o32_k
    ms = _time_ms(torch, lambda: flash_attention(q, k, v), reps)
    plain_ms = _time_ms(torch, lambda: flash_attention_reference(q, k, v), 2)
    library_ms, lib_diff = _sdpa_ms(torch, q, k, v, out_k)
    bytes_moved = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    bound_ms, bound_by = _bound(bytes_moved, flops, PEAK_BF16_FLOPS)
    log(f"[qwen3] flash_attention at B={B} S={S} H={H} KV={k.shape[2]} D={D} "
        f"{str(q.dtype).split('.')[-1]} (one layer's q/k/v): kernel {ms:.4f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s, {ms / library_ms:.3f}x SDPA's time, "
        f"{bound_ms / ms:.3f} of the bound), plain {plain_ms:.4f} ms, SDPA "
        f"{library_ms:.4f} ms (max diff to the kernel {lib_diff:.3e}), "
        f"bound {bound_ms:.4f} ms by {bound_by} ({bytes_moved} B, {flops} FLOP at "
        f"the bf16 tensor-core peak); kernel vs plain: output RMS {rms:.4e}, "
        f"max_abs_err={err:.3e}, allclose(rtol={rtol}, atol={atol})={ok}, "
        f"allclose(rtol=2^-7, atol={ATTN_PATH_ATOL_RMS} x RMS)={ok_rms}; the same "
        f"q/k/v in float32 max_abs_err={err32:.3e} allclose(rtol={rtol32}, "
        f"atol={atol32})={ok32}; {device_line()}")
    check(ok and ok_rms, f"flash_attention disagrees with its plain version at "
                         f"B={B} S={S} (bf16)")
    check(ok32, f"flash_attention disagrees with its plain version at B={B} S={S} "
                f"(float32)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, err=err, err32=err32, f32=f32)


def _profile_step(torch, fn, top=0):
    """One call of ``fn`` under ``torch.profiler``: its wall time there
    (host clock, synchronised), the device's busy time (the union of the
    intervals of its kernels, copies and fills), the count of those device
    operations, and of the top-level aten ops the host issued.  The busy
    time is None when the trace holds no device event.  With ``top``, also
    the ``top`` ops by self host time: (name, ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                              # union of the intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    host_ops = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and e.cpu_parent is None and e.name.startswith("aten::"))
    by_self = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:top]
    return dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3 if spans else None,
                device_ops=len(spans), host_ops=host_ops,
                top=[(a.key, a.self_cpu_time_total / 1e3, a.count) for a in by_self])


def qwen3_serving(torch, device):
    import dataclasses

    import repro_torch.models.transformer as tf
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm import TokenPipeline
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    torch.cuda.empty_cache()
    cfg = get_config("qwen3-4b")
    L, V = cfg.n_layers, cfg.vocab
    t0 = time.perf_counter()
    params = tf.init(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[qwen3] {cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.n_heads} query / "
        f"{cfg.n_kv_heads} KV heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab {V}, "
        f"{cfg.dtype}: {n_params} parameters ({n_params * 2 / 1e9:.2f} GB), "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s; requests "
        f"{', '.join(f'{B} x {S} tokens + {n} decode steps' for B, S, n in QWEN_SETS.values())}"
        f"; cut: prefill_32k's batch of 32 served as 1 (32 KV caches are 155 GB)")
    requests = {name: torch.as_tensor(next(TokenPipeline(V, B, S, seed=0))["tokens"],
                                      device=device)
                for name, (B, S, _) in QWEN_SETS.items()}

    timer = _KernelTimer(torch, flash_attention)
    tf.flash_attention = timer
    served = {}
    try:
        reset_counts()                              # the path starts here
        for name, (B, S, steps) in QWEN_SETS.items():
            torch.cuda.reset_peak_memory_stats()
            first = len(timer.events)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _, pre = tf.forward(params, requests[name], cfg, return_cache=True)
            nxt = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            check(logits.shape == (B, S, V) and _all_finite(torch, logits),
                  f"qwen3 {name}: prefill logits of shape {tuple(logits.shape)} or "
                  f"non-finite")
            del logits
            cache = tf.init_cache(cfg, B, S + steps + 1, device=device)
            cache["k"][:, :, :S] = pre["k"]
            cache["v"][:, :, :S] = pre["v"]
            cache["pos"] = pre["pos"]
            del pre
            generated, step_s = [nxt], []
            for _ in range(steps):
                t0 = time.perf_counter()
                logits, cache = tf.decode_step(params, cache, nxt, cfg)
                nxt = logits[:, -1:].argmax(-1)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                check(logits.shape == (B, 1, V) and bool(torch.isfinite(logits).all()),
                      f"qwen3 {name}: decode logits of shape {tuple(logits.shape)} or "
                      f"non-finite")
                generated.append(nxt)
            toks = torch.cat(generated, dim=1)
            check(bool(((toks >= 0) & (toks < V)).all()), f"qwen3 {name}: token ids")
            # one more step, traced: the device's busy share of a decode step
            prof = _profile_step(torch, lambda: tf.decode_step(params, cache, nxt, cfg))
            served[name] = dict(prefill_s=t_prefill, step_s=step_s, prof=prof,
                                launches=len(timer.events) - first,
                                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                first_tokens=toks[0, :8].tolist())
            del cache, logits
        counts = read_counts("qwen3", ["flash_attention"])  # ... and ends here
    finally:
        tf.flash_attention = flash_attention
    torch.cuda.synchronize()
    per_launch = timer.ms_by_shape()
    for name, (B, S, steps) in QWEN_SETS.items():
        st = served[name]
        ms = per_launch[((B, S, cfg.n_heads, cfg.d_head), (B, S, cfg.n_kv_heads, cfg.d_head),
                         (B, S, cfg.n_kv_heads, cfg.d_head))]
        dec = sorted(st["step_s"])
        log(f"[qwen3] {name}: prefill {st['prefill_s']:.3f} s ({B * S / st['prefill_s']:.0f} "
            f"tokens/s; flash_attention {sum(ms):.1f} ms over {st['launches']} launches, "
            f"{min(ms):.3f}-{max(ms):.3f} ms each); decode {steps} greedy steps, per step "
            f"(batch {B}) s {[round(x, 4) for x in st['step_s']]}, median "
            f"{dec[len(dec) // 2] * 1e3:.2f} ms; peak memory {st['peak_gb']:.2f} GB; "
            f"first tokens of request 0 {st['first_tokens']}")
        pr = st["prof"]
        busy = ("not traced (the trace holds no device event)" if pr["busy_ms"] is None
                else f"{pr['busy_ms']:.3f} ms, {100 * pr['busy_ms'] / pr['wall_ms']:.2f}% "
                     f"of the traced step and {100 * pr['busy_ms'] / (dec[len(dec) // 2] * 1e3):.2f}% "
                     f"of the median untraced step")
        log(f"[qwen3] {name}: one decode step under torch.profiler: {pr['wall_ms']:.2f} ms, "
            f"{pr['host_ops']} top-level aten ops ({pr['wall_ms'] * 1e3 / max(pr['host_ops'], 1):.1f} "
            f"us each), {pr['device_ops']} device operations; device busy {busy}")
        check(st["launches"] == L, f"qwen3 {name}: {st['launches']} flash_attention "
                                   f"launches in one prefill, want {L}")
    check(counts["flash_attention"] == L * len(QWEN_SETS),
          "one flash_attention launch per layer per prefill")
    check(all(counts[n] == 0 for n in counts if n != "flash_attention"),
          "qwen3 serving launched another kernel")

    records = {}
    for name, (B, S, _) in QWEN_SETS.items():
        key = [k for k in timer.args_by_shape if k[0] == (B, S, cfg.n_heads, cfg.d_head)][0]
        reps = 3 if S > 8192 else 10
        records[name] = dict(launches=served[name]["launches"],
                             **_attn_at_path_shape(torch, timer.args_by_shape[key], reps,
                                                   time_f32=name == "4x4096"))
    del timer, params, requests
    torch.cuda.empty_cache()

    # whole-path gate: the full-width model in float32 through the kernel
    # against the same forward through the plain version
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tf.init(cfg32, seed=0, device=device)
    toks = torch.as_tensor(next(TokenPipeline(V, 1, LM_GATE_TOKENS + 1, seed=1))["tokens"],
                           device=device)
    prompt = toks[:, :LM_GATE_TOKENS]
    reset_counts()                                  # the float32 forward starts here
    logits_k, _, pre = tf.forward(params, prompt, cfg32, return_cache=True)
    f32_launches = read_counts("qwen3 float32", ["flash_attention"])["flash_attention"]
    check(f32_launches == L, f"qwen3 float32: {f32_launches} flash_attention launches, "
                             f"want {L}")
    records["4x4096"]["f32"]["launches"] = f32_launches
    tf.flash_attention = lambda q, k, v, causal=True, window=None: (  # noqa: E731
        flash_attention_reference(q, k, v, causal, window))
    try:
        logits_p, _ = tf.forward(params, prompt, cfg32)
    finally:
        tf.flash_attention = flash_attention
    torch.cuda.synchronize()
    err = float((logits_k - logits_p).abs().max())
    ok = bool(torch.allclose(logits_k, logits_p, rtol=LM_RTOL, atol=LM_ATOL))
    log(f"[qwen3] whole-path gate, {cfg.name} float32 at full width, B=1 S={LM_GATE_TOKENS}: "
        f"logits through the kernel vs through the plain version max_abs_err={err:.3e} "
        f"(max |logit| {float(logits_p.abs().max()):.3f}) allclose(rtol={LM_RTOL}, "
        f"atol={LM_ATOL})={ok}")
    check(ok, "qwen3 float32 forward through the kernel disagrees with the plain forward")
    del logits_p
    # one decode step from the prefill's cache against the prefill of one more token
    cache = tf.init_cache(cfg32, 1, LM_GATE_TOKENS + 1, device=device)
    cache["k"][:, :, :LM_GATE_TOKENS] = pre["k"]
    cache["v"][:, :, :LM_GATE_TOKENS] = pre["v"]
    cache["pos"] = pre["pos"]
    del pre, logits_k
    step, _ = tf.decode_step(params, cache, toks[:, LM_GATE_TOKENS:], cfg32)
    full, _ = tf.forward(params, toks, cfg32)
    torch.cuda.synchronize()
    err_d = float((step[:, 0] - full[:, -1]).abs().max())
    ok = bool(torch.allclose(step[:, 0], full[:, -1], rtol=LM_RTOL, atol=LM_ATOL))
    log(f"[qwen3] decode step {LM_GATE_TOKENS} from the prefill cache vs the prefill of "
        f"{LM_GATE_TOKENS + 1} tokens (float32): max_abs_err={err_d:.3e} "
        f"allclose(rtol={LM_RTOL}, atol={LM_ATOL})={ok}")
    check(ok, "qwen3 decode from the prefill cache disagrees with the prefill")
    del params, cache, step, full
    torch.cuda.empty_cache()
    return records


def _all_finite(torch, t):
    """All of ``t`` finite, checked 1,024 positions at a time (the check of
    a whole 10 GB logits tensor at once takes 25 GB of temporaries)."""
    return all(bool(torch.isfinite(part).all()) for part in t.split(1024, dim=1))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device

    t_start = time.perf_counter()
    device = resolve_device("cuda")
    dev_line = device_line()
    log(f"[device] {dev_line}; torch {torch.__version__} cuda {torch.version.cuda}")
    tensor_core_instructions(build_kernels())
    errs = {"vm_step": kernel_sweep(torch), "embedding_bag": bag_sweep(torch),
            "segment_spmm": spmm_sweep(torch), "flash_attention": attention_sweep(torch)}
    plain_repeat(torch)
    paper_values(device)
    fig7(torch, device)
    online_2000(torch, device)
    sharded_2000(torch, device)
    serving_2000(torch, device)
    ladder_on_card(torch, device)
    serve_loop_setting(torch, device)
    chaos_on_card(torch, device)
    cluster_failover_setting(torch, device)
    full = full_size(torch, device)
    sharded = sharded_full(torch, device, full["graph"], full["part"])
    # the serving and cluster paths start from path 1's graph, which the
    # online path mutates
    g_serve, g_cluster = full["graph"].copy(), full["graph"].copy()
    online = online_full(torch, device, full.pop("graph"), full["part"].copy())
    served = serving_full(torch, device, g_serve, full["part"].copy())
    del g_serve
    clustered = cluster_full(torch, device, g_cluster, full.pop("part"))
    del g_cluster
    serve = dlrm_serving(torch, device)
    place = row_placement(torch, device)
    gnn = gcn_inference(torch, device)
    lm = qwen3_serving(torch, device)
    record = {"kernels": [
        # one kernel on two paths, each at its own shapes: the provgen-1M
        # invocation (23-node trie) and the row placement (677-node trie)
        {"name": "vm_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vm_step.cu",
         "replaces": "src/repro/kernels/vm_step/kernel.py:26",
         "launches": full["launches"],
         "max_abs_err": max(errs["vm_step"], full["err"]),
         "ms": full["ms"], "plain_ms": full["plain_ms"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
         "library_ms": None},
        {"name": "vm_step/placement", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vm_step.cu",
         "replaces": "src/repro/kernels/vm_step/kernel.py:26",
         "launches": place["launches"],
         "max_abs_err": max(errs["vm_step"], place["err"]),
         "ms": place["ms"], "plain_ms": place["plain_ms"],
         "bound_ms": place["bound_ms"], "bound_by": place["bound_by"],
         "library_ms": None},
        # the same kernel on the online path: a graph that mutates between
        # invocations, each version's CSR and row plan rebuilt
        {"name": "vm_step/online", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vm_step.cu",
         "replaces": "src/repro/kernels/vm_step/kernel.py:26",
         "launches": online["launches"],
         "max_abs_err": max(errs["vm_step"], online["err"]),
         "ms": online["ms"], "plain_ms": online["plain_ms"],
         "bound_ms": online["bound_ms"], "bound_by": online["bound_by"],
         "library_ms": None},
        # the same kernel on the serving path: each overlapped invocation's
        # field, launched from the loop's invocation thread (times at the
        # last launch's shapes)
        {"name": "vm_step/serve", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vm_step.cu",
         "replaces": "src/repro/kernels/vm_step/kernel.py:26",
         "launches": served["launches"],
         "max_abs_err": max(errs["vm_step"], served["err"]),
         "ms": served["ms"], "plain_ms": served["plain_ms"],
         "bound_ms": served["bound_ms"], "bound_by": served["bound_by"],
         "library_ms": None},
        # the same kernel on the replicated cluster's path: the primary's
        # invocations and the promoted follower's (times at the promoted
        # node's last launch's shapes)
        {"name": "vm_step/cluster", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vm_step.cu",
         "replaces": "src/repro/kernels/vm_step/kernel.py:26",
         "launches": clustered["launches"],
         "max_abs_err": max(errs["vm_step"], clustered["err"]),
         "ms": clustered["ms"], "plain_ms": clustered["plain_ms"],
         "bound_ms": clustered["bound_ms"], "bound_by": clustered["bound_by"],
         "library_ms": None},
        # the same kernel per shard of the sharded field: alpha holds the
        # shard's rows and its exchanged halo (times at shard 0's shapes)
        {"name": "vm_step/sharded", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vm_step.cu",
         "replaces": "src/repro/kernels/vm_step/kernel.py:26",
         "launches": sharded["launches"],
         "max_abs_err": sharded["err"],
         "ms": sharded["ms"], "plain_ms": sharded["plain_ms"],
         "bound_ms": sharded["bound_ms"], "bound_by": sharded["bound_by"],
         "library_ms": None},
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
         "replaces": "src/repro/kernels/embedding_bag/kernel.py:24",
         "launches": serve["launches"],
         "max_abs_err": max(errs["embedding_bag"], serve["err"]),
         "ms": serve["ms"], "plain_ms": serve["plain_ms"],
         "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
         "library_ms": serve["library_ms"]},
        {"name": "segment_spmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_spmm.cu",
         "replaces": "src/repro/kernels/segment_spmm/kernel.py:26",
         "launches": gnn["launches"],
         "max_abs_err": max(errs["segment_spmm"], gnn["err"]),
         "ms": gnn["ms"], "plain_ms": gnn["plain_ms"],
         "bound_ms": gnn["bound_ms"], "bound_by": gnn["bound_by"],
         "library_ms": gnn["library_ms"]},
    ] + [
        # the bf16 tensor-core kernel at the path's two prefill shapes:
        # 1 x 32,768 and 4 x 4,096
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": r["launches"],
         "max_abs_err": max(errs["flash_attention"]["bfloat16"], r["err"]),
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in (("flash_attention", lm["1x32768"]),
                        ("flash_attention/4k", lm["4x4096"]))
    ] + [
        # the float32 (3xTF32) kernel: its launches are the float32
        # full-width forward's, its times at the 4 x 4,096 shape in float32
        {"name": "flash_attention_f32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_f32.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": f32["launches"],
         "max_abs_err": max(errs["flash_attention"]["float32"], lm["1x32768"]["err32"],
                            lm["4x4096"]["err32"]),
         "ms": f32["ms"], "plain_ms": f32["plain_ms"],
         "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
         "library_ms": f32["library_ms"]}
        for f32 in (lm["4x4096"]["f32"],)
    ]}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(dev_line)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
