"""Distributed multi-host mining: the paper's MapReduce roles as live
processes.

The source paper runs HPrepost on Hadoop: a **JobTracker** schedules map
tasks (per-partition PPC-tree / N-list construction) onto
**TaskTrackers**, each map output stays node-local, and the reduce sums
per-candidate supports across nodes — exact because the transaction
partitions are disjoint and support is additive over them. This package
makes that split literal over the streaming layer
(``repro_torch.mining.stream``), with every TaskTracker a spawned process
bound to a torch device of its own:

  =====================  ====================================================
  Paper / Hadoop role     Here
  =====================  ====================================================
  JobTracker              ``coordinator.DistributedMiner`` — owns the global
                          stream item order, summed F1 counts and F2 matrix,
                          plans every candidate wave once, broadcasts it,
                          sums the per-worker supports before thresholding,
                          and replays queries after a failover.
  TaskTracker             ``worker.Worker`` (own process, own torch runtime
                          and CUDA context, on ``cuda:{wid % cards}`` or
                          the engine's device) — builds and owns a
                          disjoint set of prepared segments (one B4 launch
                          each), answers wave RPCs with its partial
                          support sums (B1 per segment; its local reduce
                          contribution).
  Task scheduling         ``placement`` — byte-balanced greedy bin-packing
                          of segments onto workers, best-fit-decreasing
                          re-planning when the topology changes.
  Heartbeats /            coordinator heartbeat thread + RPC failure
  speculative re-exec     detection; a dead worker's segments re-place onto
                          survivors and an in-flight query replays.
  HDFS                    the shared content-addressed ``SnapshotStore``
                          directory: segments built by any worker
                          warm-restore on any other with zero prep
                          recompute (``seg_prepares == 0`` on reassignment).
  Shuffle / wire          ``protocol`` + ``transport`` — length-prefixed
                          pickle frames (NumPy and scalars, never tensors)
                          over loopback TCP, FIFO per worker, waves
                          pipelined one ahead.
  =====================  ====================================================

Exactness is inherited, not re-proven: the coordinator drives the same
``HPrepostMiner.mine_prepared_segments`` planning loop as the
single-process streaming path, with only the executor swapped
(``LocalSegmentExecutor`` -> ``RemoteSegmentExecutor``), so distributed
answers are bit-identical to ``StreamingMiner`` on the same rows.
"""
from repro_torch.mining.distributed.coordinator import (
    DistributedMiner,
    NoLiveWorkers,
    RemoteSegmentExecutor,
    WorkerDied,
)
from repro_torch.mining.distributed.placement import choose_worker, replan

__all__ = [
    "DistributedMiner",
    "NoLiveWorkers",
    "RemoteSegmentExecutor",
    "WorkerDied",
    "choose_worker",
    "replan",
]
