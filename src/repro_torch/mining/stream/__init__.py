"""repro_torch.mining.stream — streaming ingestion over segmented N-list databases.

The paper's map/reduce split kept *live*: per-batch PPC-tree/N-list
segments are independent map outputs (``StreamingMiner.append`` preps only
the new batch), global F1/F2 are summed per-segment counts (the reduce),
and queries run the k>2 wave loop per segment with per-candidate supports
summed across segments — exact by support additivity over disjoint
partitions. An LSM-style compactor folds small segments back together off
the query path. Front doors: ``MiningEngine.append`` / ``submit_stream``
and the ``MiningService`` equivalents.
"""
from repro_torch.mining.stream.segmented import Segment, SegmentedDB
from repro_torch.mining.stream.spec import StreamSpec
from repro_torch.mining.stream.stream import StreamingMiner

__all__ = ["Segment", "SegmentedDB", "StreamSpec", "StreamingMiner"]
