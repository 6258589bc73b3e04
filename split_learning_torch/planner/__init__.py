"""Planning helpers needed by manual-topology round planning: per-client
label-count synthesis and the throughput-balance cut search.  KMeans/GMM
auto mode (``cluster``, ``selection``) waits for a later slice."""

from split_learning_torch.planner.distribution import synthesize_label_counts
from split_learning_torch.planner.partition import partition, partition_multiway

__all__ = ["synthesize_label_counts", "partition", "partition_multiway"]
