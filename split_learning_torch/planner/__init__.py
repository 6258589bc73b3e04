"""Resource-aware planning: who runs which stage, where to cut, who is
too slow.

The port's copy of the JAX package's ``planner`` package: label-count
synthesis, KMeans / affinity-propagation clustering of stage-1 clients by
label distribution, GMM straggler rejection, the throughput-balance cut
search and the measured-throughput cost model.  All functions are pure
numpy, equal to the JAX package's on the same inputs; they are copied,
not imported, because importing any module of the JAX package loads JAX.
"""

from split_learning_torch.planner.partition import partition, partition_multiway
from split_learning_torch.planner.selection import auto_threshold, select_devices
from split_learning_torch.planner.cluster import kmeans_cluster, clustering_algorithm
from split_learning_torch.planner.distribution import synthesize_label_counts
from split_learning_torch.planner.throughput import (
    implied_bandwidth, predict_round_wall, replan_cuts, scaled_exe_time,
)

__all__ = [
    "partition",
    "partition_multiway",
    "auto_threshold",
    "select_devices",
    "kmeans_cluster",
    "clustering_algorithm",
    "synthesize_label_counts",
    "scaled_exe_time",
    "implied_bandwidth",
    "predict_round_wall",
    "replan_cuts",
]
