"""Reliability and fault tolerance (paper §4): port of the JAX package's
``ft`` package."""
from .failures import (ClusterManager, NaNMonitor, Node, NodeFailure, restore_into,
                       run_with_failure_handling, snapshot)

__all__ = ["ClusterManager", "NaNMonitor", "Node", "NodeFailure", "restore_into",
           "run_with_failure_handling", "snapshot"]
