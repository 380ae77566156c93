"""The port's fault-tolerance runtime (heartbeats, stragglers, restart loop,
the replica router's fault plans)."""
from .failover import (
    ElasticPlan,
    FailureInjector,
    FaultPlan,
    HeartbeatMonitor,
    SimulatedFailure,
    detect_stragglers,
    plan_elastic_remesh,
    run_with_restarts,
)

__all__ = [
    "ElasticPlan",
    "FailureInjector",
    "FaultPlan",
    "HeartbeatMonitor",
    "SimulatedFailure",
    "detect_stragglers",
    "plan_elastic_remesh",
    "run_with_restarts",
]
