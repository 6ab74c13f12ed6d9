"""Serving runtime: deterministic fault injection (``chaos``), failure
detection and retry policy (``failure``), and session-table checkpoints
(``checkpoint``, the session half of the reference's module)."""
from .chaos import (  # noqa: F401
    ChaosInjector,
    ChaosSchedule,
    DeviceFailure,
    DispatchTimeout,
    FaultEvent,
    InjectedFault,
    TransientCompileError,
)
from .failure import (  # noqa: F401
    ElasticPlanner,
    HeartbeatMonitor,
    MeshPlan,
    QuarantineRecord,
    RetryPolicy,
    StragglerMonitor,
)
