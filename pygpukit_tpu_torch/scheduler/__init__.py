from .core import (
    AdmissionResult, AdmitDecision, Scheduler, SchedulerStats, Task,
    TaskPolicy, TaskState,
)
from .execution import (
    ContextState, ContextStats, ControllerStats, ExecutionContext,
    MultiModelController, create_context, get_controller, initialize,
)
from .partition import PartitionLimits, PartitionManager, PartitionUsage

__all__ = [
    "AdmissionResult", "AdmitDecision", "Scheduler", "SchedulerStats",
    "Task", "TaskPolicy", "TaskState",
    "ContextState", "ContextStats", "ControllerStats", "ExecutionContext",
    "MultiModelController", "create_context", "get_controller", "initialize",
    "PartitionLimits", "PartitionManager", "PartitionUsage",
]
