"""Unified cost-prediction engine of the port (port of ``repro/engine/``).

One batched, cacheable API — ``CostBackend.estimate(queries) ->
CostEstimate[]`` — over the three cost paths: the fitted perf4sight
forest, the analytical closed forms, and the ground-truth profiler on the
card.  Hardware constants live in the device registry
(:mod:`repro_torch.engine.devices`) and are fitted per device by
:mod:`repro_torch.engine.calibrate`.  The CNN paths are ported; LM arch
queries wait for ROADMAP queue 1 items 5b (the cost ledger) and 6
(``LMForest``).
"""

from repro_torch.engine.backends import (
    AnalyticalBackend,
    EnsembleBackend,
    ForestBackend,
    ProfilerBackend,
)
from repro_torch.engine.cache import EstimateCache
from repro_torch.engine.calibrate import (
    CalibrationWorkload,
    calibrate,
    default_workloads,
    evaluate_accuracy,
    measure_ground_truth,
    timed_tuning_rows,
)
from repro_torch.engine.devices import (
    DEVICE_REGISTRY,
    POWER_MODE_FIELDS,
    DeviceSpec,
    from_torch_device,
    get_device,
    list_devices,
    load_device_spec,
    register_device,
    resolve_device,
    save_device_spec,
)
from repro_torch.engine.engine import CostEngine, HealthState
from repro_torch.engine.types import (
    STAGE_INFER,
    STAGE_TRAIN,
    BackendUnavailable,
    CostBackend,
    CostEstimate,
    CostQuery,
)

__all__ = [
    "AnalyticalBackend",
    "BackendUnavailable",
    "CalibrationWorkload",
    "CostBackend",
    "CostEngine",
    "CostEstimate",
    "CostQuery",
    "DEVICE_REGISTRY",
    "DeviceSpec",
    "EnsembleBackend",
    "EstimateCache",
    "ForestBackend",
    "HealthState",
    "POWER_MODE_FIELDS",
    "ProfilerBackend",
    "STAGE_INFER",
    "STAGE_TRAIN",
    "calibrate",
    "default_workloads",
    "evaluate_accuracy",
    "from_torch_device",
    "get_device",
    "list_devices",
    "load_device_spec",
    "measure_ground_truth",
    "register_device",
    "resolve_device",
    "save_device_spec",
    "timed_tuning_rows",
]
