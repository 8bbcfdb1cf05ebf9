"""Profiling-campaign subsystem (port of ``repro/campaign``; the
reference's docs/campaign.md describes it).

perf4sight's toolflow in one sentence: profile a configuration grid once
on the target device, fit models, then answer every future cost question
without touching the device.  This package is that loop for the LM
workloads, over ``(ArchConfig × ShapeSpec × mesh × DeviceSpec)`` cells:

* :mod:`repro_torch.campaign.plan`        — reproducible grid enumeration
  (``plan_grid``/``smoke_plan``, seeded stratified subsampling, plan hash)
* :mod:`repro_torch.campaign.runner`      — resumable, sharded execution
  into a durable JSONL ledger with per-cell quarantine; cells measured on
  the card (CUDA events, ``max_memory_allocated``, the traced ledger)
* :mod:`repro_torch.campaign.lm_features` — trace-free featurization
  (device constants are features: one forest serves a fleet)
* :mod:`repro_torch.campaign.fit`         — LM forests + NNLS cost-ledger
  constants, registered with the engine's ``ForestBackend``

CLI: ``python -m repro_torch.campaign {plan,run,fit,status} ...``
"""

from repro_torch.campaign.fit import (
    LMForest,
    check_device_fingerprints,
    fit_hlo_constants,
    fit_lm_forest,
    register_lm_forest,
    split_records,
)
from repro_torch.campaign.lm_features import (
    CLASS_FEATURE_NAMES,
    LM_FEATURE_NAMES,
    cell_features,
    class_histogram,
    ledger_class_features,
)
from repro_torch.campaign.plan import (
    SMOKE_SHAPES,
    CampaignCell,
    CampaignPlan,
    load_plan,
    mesh_dims,
    plan_grid,
    smoke_plan,
)
from repro_torch.campaign.runner import (
    CampaignLedger,
    CampaignRunner,
    CellTimeout,
    measure_cell,
)

__all__ = [
    "CampaignCell",
    "CampaignLedger",
    "CampaignPlan",
    "CampaignRunner",
    "CellTimeout",
    "CLASS_FEATURE_NAMES",
    "LMForest",
    "LM_FEATURE_NAMES",
    "SMOKE_SHAPES",
    "cell_features",
    "check_device_fingerprints",
    "class_histogram",
    "ledger_class_features",
    "fit_hlo_constants",
    "fit_lm_forest",
    "load_plan",
    "measure_cell",
    "mesh_dims",
    "plan_grid",
    "register_lm_forest",
    "smoke_plan",
    "split_records",
]
