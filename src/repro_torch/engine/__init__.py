"""Cost-engine package of the port (port of ``repro/engine/``).

This slice ports the device registry only (:mod:`.devices`), which the
kernel autotuner salts its cache keys with; the engine, backends,
decomposition and calibration come with ROADMAP queue 1, item 5a.
"""

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

__all__ = [
    "DeviceSpec",
    "DEVICE_REGISTRY",
    "POWER_MODE_FIELDS",
    "get_device",
    "register_device",
    "list_devices",
    "resolve_device",
    "from_torch_device",
    "save_device_spec",
    "load_device_spec",
]
