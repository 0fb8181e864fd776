from .diskcsr import DiskCSR, diskcsr_fingerprint, is_diskcsr, open_diskcsr, save_diskcsr
from .formats import (
    CSR,
    DeviceBSR,
    DeviceCOO,
    DeviceELL,
    DeviceHybrid,
    conversion_count,
    csr_from_coo,
    from_reference,
    to_device_bsr,
    to_device_coo,
    to_device_ell,
    to_device_hybrid,
)
from .generate import SUITE, generate, suite_matrix

__all__ = [
    "CSR",
    "DiskCSR",
    "diskcsr_fingerprint",
    "is_diskcsr",
    "open_diskcsr",
    "save_diskcsr",
    "DeviceBSR",
    "DeviceCOO",
    "DeviceELL",
    "DeviceHybrid",
    "conversion_count",
    "csr_from_coo",
    "from_reference",
    "to_device_bsr",
    "to_device_coo",
    "to_device_ell",
    "to_device_hybrid",
    "SUITE",
    "generate",
    "suite_matrix",
]
