"""The card's energy counter, read through NVML with ctypes.

``nvmlDeviceGetTotalEnergyConsumption`` gives the millijoules the card
has used since its kernel module was loaded; the benchmark reads it at the two
edges of the measured window.  The card is found by the UUID that PyTorch
reports for it, so the reading is of the card the run uses.  There is no
fallback: a card whose counter cannot be read fails the run.
"""

from __future__ import annotations

import ctypes


class NvmlError(RuntimeError):
    pass


class EnergyCounter:
    """Millijoules used by one card since its kernel module was loaded."""

    def __init__(self, uuid: str) -> None:
        lib = self._lib = ctypes.CDLL("libnvidia-ml.so.1")
        lib.nvmlInit_v2.argtypes = []
        lib.nvmlShutdown.argtypes = []
        lib.nvmlErrorString.argtypes = [ctypes.c_int]
        lib.nvmlErrorString.restype = ctypes.c_char_p
        lib.nvmlDeviceGetHandleByUUID.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        for fn in (lib.nvmlInit_v2, lib.nvmlShutdown,
                   lib.nvmlDeviceGetHandleByUUID,
                   lib.nvmlDeviceGetTotalEnergyConsumption):
            fn.restype = ctypes.c_int
        self._check(self._lib.nvmlInit_v2(), "nvmlInit_v2")
        self._handle = ctypes.c_void_p()
        name = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
        self._check(self._lib.nvmlDeviceGetHandleByUUID(
            name.encode(), ctypes.byref(self._handle)),
            f"nvmlDeviceGetHandleByUUID({name})")

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise NvmlError(f"{what}: {self._lib.nvmlErrorString(rc).decode()}"
                            f" (code {rc})")

    def millijoules(self) -> int:
        mj = ctypes.c_ulonglong()
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value

    def close(self) -> None:
        self._lib.nvmlShutdown()


def card_uuid(device) -> str:
    import torch

    return str(torch.cuda.get_device_properties(device).uuid)
