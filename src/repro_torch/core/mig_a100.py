"""A100-40GB MIG partition FSM (paper §4.1-4.2, Fig. 3), the port's copy.

The A100 exposes 7 GPU compute slices (GPCs) and 8 memory slices of 5GB.
MIG instances ("profiles") occupy a contiguous span of GPC slices and may only
*start* at hardware-defined positions (NVIDIA MIG user guide [14]):

    profile    GPCs  mem slices  allowed starts
    1g.5gb      1        1        0,1,2,3,4,5,6
    2g.10gb     2        2        0,2,4
    3g.20gb     3        4        0,4
    4g.20gb     4        4        0
    7g.40gb     7        8        0

The port runs on the H100 (:mod:`repro_torch.core.mig_h100`); it carries the
A100's table beside it because it is the card of the paper's own tables, and
the partition manager and planner are held to the reference on both.  The
span-FSM mechanics live in :mod:`repro_torch.core.mig_span`.
"""

from __future__ import annotations

import functools

from repro_torch.core.mig_span import MigSpanBackend

N_GPC = 7
N_MEM_SLICES = 8
MEM_SLICE_GB = 5.0

#: name -> (gpc span, memory slices, allowed start GPCs)
_PROFILE_TABLE: dict[str, tuple[int, int, tuple[int, ...]]] = {
    "1g.5gb": (1, 1, (0, 1, 2, 3, 4, 5, 6)),
    "2g.10gb": (2, 2, (0, 2, 4)),
    "3g.20gb": (3, 4, (0, 4)),
    "4g.20gb": (4, 4, (0,)),
    "7g.40gb": (7, 8, (0,)),
}


class MigA100Backend(MigSpanBackend):
    """State = frozenset of (start_gpc, profile_name) instances."""

    def __init__(self) -> None:
        super().__init__(device_name="a100-40gb", table=_PROFILE_TABLE,
                         n_gpc=N_GPC, n_mem_slices=N_MEM_SLICES,
                         mem_slice_gb=MEM_SLICE_GB)


@functools.lru_cache(maxsize=1)
def make_backend() -> MigA100Backend:
    return MigA100Backend()
