"""H100-80GB MIG partition FSM — the Hopper member of the fleet.

Same 7-GPC / 8-memory-slice structure as the A100 (the paper's abstract
targets the whole Ampere/Hopper line), but each memory slice is 10GB and
Hopper adds the double-memory single-GPC profile (NVIDIA MIG user guide,
H100 80GB table):

    profile    GPCs  mem slices  allowed starts
    1g.10gb     1        1        0,1,2,3,4,5,6
    1g.20gb     1        2        0,2,4,6
    2g.20gb     2        2        0,2,4
    3g.40gb     3        4        0,4
    4g.40gb     4        4        0
    7g.80gb     7        8        0

The 1g.20gb profile makes the H100 FSM strictly richer than the A100's:
memory can run out while GPCs remain free, so Algorithm 3's
argmax-reachability placement matters more, not less.
"""

from __future__ import annotations

import functools

from repro_torch.core.mig_span import MigSpanBackend

N_GPC = 7
N_MEM_SLICES = 8
MEM_SLICE_GB = 10.0

#: name -> (gpc span, memory slices, allowed start GPCs)
_PROFILE_TABLE: dict[str, tuple[int, int, tuple[int, ...]]] = {
    "1g.10gb": (1, 1, (0, 1, 2, 3, 4, 5, 6)),
    "1g.20gb": (1, 2, (0, 2, 4, 6)),
    "2g.20gb": (2, 2, (0, 2, 4)),
    "3g.40gb": (3, 4, (0, 4)),
    "4g.40gb": (4, 4, (0,)),
    "7g.80gb": (7, 8, (0,)),
}


class MigH100Backend(MigSpanBackend):
    """State = frozenset of (start_gpc, profile_name) instances."""

    def __init__(self) -> None:
        super().__init__(device_name="h100-80gb", table=_PROFILE_TABLE,
                         n_gpc=N_GPC, n_mem_slices=N_MEM_SLICES,
                         mem_slice_gb=MEM_SLICE_GB)


@functools.lru_cache(maxsize=1)
def make_backend() -> MigH100Backend:
    return MigH100Backend()
