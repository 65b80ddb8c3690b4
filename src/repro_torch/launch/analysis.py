"""Roofline terms of a traced step, with the H100's constants.

Hardware constants: NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU
datasheet (dense, no sparsity):

    PEAK_FLOPS     989e12 FLOP/s  bf16 tensor-core peak
    PEAK_FLOPS_F32  67e12 FLOP/s  f32 (CUDA cores)
    HBM_BW        3.35e12 B/s     HBM3
    LINK_BW        450e9  B/s     NVLink 4, each direction, per GPU

The link figure is NVLink's, so it holds inside one node (eight cards
joined by NVSwitch); a mesh that spans nodes crosses the slower network
between them, which this term does not model.  The port's copy of the
reference's ``repro/launch/analysis.py`` but for these constants (the
reference's are another accelerator's) and ``LINK_BW`` in place of
``ICI_BW``; the reference's HLO-text ``collective_bytes`` has no
counterpart, since the port's collectives are counted at dispatch
(:mod:`repro_torch.launch.op_count`).
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12
LINK_BW = 450e9


def analytic_hbm_bytes(cfg, preset, n_dev: int, params_bytes: int,
                       opt_bytes: int = 0, cache_bytes: int = 0,
                       act_bytes: int = 0) -> float:
    """Per-device HBM traffic per step — the roofline memory term.

    train:   read params + write params + read/write both moments + read
             grads-equivalent (+ activations saved: write fwd, read bwd)
    prefill: read params once + activation write/read working set
    decode:  read ALL params + read the used KV cache + write one token's
             KV — the classic memory-bound decode roofline.
    """
    p = params_bytes / n_dev
    if preset.kind == "train":
        opt = opt_bytes / n_dev
        act = act_bytes / n_dev
        return 3 * p + 2 * opt + 2 * act
    if preset.kind == "prefill":
        act = act_bytes / n_dev
        return p + 2 * act
    # decode
    return p + cache_bytes / n_dev


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    hlo_flops: float            # per device (counted at dispatch)
    hlo_bytes: float            # per device HBM traffic
    coll_bytes: float           # per device link traffic
    model_flops: float          # 6*N*D (analytic, per device share)
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.hlo_flops / PEAK_FLOPS
        self.memory_s = self.hlo_bytes / HBM_BW
        self.collective_s = self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    def row(self) -> str:
        return (f"{self.arch:<26} {self.shape:<12} {self.mesh:<9} "
                f"{self.compute_s * 1e3:10.2f} {self.memory_s * 1e3:10.2f} "
                f"{self.collective_s * 1e3:12.2f} {self.dominant:<10} "
                f"{self.useful_flops_ratio:8.3f}")


ROOFLINE_HEADER = (f"{'arch':<26} {'shape':<12} {'mesh':<9} "
                   f"{'compute_ms':>10} {'memory_ms':>10} "
                   f"{'collectv_ms':>12} {'dominant':<10} {'useful':>8}")
