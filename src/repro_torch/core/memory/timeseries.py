"""Time-series memory prediction (paper §3.2.3, Algorithm 1).

Per iteration of a looped ML workload we observe, via the instrumented
allocator (here :mod:`repro_torch.core.memory.accountant`):

* ``req_mem``     — cumulative memory *requested* from the allocator, and
* ``reuse_ratio`` — physical_in_use / requested (lower = more reuse).

Two linear models are fit:

    m_hat(t)        = a * t + b                      (requested memory)
    inv_reuse(t)    = c * t + d,  reuse = 1/inv_reuse (reuse efficiency)

Residuals of the memory fit are assumed normal; the peak prediction at the
final iteration T adds a z*sigma 99%-CI margin:

    mem_pred = (a*T + b + z*sigma) * reuse(T) + workspace + context

Convergence: the prediction is reported once it is stable within
``converge_tol`` relative change for ``converge_k`` consecutive iterations.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

#: z-score for a one-sided 99% confidence bound (paper: "99% CI").
Z_99 = 2.326


@dataclasses.dataclass
class Prediction:
    """Output of one predictor step."""

    iteration: int
    peak_mem_bytes: float
    converged: bool
    trend_slope: float         # a — bytes per iteration
    sigma: float               # residual std of the memory fit
    reuse_at_horizon: float    # predicted reuse ratio at max_iter
    #: std of the *peak estimate itself*: sigma scaled into peak units when
    #: the fitted extrapolation produced the peak, 0.0 when the observed
    #: floor (max requested x min reuse) won the max — the floor is a hard
    #: lower bound, not a normal fit, so no margin was added to strip back
    #: out.  None (old callers) falls back to sigma * reuse_at_horizon.
    sigma_peak_bytes: float | None = None


def _linfit(ys: np.ndarray) -> tuple[float, float, float]:
    """Least-squares a, b and residual sigma for y_t = a*t + b."""
    t = np.arange(len(ys), dtype=np.float64)
    if len(ys) == 1:
        return 0.0, float(ys[0]), 0.0
    a, b = np.polyfit(t, ys, deg=1)
    resid = ys - (a * t + b)
    # ddof=2: two fitted parameters
    sigma = float(np.sqrt(np.sum(resid ** 2) / max(1, len(ys) - 2)))
    return float(a), float(b), sigma


class PeakMemoryPredictor:
    """Algorithm 1 — PEAKMEMORYPREDICTION, incremental form.

    Call :meth:`observe` once per workload iteration; it returns the current
    :class:`Prediction`.  ``converged=True`` corresponds to Alg. 1's
    ``CONVERGE(mem_pred)`` return.
    """

    def __init__(self,
                 max_iter: int,
                 workspace_bytes: float = 0.0,
                 context_bytes: float = 0.0,
                 min_observations: int = 3,
                 converge_tol: float = 0.05,
                 converge_k: int = 3,
                 z: float = Z_99) -> None:
        self.max_iter = max_iter
        self.workspace_bytes = workspace_bytes
        self.context_bytes = context_bytes
        self.min_observations = min_observations
        self.converge_tol = converge_tol
        self.converge_k = converge_k
        self.z = z
        self.req_mem_list: list[float] = []
        self.reuse_ratio_list: list[float] = []
        self._recent_preds: list[float] = []

    # -- Alg. 1 main loop body -------------------------------------------------

    def observe(self, req_mem: float, reuse_ratio: float) -> Prediction:
        self.req_mem_list.append(float(req_mem))
        self.reuse_ratio_list.append(float(reuse_ratio))
        it = len(self.req_mem_list) - 1

        if len(self.req_mem_list) < self.min_observations:
            naive = (max(self.req_mem_list) * min(self.reuse_ratio_list)
                     + self.workspace_bytes + self.context_bytes)
            return Prediction(iteration=it, peak_mem_bytes=naive,
                              converged=False, trend_slope=0.0, sigma=0.0,
                              reuse_at_horizon=reuse_ratio)

        # FIT_MEM_MODEL
        a, b, sigma = _linfit(np.asarray(self.req_mem_list))
        # FIT_RATIO on the inverse reuse ratio (paper: reciprocal transform
        # makes the decreasing ratio linear)
        inv = 1.0 / np.maximum(np.asarray(self.reuse_ratio_list), 1e-9)
        c, d, _ = _linfit(inv)

        # PREDICT_PEAK_MEM at the horizon — the final iteration index
        T = self.max_iter - 1
        req_at_T = a * T + b + self.z * sigma
        inv_at_T = max(c * T + d, 1.0)  # reuse ratio cannot exceed 1 requested
        reuse_at_T = 1.0 / inv_at_T
        # requested memory is cumulative; physical demand = requested * reuse
        fitted = req_at_T * reuse_at_T
        floor = max(self.req_mem_list) * min(self.reuse_ratio_list)
        peak = max(fitted, floor)
        sigma_peak = sigma * reuse_at_T if fitted >= floor else 0.0
        peak += self.workspace_bytes + self.context_bytes

        # CONVERGE check
        self._recent_preds.append(peak)
        window = self._recent_preds[-self.converge_k:]
        converged = (len(window) == self.converge_k and
                     (max(window) - min(window))
                     <= self.converge_tol * max(window[-1], 1e-9))

        return Prediction(iteration=it, peak_mem_bytes=peak,
                          converged=converged, trend_slope=a, sigma=sigma,
                          reuse_at_horizon=reuse_at_T,
                          sigma_peak_bytes=sigma_peak)

    # -- scheduler-facing helpers ----------------------------------------------

    def will_oom(self, partition_bytes: float, pred: Prediction,
                 require_converged: bool = True) -> bool:
        """Early-restart trigger (paper §2.3): predicted peak exceeds the
        partition the job is running on."""
        if require_converged and not pred.converged:
            return False
        return pred.peak_mem_bytes > partition_bytes

    def oom_risk(self, partition_bytes: float, pred: Prediction) -> float:
        """P(true peak > partition) under the fit's residual model — the
        *graded* form of :meth:`will_oom` for cost models that trade a
        predicted miss against a reconfiguration instead of thresholding.

        ``sigma_peak_bytes`` records exactly the margin ``observe`` built
        into ``peak_mem_bytes``: stripping ``z * sigma_peak`` recovers the
        fit's mean, and the normal residual assumption gives the tail mass
        above the partition.  When the observed floor produced the peak
        (``sigma_peak_bytes == 0`` — no margin was added), or the fit has
        no residual, this degenerates to the exact threshold.
        """
        sigma_peak = pred.sigma_peak_bytes
        if sigma_peak is None:          # pre-field callers: fitted-branch
            sigma_peak = pred.sigma * pred.reuse_at_horizon
        mean_peak = pred.peak_mem_bytes - self.z * sigma_peak
        if sigma_peak <= 0.0:
            return 1.0 if mean_peak > partition_bytes else 0.0
        z = (partition_bytes - mean_peak) / sigma_peak
        return 0.5 * math.erfc(z / math.sqrt(2.0))


def run_to_convergence(trajectory_req: list[float],
                       trajectory_reuse: list[float],
                       max_iter: int,
                       partition_bytes: float | None = None,
                       **kw) -> tuple[Prediction, int]:
    """Convenience: feed a recorded trajectory until convergence (or, if
    ``partition_bytes`` given, until the converged prediction exceeds it).
    Returns (prediction, iterations consumed)."""
    pred_iter = PeakMemoryPredictor(max_iter=max_iter, **kw)
    last = None
    for i, (m, r) in enumerate(zip(trajectory_req, trajectory_reuse)):
        last = pred_iter.observe(m, r)
        if last.converged:
            if partition_bytes is None:
                return last, i + 1
            if pred_iter.will_oom(partition_bytes, last):
                return last, i + 1
    assert last is not None
    return last, len(trajectory_req)
