"""Pond's two prediction models (§4.4, Figures 12-14).

LatencySensitivityModel  — RandomForest over core-PMU/TMA counters;
  classify "latency insensitive" = running fully on pool memory keeps the
  slowdown within the PDM.  Parameterized by a probability threshold;
  sweeping it yields the Figure-17 (LI%, FP%) tradeoff curve.  Includes the
  paper's two heuristic baselines ("Memory bound" / "DRAM bound"
  single-counter thresholds).

UntouchedMemoryModel — quantile GBM over VM metadata (customer history
  percentiles are the strongest feature, §4.4); sweeping the target
  quantile yields the Figure-18 (UM%, OP%) curve, against the static
  fixed-fraction strawman.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.predictors.forest import RandomForest, fit_forest
from repro_torch.core.predictors.gbm import QuantileGBM, fit_gbm
from repro_torch.core.qos import exceeds_pdm


@dataclasses.dataclass
class LICurvePoint:
    threshold: float
    li_frac: float         # fraction of workloads labeled insensitive
    fp_frac: float         # sensitive-but-labeled-insensitive / total


class LatencySensitivityModel:
    def __init__(self, pdm: float = 0.05):
        self.pdm = pdm
        self.forest: RandomForest | None = None

    def fit(self, pmu_features: np.ndarray, slowdowns: np.ndarray,
            seed: int = 0):
        """slowdowns: relative (0.03 = 3%).  Label 1 = sensitive."""
        y = exceeds_pdm(slowdowns, self.pdm).astype(np.float32)
        self.forest = fit_forest(pmu_features, y, seed=seed)
        return self

    def p_sensitive(self, pmu_features: np.ndarray) -> np.ndarray:
        return self.forest.predict_proba(pmu_features)

    def p_sensitive_batch(self, pmu_features: np.ndarray) -> np.ndarray:
        """Whole-trace probabilities whose row ``i`` bit-matches the
        control plane's per-VM ``p_sensitive(pmu[None])[0]`` call (see
        ``RandomForest.predict_proba_batch``); the compiled policy
        engine scores every VM in one call through this path."""
        return self.forest.predict_proba_batch(pmu_features)

    def insensitive(self, pmu_features: np.ndarray,
                    threshold: float) -> np.ndarray:
        return self.p_sensitive(pmu_features) < threshold

    def curve(self, pmu_features, slowdowns, thresholds=None):
        """Figure 17: (LI, FP) as the threshold sweeps."""
        sens = exceeds_pdm(slowdowns, self.pdm)
        p = self.p_sensitive(pmu_features)
        pts = []
        ths = thresholds if thresholds is not None \
            else np.unique(np.round(np.linspace(0.0, 1.0, 101), 3))
        for t in ths:
            li = p < t
            pts.append(LICurvePoint(float(t), float(li.mean()),
                                    float((li & sens).mean())))
        return pts

    def threshold_for_fp(self, pmu_features, slowdowns,
                         fp_target: float) -> LICurvePoint:
        """Largest-LI point with FP <= target (the paper's FP knob)."""
        best = LICurvePoint(0.0, 0.0, 0.0)
        for pt in self.curve(pmu_features, slowdowns):
            if pt.fp_frac <= fp_target and pt.li_frac >= best.li_frac:
                best = pt
        return best


def heuristic_curve(counter: np.ndarray, slowdowns: np.ndarray,
                    pdm: float = 0.05):
    """Single-counter threshold baselines (Fig 17: Memory/DRAM bound)."""
    sens = exceeds_pdm(slowdowns, pdm)
    pts = []
    for t in np.quantile(counter, np.linspace(0, 1, 101)):
        li = counter < t
        pts.append(LICurvePoint(float(t), float(li.mean()),
                                float((li & sens).mean())))
    return pts


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class UMCurvePoint:
    tau: float
    um_frac: float          # mean predicted untouched fraction (of memory)
    op_frac: float          # fraction of VMs with actual < predicted


class UntouchedMemoryModel:
    """Quantile regression of the minimum untouched fraction over a VM's
    lifetime, from metadata features."""

    def __init__(self, tau: float = 0.2):
        self.tau = tau
        self.gbm: QuantileGBM | None = None

    def fit(self, meta_features: np.ndarray, untouched_frac: np.ndarray,
            seed: int = 0):
        self.gbm = fit_gbm(meta_features, untouched_frac, tau=self.tau,
                           seed=seed)
        return self

    def predict(self, meta_features: np.ndarray) -> np.ndarray:
        """GB-alignment: predictions are rounded DOWN to the slice grain by
        the control plane, never up (§4.4)."""
        return np.clip(self.gbm.predict(meta_features), 0.0, 1.0)

    @staticmethod
    def curve(meta_features, untouched, taus=None, seed: int = 0):
        """Figure 18: (UM, OP) sweeping the target quantile."""
        pts = []
        for tau in (taus if taus is not None
                    else (0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5)):
            m = UntouchedMemoryModel(tau).fit(meta_features, untouched,
                                              seed=seed)
            pred = m.predict(meta_features)
            pts.append(UMCurvePoint(tau, float(pred.mean()),
                                    float((untouched < pred).mean())))
        return pts

    @staticmethod
    def static_curve(untouched, fracs=None):
        """Strawman: same fixed untouched fraction for every VM."""
        pts = []
        for f in (fracs if fracs is not None
                  else np.linspace(0.0, 0.6, 25)):
            pts.append(UMCurvePoint(float(f), float(f),
                                    float((untouched < f).mean())))
        return pts
