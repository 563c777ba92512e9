"""Driving-context switch forecasting (predictive replanning, stage 1).

The reactive replanner pays the stop-migrate-restart swap exactly *at*
the mode boundary — the moment the new mode's load arrives, i.e. the
worst possible time.  But context switches in an ADS are predictable
seconds ahead: the route planner knows the highway on-ramp is coming,
fleet telemetry knows how long a parking manoeuvre dwells, and the
scenario's own Markov structure says which context follows which.  A
:class:`ModeForecaster` turns that structure into
:class:`ModeForecast`s — *"mode X ends near time t, mode Y follows,
with confidence c"* — which the predictive replanner converts into
pre-staged schedule swaps inside the bounded-reallocation window
*before* the seam.

Two information sources compose:

* **Markov structure** — a mode-transition matrix plus per-mode dwell
  priors (e.g. the scenario generator's own matrix, or empirical
  bigram counts from a script).  The forecast target is the most
  likely non-self successor; the switch time is the dwell estimate;
  confidence is the successor probability discounted by the dwell
  spread.
* **Route timeline** (optional) — any object with
  ``next_switch(now) -> (switch_s, next_mode) | None`` (in practice a
  :class:`~h100bench.ref_soa.scenarios.ScenarioScript`).  When present it pins the
  switch *time and target* exactly — the "map data" case — and
  confidence is floored at ``route_confidence``: a planned route's
  next segment is near-certain regardless of how surprising the fleet
  matrix finds it (the Markov row can only *raise* the figure, for
  transitions even more canonical than the route floor).  Route-pinned
  forecasts therefore land in the pre-swap band by default; the blend
  band is mainly exercised by pure Markov forecasting, revert backoff,
  or the hedge-only ablation (``replan_mode="blend"``).

Observed dwell times feed back through :meth:`observe_switch`: each
completed segment updates the per-mode dwell mean and spread (and the
transition counts), so a forecaster running over a long drive converges
to the drive's own rhythm rather than the prior's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

__all__ = ["ModeForecast", "ModeForecaster"]


@dataclasses.dataclass(frozen=True)
class ModeForecast:
    """One predicted context switch."""

    issued_at_s: float      # when the forecast was emitted
    mode: str               # the mode it predicts the end of
    target_mode: str        # most likely successor
    switch_at_s: float      # predicted absolute switch time
    confidence: float       # in [0, 1]

    @property
    def horizon_s(self) -> float:
        """How far ahead of the predicted seam this forecast looks."""
        return self.switch_at_s - self.issued_at_s


#: dwell spread assumed for pure priors: the bundled Markov generator
#: draws dwell ~ mean * U(0.5, 1.5), whose coefficient of variation is
#: 1/(2*sqrt(3)) ~= 0.289
_PRIOR_DWELL_CV = 1.0 / (2.0 * math.sqrt(3.0))


class ModeForecaster:
    """Markov + dwell-statistics context-switch forecaster.

    ``transitions`` maps mode -> {successor: weight} (rows need not be
    normalised; self-transitions are ignored for targeting — a
    self-transition extends the dwell, it is not a seam).
    ``mean_dwell_s`` provides per-mode dwell priors; both update online
    via :meth:`observe_switch`.  ``timeline`` optionally supplies exact
    switch times/targets (route knowledge); ``route_confidence`` floors
    the confidence of timeline-pinned forecasts.
    """

    def __init__(
        self,
        transitions: Mapping[str, Mapping[str, float]],
        mean_dwell_s: Mapping[str, float],
        timeline: Optional[object] = None,
        route_confidence: float = 0.95,
        prior_weight: float = 3.0,
    ):
        self.transitions: Dict[str, Dict[str, float]] = {
            m: dict(row) for m, row in transitions.items()
        }
        self.mean_dwell_s: Dict[str, float] = dict(mean_dwell_s)
        self.timeline = timeline
        self.route_confidence = float(route_confidence)
        #: how many pseudo-observations the priors are worth when
        #: blending with observed dwells
        self.prior_weight = float(prior_weight)
        # online dwell statistics: mode -> [n, sum, sum_sq]
        self._dwell_obs: Dict[str, list] = {}
        # online transition counts: (mode, next) -> n
        self._trans_obs: Dict[Tuple[str, str], int] = {}
        self.n_observed = 0

    # -- construction helpers -------------------------------------------
    @classmethod
    def from_generator(
        cls, generator, timeline: Optional[object] = None, **kw
    ) -> "ModeForecaster":
        """Forecaster primed with a
        :class:`~h100bench.ref_soa.scenarios.MarkovScenarioGenerator`'s own
        transition matrix and dwell means (the fleet-knowledge case)."""
        return cls(generator.transitions, generator.mean_dwell_s,
                   timeline=timeline, **kw)

    @classmethod
    def from_script(
        cls, script, use_timeline: bool = True, **kw
    ) -> "ModeForecaster":
        """Forecaster primed with a script's empirical bigram structure
        (see ``ScenarioScript.empirical_transitions``); with
        ``use_timeline`` the script also pins exact switch times (the
        route-informed case)."""
        trans, dwell = script.empirical_transitions()
        return cls(trans, dwell,
                   timeline=script if use_timeline else None, **kw)

    # -- online updates --------------------------------------------------
    def observe_switch(self, mode: str, next_mode: str, dwell_s: float) -> None:
        """Record one completed segment: ``mode`` dwelt ``dwell_s``
        seconds, then switched to ``next_mode``."""
        rec = self._dwell_obs.setdefault(mode, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += dwell_s
        rec[2] += dwell_s * dwell_s
        self._trans_obs[(mode, next_mode)] = (
            self._trans_obs.get((mode, next_mode), 0) + 1
        )
        self.n_observed += 1

    # -- estimates -------------------------------------------------------
    def dwell_estimate(self, mode: str) -> Tuple[float, float]:
        """``(mean, cv)`` dwell estimate for ``mode``: the prior blended
        with online observations at ``prior_weight`` pseudo-counts."""
        prior_mean = float(self.mean_dwell_s.get(mode, 0.0))
        n, s, ss = self._dwell_obs.get(mode, (0, 0.0, 0.0))
        if prior_mean <= 0.0 and n == 0:
            return 0.0, _PRIOR_DWELL_CV
        w = self.prior_weight if prior_mean > 0.0 else 0.0
        mean = (w * prior_mean + s) / max(w + n, 1e-12)
        if n >= 2:
            var_obs = max(ss / n - (s / n) ** 2, 0.0)
            cv_obs = math.sqrt(var_obs) / max(s / n, 1e-12)
            cv = (w * _PRIOR_DWELL_CV + n * cv_obs) / (w + n)
        else:
            cv = _PRIOR_DWELL_CV
        return mean, cv

    def successor_probs(self, mode: str) -> Dict[str, float]:
        """Normalised successor distribution for ``mode`` excluding the
        self-transition, blending the prior row with observed counts."""
        row = dict(self.transitions.get(mode, {}))
        total_prior = sum(v for k, v in row.items() if k != mode)
        out: Dict[str, float] = {}
        for (m, nxt), n in self._trans_obs.items():
            if m == mode and nxt != mode:
                out[nxt] = out.get(nxt, 0.0) + float(n)
        n_obs = sum(out.values())
        if total_prior > 0.0:
            w = self.prior_weight
            for k, v in row.items():
                if k != mode:
                    out[k] = out.get(k, 0.0) + w * (v / total_prior)
            n_obs += w
        if n_obs <= 0.0:
            return {}
        return {k: v / n_obs for k, v in out.items()}

    # -- the forecast ----------------------------------------------------
    def forecast(
        self, mode: str, entered_at_s: float, now_s: Optional[float] = None
    ) -> Optional[ModeForecast]:
        """Predict the end of the current ``mode`` segment (entered at
        ``entered_at_s``).  Returns ``None`` when the structure offers
        no successor (absorbing mode, empty row)."""
        now = entered_at_s if now_s is None else now_s
        probs = self.successor_probs(mode)

        if self.timeline is not None:
            nxt = self.timeline.next_switch(now)
            if nxt is None:
                return None
            switch_at, target = nxt
            conf = max(probs.get(target, 0.0), self.route_confidence)
            return ModeForecast(now, mode, target, switch_at, min(conf, 1.0))

        if not probs:
            return None
        target = max(sorted(probs), key=lambda k: probs[k])
        mean, cv = self.dwell_estimate(mode)
        if mean <= 0.0:
            return None
        switch_at = entered_at_s + mean
        # past the expected switch and still in `mode`: the seam is
        # overdue — predict it imminent rather than in the past
        if switch_at <= now:
            switch_at = now + max(0.1 * mean, 1e-3)
        conf = probs[target] * max(0.0, 1.0 - cv)
        return ModeForecast(now, mode, target, switch_at, min(conf, 1.0))
