"""The paper's own system config: collector + scoring + recommendation defaults."""
from dataclasses import dataclass


@dataclass(frozen=True)
class SpotVistaConfig:
    # Data collector (§5): USQS every 10 min over counts 5..50 step 5.
    collect_period_min: float = 10.0
    t_min: int = 5
    t_max: int = 50
    step: int = 5
    tstp_early_stop: int = 4
    # Scoring (§4.2, §6.3): lambda=0.1, 7-day window, W=0.5.
    lam: float = 0.1
    window_days: float = 7.0
    weight: float = 0.5


CONFIG = SpotVistaConfig()
