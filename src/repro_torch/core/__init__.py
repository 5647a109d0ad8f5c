"""SpotVista core in PyTorch: scoring (Eq. 2-4), Algorithm 1, the engine.

- scoring : availability (Eq. 3) / cost (Eq. 2) / combined (Eq. 4) scores
- pool    : greedy heterogeneous pool formation (Algorithm 1), ILP baseline
- engine  : recommendation facade (§4, Fig. 3)
- quantized : the quantized archive tier's error-bound / pool-parity contract
"""
from .types import (  # noqa: F401
    CandidateSet, Recommendation, RequestBatch, ResourceRequest,
)
from .config import (  # noqa: F401
    APIDeprecationWarning, EngineConfig, resolve_engine_config,
)
from .engine import RecommendationEngine  # noqa: F401
from .scoring import (  # noqa: F401
    availability_scores, availability_scores_masked, candidate_stats,
    CandidateStats, combined_scores, cost_scores, cost_scores_masked,
    DEFAULT_LAMBDA, DEFAULT_WEIGHT, resolve_score_impl, SCORE_TILED_AUTO_K,
)
from .pool import (  # noqa: F401
    PoolResult, greedy_pool, greedy_pool_masked, greedy_pool_vectorized,
    ilp_pool,
)
from .quantized import (  # noqa: F401
    check_pool_parity, pool_decision_margin, pools_identical,
    QuantizedParity, score_bound, stat_bounds,
)
