"""JASDA core on PyTorch + CUDA: the auction round as a composable library.

The port's counterpart of ``repro.core``: the auction round end to end,
repartitioning and migration; the baseline schedulers and the per-window
jit WIS path are not ported yet.

Layer map (paper section → module):
  §3.1 window announcement      → windows
  §3.2 TRP/FMP + variants       → trp, types
  §3.2–3.3 job-side bidding     → jobs, atomizer
  §4.2 scoring model            → scoring
  §4.2.1 calibration/trust      → calibration
  §4.3 temporal fairness        → fairness
  §4.4 WIS clearing             → wis, clearing
  clearing objective + presets  → policy (ClearingPolicy backends, Policy)
  bid-side negotiation          → negotiation (typed round messages,
                                  BiddingStrategy backends, RoundFeedback)
  §3/§4 interaction cycle       → scheduler, pipeline
  §6(a) quantitative study      → simulator
  dynamic MIG repartitioning    → repartition (+ migration ladder)
  fault injection + recovery    → faults (beyond-paper robustness layer)
"""
from .types import (  # noqa: F401
    DEAD_WINDOW_EPS,
    TIME_EPS,
    ClearingResult,
    Commitment,
    JobSpec,
    JobState,
    PoolView,
    RoundResult,
    SliceSpec,
    Variant,
    Window,
    variants_to_arrays,
)
from .trp import (  # noqa: F401
    Phase,
    PhaseFMP,
    fmp_from_model,
    fmp_standard,
    fmp_static,
    is_safe,
    predict_duration,
    prob_exceed_grid,
    prob_exceed_union,
)
from .scoring import (  # noqa: F401
    POLICY_BALANCED,
    POLICY_QOS_FIRST,
    POLICY_UTILIZATION_FIRST,
    ScoreHandle,
    ScoringPolicy,
    composite_score,
    score_pool,
    score_round,
    score_round_async,
)
from .wis import (  # noqa: F401
    RoundSelector,
    make_round_selector,
    wis_brute_force,
    wis_select,
    wis_select_batch,
)
from .calibration import CalibrationConfig, Calibrator, per_variant_error, reliability  # noqa: F401
from .fairness import AgePolicy, AgeTracker, jain_index  # noqa: F401
from .windows import (  # noqa: F401
    DeadWindowRegistry,
    SliceTimeline,
    WindowPolicy,
    announce_window,
    announce_windows,
)
from .atomizer import AtomizerConfig, ChunkPlan, chunk_candidates  # noqa: F401
from .negotiation import (  # noqa: F401
    AdaptiveBidder,
    Award,
    BidBundle,
    BiddingStrategy,
    ConservativeSafety,
    GreedyChunking,
    LossReport,
    RoundFeedback,
    WindowAnnouncement,
    build_feedback,
)
from .faults import (  # noqa: F401
    FAULT_KINDS,
    AgentFault,
    AgentRespondError,
    AgentSilentError,
    FaultEvent,
    FaultInjector,
    FaultPlan,
)
from .jobs import AgentConfig, JobAgent  # noqa: F401
from .clearing import assign_bids, clear_round, clear_window, settle_round  # noqa: F401
from .policy import (  # noqa: F401
    ClearingPolicy,
    FairShare,
    GlobalAssignment,
    GreedyWIS,
    Policy,
)
from .scheduler import CommitRecord, JasdaScheduler, SchedulerConfig  # noqa: F401
from .pipeline import RoundPipeline, pipelined_clear_rounds  # noqa: F401
from .simulator import SimConfig, SimResult, make_workload, simulate  # noqa: F401
from .repartition import (  # noqa: F401
    EnergyAware,
    EnergyModel,
    FragmentationAware,
    MigrationConfig,
    MigrationPlanner,
    Move,
    ProfileLattice,
    RepartitionCoordinator,
    RepartitionPolicy,
    RepartitionState,
    SliceProfile,
    StaticInventory,
    fragmentation_index,
)
from .baselines import (  # noqa: F401
    AuctionScheduler,
    BackfillScheduler,
    BestFitScheduler,
    FifoScheduler,
)
