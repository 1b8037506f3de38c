"""Check-N-Run core in PyTorch: incremental + quantized checkpointing."""

from .bitwidth import BitwidthController, expected_failures, select_bits
from .checkpoint import (
    CheckNRunManager,
    CheckpointConfig,
    PartialRecoveryError,
    RestoredState,
    SaveResult,
)
from .coordinator import (
    CommitContext,
    CommitCoordinator,
    ShardCommitError,
    build_manifest,
    try_commit,
)
from .integrity import (
    ChunkCorruptionError,
    Problem,
    ResumePlan,
    ScanReport,
    StepReport,
    plan_resume,
    quarantine_step,
    quarantined_steps,
    scan_step,
    scan_store,
    verify_chunk_bytes,
)
from .manifest import CommitRaceError, commit_once
from .metrics import (
    ManagerMetrics,
    render_prometheus,
    store_metrics,
    write_textfile,
)
from .pipeline import PipelineStats, RestorePipeline, StagePipeline, WritePipeline
from .incremental import (
    ConsecutiveIncrement,
    FullOnly,
    IncrementalPolicy,
    IntermittentBaseline,
    OneShotBaseline,
    make_policy,
)
from .quantize import (
    PAPER_DEFAULTS,
    KmeansQuantized,
    QuantConfig,
    Quantized,
    adaptive_quantize,
    dequantize,
    kmeans_block_quantize,
    kmeans_clustered_quantize,
    kmeans_dequantize,
    kmeans_quantize,
    mean_l2_loss,
    quantize,
    uniform_quantize,
)
from .reader_protocol import ReaderLease, ReaderState
from .remote_store import (
    FatalTransportError,
    FaultSpec,
    FaultyTransport,
    HttpTransport,
    RemoteObjectStore,
    RemoteStoreError,
    RetriesExhaustedError,
    RetryPolicy,
    ServerTransport,
    ThrottledTransport,
    TransientTransportError,
    make_store,
)
from .snapshot import Snapshot, take_snapshot
from .storage import (
    CheckpointCancelled,
    InMemoryStore,
    LinkModel,
    LocalFSStore,
    ObjectStore,
    ThrottledStore,
    host_link,
)
from .tracker import (
    init_touched,
    mark_touched,
    merge_touched,
    reset_touched,
    shard_indices,
    touched_fraction,
)

__all__ = [k for k in dir() if not k.startswith("_")]
