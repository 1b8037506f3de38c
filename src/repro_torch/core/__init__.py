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
from .incremental import (
    ConsecutiveIncrement,
    FullOnly,
    IncrementalPolicy,
    IntermittentBaseline,
    OneShotBaseline,
    make_policy,
)
from .integrity import (
    ChunkCorruptionError,
    ScanReport,
    plan_resume,
    quarantine_step,
    scan_step,
    scan_store,
    verify_chunk_bytes,
)
from .quantize import (
    PAPER_DEFAULTS,
    QuantConfig,
    Quantized,
    adaptive_quantize,
    dequantize,
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
