"""Check-N-Run core in PyTorch: incremental + quantized checkpointing."""

from .bitwidth import BitwidthController, expected_failures, select_bits
from .checkpoint import (
    CheckNRunManager,
    CheckpointConfig,
    RestoredState,
    SaveResult,
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
from .snapshot import Snapshot, take_snapshot
from .storage import (
    CheckpointCancelled,
    InMemoryStore,
    LocalFSStore,
    ObjectStore,
    ThrottledStore,
)

__all__ = [k for k in dir() if not k.startswith("_")]
