from .reader import DataReader
from .synthetic import (
    HashGraph,
    HashGraphConfig,
    LMStreamConfig,
    MoleculeStreamConfig,
    RecsysStreamConfig,
    SeqRecStreamConfig,
    hash_weight,
    lm_batch,
    molecule_batch,
    recsys_batch,
    sample_subgraph,
    seqrec_batch,
    zipf_like,
)

__all__ = [k for k in dir() if not k.startswith("_")]
