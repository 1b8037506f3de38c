"""Family-level cell builders: (arch config × shape) → CellBundle.

A CellBundle is everything one cell needs: the step callable, the input
specs, the tracked specs for Check-N-Run, the optimizer, the device it all
lives on, and for the gnn and LM cells the reference's ``MODEL_FLOPS``
estimate and logical-axes map. The recsys family is ported whole: the train
cells (dlrm-rm2's sparse DLRM step, the generic autograd step for xdeepfm,
mind and bert4rec), the serve cells (``serve_p99``, ``serve_bulk``) and the
retrieval cell (``retrieval_cand``: one user against C candidates) of its
four archs. The gnn family (dimenet) is ported whole, and of the LM family
the dense archs (qwen2-0.5b, nemotron-4-15b): train, prefill and decode
cells. The MoE and MLA archs come with the rest of ROADMAP A6.4; the
partition specs of every family with the mesh slice (A6.5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import bert4rec as m_bert4rec
from ..models import dimenet as m_dimenet
from ..models import dlrm as m_dlrm
from ..models import mind as m_mind
from ..models import transformer as m_tf
from ..models import xdeepfm as m_xdeepfm
from ..optim.optimizers import adagrad, rowwise_adagrad, split_optimizer
from ..train.state import TrackedSpec, TrainState, init_train_state, rng_key_data
from ..train.steps import make_train_step
from . import shapes as S


class InputSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: Any  # numpy dtype


@dataclasses.dataclass
class CellBundle:
    arch: str
    shape: str
    kind: str                       # train | serve | retrieval | prefill | decode
    cfg: Any
    device: torch.device
    init: Callable                  # torch.Generator -> params
    step_fn: Callable               # train: (state, batch) -> (state, metrics)
                                    # serve: (params, batch) -> probs
                                    # retrieval: (params, batch) -> (C,)
    make_inputs: Callable           # () -> {name: InputSpec}
    tracked: Dict[str, TrackedSpec]
    optimizer: Any
    model_flops: Optional[float] = None     # gnn and LM cells
    param_axes_fn: Optional[Callable] = None  # (path_str, shape) -> logical axes

    def make_state(self, seed: int = 0) -> TrainState:
        """A fresh TrainState on the bundle's device, params drawn from a
        generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = self.init(gen)
        return init_train_state(params, self.optimizer, self.tracked,
                                rng_key_data(1), self.device)


_RECSYS_MODULES = {"dlrm-rm2": m_dlrm, "xdeepfm": m_xdeepfm, "mind": m_mind,
                   "bert4rec": m_bert4rec}


def _recsys_inputs(arch: str, cfg, B: int, kind: str, reduced: bool):
    """Input specs per recsys arch and cell kind (the reference's
    ``_recsys_stream``, with its serve overrides)."""
    if arch in ("dlrm-rm2", "xdeepfm"):
        d = dict(sparse_ids=InputSpec((B, cfg.n_sparse, cfg.multi_hot), np.int32))
        if kind == "train":
            d["label"] = InputSpec((B,), np.float32)
        if getattr(cfg, "n_dense", 0):
            d["dense"] = InputSpec((B, cfg.n_dense), np.float32)
        return d
    if arch == "mind":
        d = dict(hist=InputSpec((B, cfg.hist_len), np.int32),
                 target=InputSpec((B,), np.int32))
        if kind == "train":
            d["neg_ids"] = InputSpec((128 if reduced else 1024,), np.int32)
        return d
    items = InputSpec((B, cfg.seq_len), np.int32)
    if kind == "serve":
        return dict(items=items, candidate_ids=InputSpec((B, 100), np.int32))
    return dict(items=items, labels=InputSpec((B, cfg.seq_len), np.int32),
                mask=InputSpec((B, cfg.seq_len), np.bool_),
                neg_ids=InputSpec((64 if reduced else 256,), np.int32))


def _retrieval_inputs(arch: str, cfg, C: int, reduced: bool):
    """The user's train stream keys at batch 1, labels dropped, then the C
    candidate ids (the reference's retrieval override)."""
    user = {k: InputSpec((1,) + v.shape[1:], v.dtype)
            for k, v in _recsys_inputs(arch, cfg, 1, "train", reduced).items()
            if k not in ("label", "labels", "mask", "neg_ids", "target")}
    return dict(user, candidate_ids=InputSpec((C,), np.int32))


def recsys_cell(arch: str, cfg, shape: str, reduced: bool = False,
                device="cuda") -> CellBundle:
    spec = (S.RECSYS_SHAPES_REDUCED if reduced else S.RECSYS_SHAPES)[shape]
    kind = spec["kind"]
    if arch not in _RECSYS_MODULES:
        raise NotImplementedError(
            f"({arch}, {shape}): {arch} is not one of the recsys archs "
            f"{sorted(_RECSYS_MODULES)}; the MoE and MLA LMs come with ROADMAP "
            f"A6.4, the 40-cell registry with A6.5")
    dev = resolve_device(device)
    mod = _RECSYS_MODULES[arch]
    B = spec["batch"]
    tracked = mod.tracked_specs(cfg)
    optimizer = split_optimizer(rowwise_adagrad(0.01), adagrad(0.01))
    if kind == "train" and arch == "dlrm-rm2":
        # the sparse embedding update (see models/dlrm.py)
        step_fn = m_dlrm.make_sparse_train_step(cfg, adagrad(0.01))
    elif kind == "train":
        # bert4rec's full batch accumulates over 4 micro-batches, as the
        # reference's does; the other archs take the batch whole
        step_fn = make_train_step(
            lambda params, batch: mod.train_loss(params, batch, cfg), optimizer,
            n_micro=4 if (arch == "bert4rec" and not reduced and B >= 65536) else 1)
    elif kind == "serve":
        step_fn = lambda params, batch: mod.serve(params, batch, cfg)
    elif kind == "retrieval":
        step_fn = lambda params, batch: mod.serve_retrieval(params, batch, cfg)
    else:
        raise ValueError(kind)
    inputs = (_retrieval_inputs(arch, cfg, spec["n_candidates"], reduced)
              if kind == "retrieval"
              else _recsys_inputs(arch, cfg, B, kind, reduced))

    return CellBundle(
        arch=arch, shape=shape, kind=kind, cfg=cfg, device=dev,
        init=lambda gen: mod.init_params(gen, cfg),
        step_fn=step_fn, make_inputs=lambda: dict(inputs), tracked=tracked,
        optimizer=optimizer)


# =====================================================================
# LM family (the dense archs)
# =====================================================================


def lm_param_axes(path: str, shape: Tuple[int, ...]):
    """Logical axes of an LM parameter, the reference's map (the MoE and
    MLA leaves included): what the mesh slice will shard them over."""
    nd = len(shape)
    if "tok_emb" in path:
        return ("embed_rows", None) if nd == 2 else ("embed_rows",)
    if "w_out" in path:
        return ("d_model", "vocab")
    if any(k in path for k in ("['wq']", "['wk']", "['wv']")):
        ax = ("d_model", "heads" if "wq" in path else "kv_heads", None)
        return ((None,) + ax) if nd == 4 else ax
    if "['wo']" in path:
        return (None, "heads", None, "d_model")[-nd:]
    if any(k in path for k in ("['bq']", "['bk']", "['bv']")):
        return (None, "heads", None)[-nd:]
    if any(k in path for k in ("['w1']", "['wg']")):
        return (None, "d_model", "ff")[-nd:]
    if "['w2']" in path:
        return (None, "ff", "d_model")[-nd:]
    if "router" in path:
        return (None, "d_model", None)[-nd:]
    if any(k in path for k in ("['w_up']", "['w_gate']")):
        return (None, "experts", "d_model", None)[-nd:]
    if "['w_down']" in path:
        return (None, "experts", None, "d_model")[-nd:]
    if "['w_dq']" in path or "['w_dkv']" in path or "['w_kpe']" in path:
        return (None, "d_model", None)[-nd:]
    if "['w_uq']" in path or "['w_uk']" in path or "['w_uv']" in path:
        return (None, None, "heads", None)[-nd:]
    if "['w_o']" in path:
        return (None, "heads", None, "d_model")[-nd:]
    return (None,) * nd


def lm_cell(arch: str, cfg: m_tf.TransformerConfig, shape: str,
            reduced: bool = False, device="cuda",
            global_batch: Optional[int] = None) -> CellBundle:
    """An LM cell: ``train`` (autograd over the chunked cross-entropy, 4
    micro-batches at full shapes of global batch >= 64, as the reference's),
    ``prefill`` (last-position logits and the KV cache) or ``decode`` (one
    token against a cache made by ``init_cache``). ``global_batch``
    replaces the shape's batch (the card cannot hold every full batch);
    the sequence length stays."""
    spec = (S.LM_SHAPES_REDUCED if reduced else S.LM_SHAPES)[shape]
    kind = spec["kind"]
    dev = resolve_device(device)
    seq = spec["seq_len"]
    gb = spec["global_batch"] if global_batch is None else global_batch
    tracked = m_tf.tracked_specs(cfg)
    optimizer = split_optimizer(rowwise_adagrad(0.01), adagrad(0.01))
    tok = np.int32
    if kind == "train":
        n_micro = 4 if (not reduced and gb >= 64) else 1
        step_fn = make_train_step(lambda params, batch: m_tf.train_loss(params, batch, cfg),
                                  optimizer, n_micro=n_micro)
        inputs = dict(tokens=InputSpec((gb, seq), tok), labels=InputSpec((gb, seq), tok))
        flops = 6.0 * cfg.active_param_count * gb * seq
    elif kind == "prefill":
        step_fn = lambda params, batch: m_tf.prefill_step(params, batch["tokens"], cfg)
        inputs = dict(tokens=InputSpec((gb, seq), tok))
        flops = 2.0 * cfg.active_param_count * gb * seq
    elif kind == "decode":
        step_fn = lambda params, batch: m_tf.decode_step(
            params, batch["tokens"], batch["cache"], batch["cache_len"], cfg)
        cache = InputSpec((cfg.n_layers, gb, seq, cfg.n_kv_heads, cfg.head_dim),
                          torch.bfloat16)
        inputs = dict(tokens=InputSpec((gb, 1), tok), cache=dict(k=cache, v=cache),
                      cache_len=InputSpec((), np.int32))
        attn = 4.0 * gb * cfg.n_heads * seq * cfg.head_dim
        flops = 2.0 * cfg.active_param_count * gb + cfg.n_layers * attn
    else:
        raise ValueError(kind)
    return CellBundle(
        arch=arch, shape=shape, kind=kind, cfg=cfg, device=dev,
        init=lambda gen: m_tf.init_params(gen, cfg), step_fn=step_fn,
        make_inputs=lambda: dict(inputs), tracked=tracked, optimizer=optimizer,
        model_flops=flops, param_axes_fn=lm_param_axes)


# =====================================================================
# GNN family (dimenet)
# =====================================================================


def gnn_param_axes(path: str, shape: Tuple[int, ...]):
    nd = len(shape)
    if "species" in path:
        return ("embed_rows",) + (None,) * (nd - 1)
    return (None,) * nd


def dimenet_flops(cfg: m_dimenet.DimeNetConfig, n_nodes, n_edges, n_tri,
                  batch=1) -> float:
    h, nb = cfg.d_hidden, cfg.n_bilinear
    per_block = (2 * n_edges * h * h            # w_msg
                 + 2 * n_tri * cfg.n_sbf * nb   # sbf proj
                 + 2 * n_tri * nb * h * h       # bilinear
                 + 2 * n_edges * h * h * 2      # mlp
                 + 2 * n_edges * h * h)         # out proj
    f = cfg.n_blocks * per_block + 2 * n_edges * 3 * h * h
    return float(f) * batch


def gnn_cell(arch: str, base_cfg: m_dimenet.DimeNetConfig, shape: str,
             reduced: bool = False, device="cuda") -> CellBundle:
    """A dimenet train cell: ``molecule`` (a batch of small molecules, the
    species table tracked) or a flat graph (nodes with features, node
    classification, nothing tracked). Full flat shapes pad node and edge
    counts to multiples of 512, as the reference's (its 512-chip mesh); the
    pad rows are inert."""
    spec = (S.GNN_SHAPES_REDUCED if reduced else S.GNN_SHAPES)[shape]
    dev = resolve_device(device)
    tpe = spec["triplets_per_edge"]
    i32, f32 = np.int32, np.float32
    if shape == "molecule":
        cfg = dataclasses.replace(base_cfg, d_feat=0, n_out=1)
        B, N, E = spec["batch"], spec["n_nodes"], spec["n_edges"]
        T = tpe * E
        inputs = dict(species=InputSpec((B, N), i32), pos=InputSpec((B, N, 3), f32),
                      edge_src=InputSpec((B, E), i32), edge_dst=InputSpec((B, E), i32),
                      tri_kj=InputSpec((B, T), i32), tri_ji=InputSpec((B, T), i32),
                      energy=InputSpec((B,), f32))
        flops = 3.0 * dimenet_flops(cfg, N, E, T, batch=B)
    else:
        if shape == "minibatch_lg":
            N, E = S.block_shape(spec)
            n_seeds = spec["batch_nodes"]
        else:
            N, E = spec["n_nodes"], spec["n_edges"]
            n_seeds = N
        if not reduced:
            N = ((N + 511) // 512) * 512
            E = ((E + 511) // 512) * 512
            n_seeds = N if n_seeds == spec.get("n_nodes", n_seeds) else n_seeds
        T = tpe * E
        cfg = dataclasses.replace(base_cfg, d_feat=spec["d_feat"],
                                  n_out=spec["n_classes"])
        inputs = dict(features=InputSpec((N, spec["d_feat"]), f32),
                      edge_src=InputSpec((E,), i32), edge_dst=InputSpec((E,), i32),
                      tri_kj=InputSpec((T,), i32), tri_ji=InputSpec((T,), i32),
                      labels=InputSpec((n_seeds,), i32))
        if n_seeds != N:
            inputs["seed_idx"] = InputSpec((n_seeds,), i32)
        flops = 3.0 * dimenet_flops(cfg, N, E, T)
    tracked = m_dimenet.tracked_specs(cfg)
    optimizer = split_optimizer(rowwise_adagrad(0.01), adagrad(0.01))
    step_fn = make_train_step(lambda params, batch: m_dimenet.train_loss(params, batch, cfg),
                              optimizer)
    return CellBundle(
        arch=arch, shape=shape, kind="train", cfg=cfg, device=dev,
        init=lambda gen: m_dimenet.init_params(gen, cfg), step_fn=step_fn,
        make_inputs=lambda: dict(inputs), tracked=tracked, optimizer=optimizer,
        model_flops=flops, param_axes_fn=gnn_param_axes)
