"""Family-level cell builders: (arch config × shape) → CellBundle.

A CellBundle is everything one cell needs: the step callable, the input
specs and their partition specs, the sharding rules, the tracked specs for
Check-N-Run, the optimizer, the device it all lives on, the ``MODEL_FLOPS``
estimate of the roofline report and the logical-axes map of the params.
The recsys family: the train cells (dlrm-rm2's sparse DLRM step, the
generic autograd step for xdeepfm, mind and bert4rec; on a mesh that
carries a process group, the step of one rank: its rows of the
row-sharded tables and its data shard of the batch, see
``models.embedding.ShardedLookup`` and ``dist.placement``), the serve cells
(``serve_p99``, ``serve_bulk``) and the retrieval cell (``retrieval_cand``:
one user against C candidates) of its four archs. The gnn family
(dimenet) and the LM family (qwen2-0.5b, nemotron-4-15b, the MoE archs
olmoe-1b-7b and dbrx-132b, the MLA arch minicpm3-4b: train, prefill and
decode cells).

Partition specs follow the reference's rules leaf for leaf. The port's
state tree differs from the reference's in two leaves, and each takes the
reference's spec: ``step`` is a host int where the reference holds an
int32 scalar, and ``rng`` is the key's data, a ``uint32 (2,)`` host array,
where the reference holds a typed key; both are replicated (``P()``), and
the dry run counts them as the int32 scalar and the ``uint32 (2,)`` the
reference's arrays are on a device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import on_meta, resolve_device
from ..dist.sharding import P, ShardingRules, gnn_rules, lm_rules, recsys_rules
from ..models import bert4rec as m_bert4rec
from ..models import dimenet as m_dimenet
from ..models import dlrm as m_dlrm
from ..models import mind as m_mind
from ..models import transformer as m_tf
from ..models import xdeepfm as m_xdeepfm
from ..optim.optimizers import adagrad, rowwise_adagrad, split_optimizer
from ..train.state import TrackedSpec, TrainState, init_train_state, rng_key_data
from ..train.steps import make_train_step
from ..tree import flatten_with_path, keystr, map_with_path
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
    model_flops: float
    param_axes_fn: Callable         # (path_str, shape) -> logical axes tuple
    rules: ShardingRules
    input_pspecs: Any               # {name: PartitionSpec} (cache: a dict or None)
    # (generator, keep) -> params, each leaf passed to keep(path, leaf) as
    # it is made (dist.placement.Placement.init_state); None: init whole
    init_kept: Optional[Callable] = None

    def make_state(self, seed: int = 0) -> TrainState:
        """A fresh TrainState on the bundle's device, params drawn from a
        generator seeded with ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = self.init(gen)
        return init_train_state(params, self.optimizer, self.tracked,
                                rng_key_data(1), self.device)

    # ------------------------------------------------ derived specs
    def params_shapes(self):
        """The params tree on the ``meta`` device: shapes and dtypes, no
        storage (the reference's ``jax.eval_shape`` of ``init``)."""
        with on_meta():
            return self.init(torch.Generator())

    def params_pspecs(self, params_shapes=None):
        ps = params_shapes if params_shapes is not None else self.params_shapes()
        return tree_pspecs(ps, self.rules, self.param_axes_fn)

    def state_shapes(self) -> TrainState:
        """The TrainState on the ``meta`` device."""
        with on_meta():
            params = self.init(torch.Generator())
            return init_train_state(params, self.optimizer, self.tracked,
                                    rng_key_data(1), "meta")

    def state_pspecs(self, state_shapes=None) -> TrainState:
        """The reference's ``state_pspecs``: params and optimizer state by
        the params' logical axes, the touched masks of table paths over
        ``embed_rows`` (the expert blocks' replicated), ``step`` and
        ``rng`` replicated."""
        st = state_shapes if state_shapes is not None else self.state_shapes()
        params_p = tree_pspecs(st.params, self.rules, self.param_axes_fn)
        opt_p = tree_pspecs(st.opt_state, self.rules, self.param_axes_fn)
        touched_p = {}
        for name, leaf in st.touched.items():
            spec = self.tracked[name]
            ax = ("embed_rows",) if spec.path[0] == "tables" else (None,)
            touched_p[name] = self.rules.pspec(*ax, dims=tuple(leaf.shape))
        return TrainState(step=P(), params=params_p, opt_state=opt_p,
                          touched=touched_p, rng=P())


def tree_pspecs(tree, rules: ShardingRules, axes_fn):
    """A PartitionSpec at every leaf of ``tree``, from the leaf's path (as
    ``jax.tree_util.keystr`` spells it) and shape."""
    def leaf_spec(path, leaf):
        dims = tuple(leaf.shape)
        return rules.pspec(*axes_fn(keystr(path), dims), dims=dims)
    return map_with_path(leaf_spec, tree)


# =====================================================================
# Recsys family
# =====================================================================


def _batch_axes(rules: ShardingRules, B: int, arch: str, shape: str):
    """The mesh axes a train batch of ``B`` splits over; raises where it
    does not (such a cell never trains on one device in the mesh's place)."""
    axes = rules.axes_for("batch", B)
    if not axes:
        raise ValueError(f"({arch}, {shape}): a batch of {B} does not split over "
                         f"{rules.mesh!r}")
    return axes


def _replicated(init: Callable, rules: ShardingRules, axes_fn) -> Callable:
    """A predicate on a parameter's tree path: true where the rules leave
    the parameter replicated (its partition spec names no mesh axis)."""
    with on_meta():
        shapes = init(torch.Generator())
    split = {keystr(p) for p, spec in flatten_with_path(tree_pspecs(shapes, rules, axes_fn))
             if any(e is not None for e in spec)}
    return lambda path: keystr(path) not in split


def recsys_param_axes(path: str, shape: Tuple[int, ...]):
    nd = len(shape)
    if "tables" in path or "emb_" in path or "lin_" in path or "item_" in path:
        return ("embed_rows",) + (None,) * (nd - 1)
    if "out_bias" in path:
        return ("embed_rows",)[-nd:] if nd == 1 else (None,) * nd
    return (None,) * nd


_RECSYS_MODULES = {"dlrm-rm2": m_dlrm, "xdeepfm": m_xdeepfm, "mind": m_mind,
                   "bert4rec": m_bert4rec}


def recsys_dense_flops(arch: str, cfg, batch: int) -> float:
    """Analytic forward FLOPs of ``batch`` examples (matmul-dominated
    terms), from the arch's own module."""
    return _RECSYS_MODULES[arch].dense_flops(cfg, batch)


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


def _recsys_pspecs(rules: ShardingRules, inputs, B: int, kind: str):
    """The reference's input specs: a leading batch dim over ``batch``
    (``neg_ids`` aside), the retrieval candidates over ``candidates``,
    the rest replicated."""
    def one(k, sh):
        if kind == "retrieval" and k == "candidate_ids":
            return rules.pspec("candidates", dims=sh)
        if sh and sh[0] == B and k != "neg_ids":
            return rules.pspec("batch", *([None] * (len(sh) - 1)), dims=sh)
        return rules.pspec(*([None] * len(sh)), dims=sh)
    return {k: one(k, tuple(v.shape)) for k, v in inputs.items()}


def recsys_cell(arch: str, cfg, shape: str, reduced: bool = False,
                device="cuda", mesh=None, global_batch: Optional[int] = None) -> CellBundle:
    """A recsys cell; ``global_batch`` replaces a train cell's batch (where
    the card cannot hold the shape's on every rank of a mesh)."""
    spec = (S.RECSYS_SHAPES_REDUCED if reduced else S.RECSYS_SHAPES)[shape]
    if global_batch is not None:
        if spec["kind"] != "train":
            raise ValueError(f"({arch}, {shape}): a global batch replaces a train "
                             "cell's batch only")
        spec = dict(spec, batch=global_batch)
    kind = spec["kind"]
    if arch not in _RECSYS_MODULES:
        raise ValueError(f"({arch}, {shape}): {arch} is not one of the recsys "
                         f"archs {sorted(_RECSYS_MODULES)}")
    dev = resolve_device(device)
    rules = recsys_rules(mesh)
    mod = _RECSYS_MODULES[arch]
    B = spec["batch"]
    tracked = mod.tracked_specs(cfg)
    optimizer = split_optimizer(rowwise_adagrad(0.01), adagrad(0.01))
    grads = {}
    if kind == "train" and getattr(mesh, "has_group", False):
        # a rank of the mesh: its data shard of the batch, its rows of the
        # tables (models.embedding.ShardedLookup); the replicated leaves'
        # gradients summed over the batch's axes
        group = mesh.group_for(_batch_axes(rules, B, arch, shape))
        replicated = _replicated(lambda gen: mod.init_params(gen, cfg), rules,
                                 recsys_param_axes)
        grads = dict(grad_groups=lambda path: group if replicated(path) else None)
    if kind == "train" and arch == "dlrm-rm2":
        # the sparse embedding update (see models/dlrm.py)
        step_fn = m_dlrm.make_sparse_train_step(cfg, adagrad(0.01), rules=rules)
    elif kind == "train":
        # bert4rec's full batch accumulates over 4 micro-batches, as the
        # reference's does; the other archs take the batch whole
        step_fn = make_train_step(
            lambda params, batch: mod.train_loss(params, batch, cfg, rules), optimizer,
            n_micro=4 if (arch == "bert4rec" and not reduced and B >= 65536) else 1,
            **grads)
    elif kind == "serve":
        step_fn = lambda params, batch: mod.serve(params, batch, cfg)
    elif kind == "retrieval":
        step_fn = lambda params, batch: mod.serve_retrieval(params, batch, cfg)
    else:
        raise ValueError(kind)
    inputs = (_retrieval_inputs(arch, cfg, spec["n_candidates"], reduced)
              if kind == "retrieval"
              else _recsys_inputs(arch, cfg, B, kind, reduced))
    if kind == "train":
        flops = 3.0 * mod.dense_flops(cfg, B)  # fwd+bwd ≈ 3× fwd
    elif kind == "serve":
        flops = mod.dense_flops(cfg, B)
    else:
        flops = mod.retrieval_flops(cfg, spec["n_candidates"])

    return CellBundle(
        arch=arch, shape=shape, kind=kind, cfg=cfg, device=dev,
        init=lambda gen: mod.init_params(gen, cfg),
        step_fn=step_fn, make_inputs=lambda: dict(inputs), tracked=tracked,
        optimizer=optimizer, model_flops=flops, param_axes_fn=recsys_param_axes,
        rules=rules, input_pspecs=_recsys_pspecs(rules, inputs, B, kind))


# =====================================================================
# LM family
# =====================================================================


def lm_param_axes(path: str, shape: Tuple[int, ...]):
    """Logical axes of an LM parameter, the reference's map (the MoE and
    MLA leaves included)."""
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


def _lm_cache_pspec(cfg: m_tf.TransformerConfig, rules: ShardingRules,
                    batch: int, max_len: int):
    """The decode cache's specs: the batch over ``batch``; MLA's latents
    over ``model`` along the sequence where it divides; GQA/MHA's k and v
    over ``model`` along the kv heads where they divide, else along the
    sequence where it divides. None without a mesh."""
    if rules.mesh is None:
        return None
    model_n = rules.mesh.shape.get("model", 1)
    batch_ax = rules.pspec("batch", dims=(batch,))[0]
    if cfg.mla:
        seq_ax = "model" if max_len % model_n == 0 else None
        return dict(ckv=P(None, batch_ax, seq_ax, None),
                    kpe=P(None, batch_ax, seq_ax, None))
    if cfg.n_kv_heads % model_n == 0:
        return dict(k=P(None, batch_ax, None, "model", None),
                    v=P(None, batch_ax, None, "model", None))
    seq_ax = "model" if max_len % model_n == 0 else None
    return dict(k=P(None, batch_ax, seq_ax, None, None),
                v=P(None, batch_ax, seq_ax, None, None))


# the replicated leaves that sit on the kv side of a head-sharded attention
# (each rank's cotangent comes from its own q heads alone)
_KV_SIDE = ("['wk']", "['wv']", "['bk']", "['bv']", "['w_dq']", "['q_norm']",
            "['w_dkv']", "['kv_norm']", "['w_kpe']")


def lm_grad_axes(path: str, split: bool, tp) -> Optional[Tuple[str, ...]]:
    """The mesh axes an LM leaf's gradient sums over in the tensor-parallel
    step (``dist.tensor_parallel``), for the leaf at ``path`` whose spec
    names a mesh axis where ``split``, on a rank laid out as ``tp``.

    One global loss, every rank holding it; a rank's gradient of a leaf is
    its part of the global gradient, and the parts sum over the ranks that
    hold the same block of the leaf and computed other parts:
      * ``tok_emb`` row-sharded: none (every data shard's ids reach the
        rank's rows through the exchange);
      * a leaf split over ``model`` (``wq``, ``bq``, ``wo``; ``wk``,
        ``wv``, ``bk``, ``bv`` where the kv heads shard; ``w1``, ``wg``,
        ``w2``; MLA's ``w_uq``, ``w_uk``, ``w_uv``, ``w_o``; the experts;
        ``w_out``): ``data``;
      * a replicated leaf: ``data``, and ``model`` too where the ``model``
        ranks see different parts of its cotangent: every replicated leaf
        under sequence parallelism (each rank's own positions: the norm
        gains ``ln1``, ``ln2``, ``final_norm``, a replicated ``tok_emb``,
        ``w_out``, attention or FFN weights that do not shard); the kv
        side of a head-sharded attention (``wk``, ``wv``, ``bk``, ``bv``
        where the kv heads do not shard; MLA's ``w_dq``, ``q_norm``,
        ``w_dkv``, ``kv_norm``, ``w_kpe``: each rank's own heads); the
        router under expert parallelism (each rank's own experts, and the
        aux loss's cotangent passed through a sum over the world).
    Without sequence parallelism the residual is the same on every
    ``model`` rank and so is a replicated leaf's part, but for the kv side
    and the router."""
    data = tuple(tp.rules.axis_map["batch"])
    if "tok_emb" in path and split:
        return None
    if split:
        return data
    spread = (tp.sp or (tp.heads and any(k in path for k in _KV_SIDE))
              or (tp.experts and "router" in path))
    return data + ("model",) if spread else data


def lm_cell(arch: str, cfg: m_tf.TransformerConfig, shape: str,
            reduced: bool = False, device="cuda",
            global_batch: Optional[int] = None, mesh=None) -> CellBundle:
    """An LM cell: ``train`` (autograd over the chunked cross-entropy, 4
    micro-batches at full shapes of global batch >= 64, as the reference's),
    ``prefill`` (last-position logits and the KV cache) or ``decode`` (one
    token against a cache made by ``init_cache``). ``global_batch``
    replaces the shape's batch (the card cannot hold every full batch);
    the sequence length stays. Under a ``mesh`` the rules are the LM's
    (pure FSDP for a config that asks for it, at full train shapes). On a
    mesh that carries a process group a train cell's step is one rank's
    tensor-parallel step (``models.transformer.train_loss``), each leaf's
    gradient summed over ``lm_grad_axes``' group; a pure-FSDP config
    raises there (the port has no such step)."""
    from ..dist.tensor_parallel import tensor_parallel

    spec = (S.LM_SHAPES_REDUCED if reduced else S.LM_SHAPES)[shape]
    kind = spec["kind"]
    dev = resolve_device(device)
    rules = lm_rules(mesh, pure_fsdp=(cfg.pure_fsdp_train and kind == "train"
                                      and not reduced))
    seq = spec["seq_len"]
    gb = spec["global_batch"] if global_batch is None else global_batch
    tracked = m_tf.tracked_specs(cfg)
    optimizer = split_optimizer(rowwise_adagrad(0.01), adagrad(0.01))
    tok = np.int32
    tokens_p = rules.pspec("batch", None, dims=(gb, seq))
    if kind == "train":
        n_micro = 4 if (not reduced and gb >= 64) else 1
        grads, sharded = {}, getattr(mesh, "has_group", False)
        if sharded:
            _batch_axes(rules, gb // n_micro, arch, shape)
            tp = tensor_parallel(rules, cfg, seq)
            replicated = _replicated(lambda gen: m_tf.init_params(gen, cfg), rules,
                                     lm_param_axes)

            def group_of(path):
                axes = lm_grad_axes(keystr(path), not replicated(path), tp)
                if not axes:
                    return None
                group = mesh.group_for(axes)
                return group if math.prod(mesh.shape[a] for a in axes) > 1 else None

            # the update in place: four ranks of a full-width cell on one
            # card hold three copies of their blocks, not six
            grads = dict(grad_groups=group_of, in_place=True)
        step_fn = make_train_step(
            lambda params, batch: m_tf.train_loss(params, batch, cfg, rules, sharded),
            optimizer, n_micro=n_micro, **grads)
        inputs = dict(tokens=InputSpec((gb, seq), tok), labels=InputSpec((gb, seq), tok))
        input_pspecs = dict(tokens=tokens_p, labels=tokens_p)
        flops = 6.0 * cfg.active_param_count * gb * seq
    elif kind == "prefill":
        step_fn = lambda params, batch: m_tf.prefill_step(params, batch["tokens"], cfg,
                                                          rules=rules)
        inputs = dict(tokens=InputSpec((gb, seq), tok))
        input_pspecs = dict(tokens=tokens_p)
        flops = 2.0 * cfg.active_param_count * gb * seq
    elif kind == "decode":
        step_fn = lambda params, batch: m_tf.decode_step(
            params, batch["tokens"], batch["cache"], batch["cache_len"], cfg, rules)
        L = cfg.n_layers
        if cfg.mla:  # the latent cache
            cache = dict(ckv=InputSpec((L, gb, seq, cfg.mla.kv_lora_rank), torch.bfloat16),
                         kpe=InputSpec((L, gb, seq, cfg.mla.qk_rope_dim), torch.bfloat16))
            attn = 2.0 * gb * cfg.n_heads * seq * (cfg.mla.kv_lora_rank * 2)
        else:
            kv = InputSpec((L, gb, seq, cfg.n_kv_heads, cfg.head_dim), torch.bfloat16)
            cache = dict(k=kv, v=kv)
            attn = 4.0 * gb * cfg.n_heads * seq * cfg.head_dim
        inputs = dict(tokens=InputSpec((gb, 1), tok), cache=cache,
                      cache_len=InputSpec((), np.int32))
        input_pspecs = dict(tokens=rules.pspec("batch", None, dims=(gb, 1)),
                            cache=_lm_cache_pspec(cfg, rules, gb, seq), cache_len=P())
        flops = 2.0 * cfg.active_param_count * gb + cfg.n_layers * attn
    else:
        raise ValueError(kind)
    return CellBundle(
        arch=arch, shape=shape, kind=kind, cfg=cfg, device=dev,
        init=lambda gen: m_tf.init_params(gen, cfg), step_fn=step_fn,
        make_inputs=lambda: dict(inputs), tracked=tracked, optimizer=optimizer,
        model_flops=flops, param_axes_fn=lm_param_axes, rules=rules,
        input_pspecs=input_pspecs,
        init_kept=lambda gen, keep: m_tf.init_params(gen, cfg, keep))


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


def _gnn_grad_group(inputs, cfg, rules: ShardingRules, shape: str):
    """The group a step sums its gradients over, where the mesh carries a
    group: a flat graph's node axes' subgroup where the cell's batch takes
    the sharded forward (``m_dimenet._use_sharded``, read off the input
    specs); ``molecule``'s batch axes (data parallel: each rank its data
    shard of the molecules; raises where the batch does not split); None
    otherwise."""
    mesh = rules.mesh
    if not getattr(mesh, "has_group", False):
        return None
    if cfg.d_feat == 0:
        return mesh.group_for(_batch_axes(rules, inputs["species"].shape[0], "dimenet", shape))
    if not m_dimenet._use_sharded(inputs, cfg, rules):
        return None
    return mesh.group_for(rules.axes_for("nodes", inputs["features"].shape[0]))


def gnn_cell(arch: str, base_cfg: m_dimenet.DimeNetConfig, shape: str,
             reduced: bool = False, device="cuda", mesh=None) -> CellBundle:
    """A dimenet train cell: ``molecule`` (a batch of small molecules, the
    species table tracked) or a flat graph (nodes with features, node
    classification, nothing tracked). Full flat shapes pad node and edge
    counts to multiples of 512, as the reference's (its 512-chip mesh); the
    pad rows are inert. The loss takes the rules, as the reference's does:
    on a mesh that carries a group, a flat-graph cell whose batch shards
    trains through ``forward_flat_sharded``, ``molecule`` data-parallel
    over the batch's axes, and the step sums the ranks' gradients
    (``_gnn_grad_group``)."""
    spec = (S.GNN_SHAPES_REDUCED if reduced else S.GNN_SHAPES)[shape]
    dev = resolve_device(device)
    rules = gnn_rules(mesh)
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
        input_pspecs = {k: rules.pspec("batch", *([None] * (len(v.shape) - 1)),
                                       dims=(B,) + (1,) * (len(v.shape) - 1))
                        for k, v in inputs.items()}
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
        input_pspecs = dict(
            features=rules.pspec("nodes", None, dims=(N, spec["d_feat"])),
            edge_src=rules.pspec("edges", dims=(E,)),
            edge_dst=rules.pspec("edges", dims=(E,)),
            tri_kj=rules.pspec("triplets", dims=(T,)),
            tri_ji=rules.pspec("triplets", dims=(T,)),
            labels=rules.pspec(None, dims=(n_seeds,)))
        if n_seeds != N:
            input_pspecs["seed_idx"] = rules.pspec(None, dims=(n_seeds,))
        flops = 3.0 * dimenet_flops(cfg, N, E, T)
    tracked = m_dimenet.tracked_specs(cfg)
    optimizer = split_optimizer(rowwise_adagrad(0.01), adagrad(0.01))
    group = _gnn_grad_group(inputs, cfg, rules, shape)
    step_fn = make_train_step(
        lambda params, batch: m_dimenet.train_loss(params, batch, cfg, rules), optimizer,
        grad_groups=None if group is None else lambda path: group)
    return CellBundle(
        arch=arch, shape=shape, kind="train", cfg=cfg, device=dev,
        init=lambda gen: m_dimenet.init_params(gen, cfg), step_fn=step_fn,
        make_inputs=lambda: dict(inputs), tracked=tracked, optimizer=optimizer,
        model_flops=flops, param_axes_fn=gnn_param_axes, rules=rules,
        input_pspecs=input_pspecs)
