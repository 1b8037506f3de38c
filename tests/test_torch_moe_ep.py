"""The port's expert-parallel MoE (``moe_ffn`` with ``dispatch="ep"``)
across 8 CPU processes against the reference's under ``shard_map`` on 8
emulated devices, both on a 2 × 4 ``("data", "model")`` mesh (the
reference test's, ``tests/test_distribution.py``).

The reference runs in a subprocess that sets ``XLA_FLAGS`` before it
imports JAX, as that test does; the port's ranks are 8 ``python -c``
processes on a gloo group at ``tcp://127.0.0.1:<free port>``, each with a
timeout of its own, each destroying its group before it exits; the pytest
process opens no group. Both sides take the same numpy inputs: the
reference's parameters (``moe_params_init``, and olmoe's reduced train
state) carried to the port through numpy, the same tokens. Rank (i, j)
gets batch shard i (the reference's split of the flattened tokens over
``data``) and owns experts 2j and 2j + 1.

Held, in f32 compute: each rank's output to the reference's rows of its
shard at rtol/atol 1e-5 (products and sums in another order), the touched
mask equal, the aux loss at 1e-6 — at a capacity factor that drops tokens
(φ = 1: 16 slots an expert for 64 tokens of top-2 over 8 experts) and at
one that drops none (φ = 4: the capacity is every token), and with the
weights' d_model shard gathered before use (rules that map ``d_model``
to ``data``). In each case the gradients too: every rank backpropagates
its share of ``sum(y * cot) + 0.01 * aux`` (its shard's sum times the
data shards, plus the aux term), and the rule ``_moe_ep`` states — a
parameter's gradient is the sum over the ranks that hold it, over the
world size — must give the reference's ``jax.grad`` under ``shard_map``
for the router, the experts and the input, within 1e-5 of each
gradient's largest entry. Then olmoe's reduced model: ``train_loss``
under the mesh (``dispatch="auto"`` resolving to ``ep``), each rank's
cross-entropy averaged over the data shards plus the aux term, against
the reference's loss at 1e-5; the touched masks equal; and every
parameter's gradient of the cross-entropy, combined by the same rule,
against the reference's ``jax.grad`` of it within 1e-5 of the leaf's
largest entry. The reference's model gradient is taken without a mesh,
through the dense dispatch: its backward under a mesh stops on a
sharding error in the logits' product, and where nothing drops the two
dispatches compute one function. Routing is compared only where it
cannot flip: each rank records its router's least gap between the k-th
and (k+1)-th probability, asserted above ``MARGIN`` first.
"""

import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import get_cell as ref_get_cell
from repro.models import layers as ref_layers
from test_torch_mind import _to_numpy
from test_torch_moe import MARGIN

DATA, MODEL = 2, 4
RANKS = DATA * MODEL
B, S = 8, 16                     # the layer's global tokens: 128, 64 a data shard
CASES = {"drop": 1.0, "nodrop": 4.0, "fsdp": 1.0}
ROOT = str(pathlib.Path(__file__).resolve().parents[1])
TIMEOUT = 240

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro.dist.sharding import ShardingRules, lm_rules
    from repro.models import layers, transformer as tf

    d = sys.argv[1]
    inp = np.load(os.path.join(d, "in.npz"))
    with open(os.path.join(d, "model.pkl"), "rb") as f:
        model = pickle.load(f)
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    moe = layers.MoEConfig(n_experts=8, top_k=2, d_ff=32, gated=True, dispatch="ep")
    p = {k: jnp.asarray(inp[k]) for k in ("router", "w_up", "w_gate", "w_down")}
    out = {}
    cot = jnp.asarray(inp["cot"])
    for case, phi in __CASES__.items():
        rules = (ShardingRules(mesh, {"batch": ("data",), "d_model": ("data",)})
                 if case == "fsdp" else lm_rules(mesh))
        cfg = dataclasses.replace(moe, capacity_factor=phi)
        f = lambda x, p: layers.moe_ffn(x, p, cfg, compute_dtype=jnp.float32, rules=rules)

        def objective(p, x):
            y, _, a = f(x, p)
            return jnp.sum(y * cot) + 0.01 * a

        with mesh:
            y, t, a = jax.jit(f)(jnp.asarray(inp["x"]), p)
            gp, gx = jax.jit(jax.grad(objective, argnums=(0, 1)))(p, jnp.asarray(inp["x"]))
        out[case + "_out"], out[case + "_touched"] = np.asarray(y), np.asarray(t)
        out[case + "_aux"] = np.asarray(a)
        for k, v in gp.items():
            out[case + "_grad_" + k] = np.asarray(v)
        out[case + "_grad_x"] = np.asarray(gx)
    from repro.configs import _module
    cfg = _module("olmoe-1b-7b").make_config(reduced=True)
    cfg = dataclasses.replace(cfg, compute_dtype=jnp.float32, moe=dataclasses.replace(
        cfg.moe, capacity_factor=__NODROP__))
    batch = dict(tokens=jnp.asarray(inp["tokens"]), labels=jnp.asarray(inp["labels"]))
    params = jax.tree.map(jnp.asarray, model)
    with mesh:
        loss, aux = jax.jit(lambda p, b: tf.train_loss(p, b, cfg, lm_rules(mesh)))(params, batch)
    out["model_loss"], out["model_aux"] = np.asarray(loss), np.asarray(aux["aux_loss"])
    for k, v in aux["touched"].items():
        out["model_touched_" + k] = np.asarray(v)
    # the cross-entropy's gradient, through the dense dispatch without a mesh
    ce = lambda p: tf.train_loss(p, batch, dataclasses.replace(cfg, aux_loss_coef=0.0))[0]
    for path, v in jax.tree_util.tree_leaves_with_path(jax.jit(jax.grad(ce))(params)):
        out["model_grad_" + jax.tree_util.keystr(path)] = np.asarray(v)
    np.savez(os.path.join(d, "ref.npz"), **out)
    print("OK")
""").replace("__CASES__", repr(CASES)).replace(
    "__NODROP__", repr(CASES["nodrop"]))

_WORKER = textwrap.dedent("""
    import dataclasses, datetime, json, os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.configs import _module
        from repro_torch.dist.sharding import ShardingRules, lm_rules
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import layers, transformer as tf
        from repro_torch.tree import flatten_with_path, keystr, tree_map

        margins = []
        router = layers._moe_router

        def recording(xf, w, top_k):
            probs, weights, ids = router(xf, w, top_k)
            top = torch.topk(probs.detach(), top_k + 1, dim=-1).values
            margins.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
            return probs, weights, ids

        layers._moe_router = recording
        mesh = make_host_mesh(__DATA__, __MODEL__)
        i, j = mesh.axis_index("data"), mesh.axis_index("model")
        assert mesh.coords == dict(data=rank // __MODEL__, model=rank % __MODEL__)
        inp = np.load(os.path.join(d, "in.npz"))
        full = {k: torch.from_numpy(inp[k]) for k in ("router", "w_up", "w_gate", "w_down")}
        rows = slice(i * __B__ // __DATA__, (i + 1) * __B__ // __DATA__)
        cot = torch.from_numpy(inp["cot"][rows])
        moe = layers.MoEConfig(n_experts=8, top_k=2, d_ff=32, gated=True, dispatch="ep")
        e = slice(2 * j, 2 * j + 2)      # this rank's experts
        out = {}
        for case, phi in __CASES__.items():
            cfg = dataclasses.replace(moe, capacity_factor=phi)
            if case == "fsdp":
                rules = ShardingRules(mesh, {"batch": ("data",), "d_model": ("data",)})
                h = slice(i * 32, (i + 1) * 32)  # this data rank's d_model shard
                params = dict(router=full["router"], w_up=full["w_up"][e, h],
                              w_gate=full["w_gate"][e, h], w_down=full["w_down"][e][:, :, h])
            else:
                rules = lm_rules(mesh)
                params = dict(router=full["router"], w_up=full["w_up"][e],
                              w_gate=full["w_gate"][e], w_down=full["w_down"][e])
            params = {k: v.clone().requires_grad_() for k, v in params.items()}
            x = torch.from_numpy(inp["x"][rows]).requires_grad_()
            y, t, a = layers.moe_ffn(x, params, cfg, compute_dtype=torch.float32,
                                     rules=rules)
            # this rank's share of sum(y * cot) + 0.01 aux: the loss meant
            # is the mean of the ranks' shares
            (__DATA__ * torch.sum(y * cot) + 0.01 * a).backward()
            if case != "fsdp":
                auto = dataclasses.replace(cfg, dispatch="auto")
                with torch.no_grad():
                    y2, t2, a2 = layers.moe_ffn(x, params, auto,
                                                compute_dtype=torch.float32, rules=rules)
                assert torch.equal(y, y2) and torch.equal(t, t2) and torch.equal(a, a2)
            # the (token, expert) pairs past capacity among this rank's experts
            _, _, ids = router(x.detach().reshape(-1, x.shape[-1]), full["router"], 2)
            n_l = ids.shape[0]
            cap = min(max(int(phi * n_l * 2 / 8), 8), n_l)
            counts = torch.bincount(ids.reshape(-1), minlength=8)[e]
            out[case + "_out"], out[case + "_touched"] = y.detach().numpy(), t.numpy()
            out[case + "_aux"] = a.detach().numpy()
            out[case + "_dropped"] = np.int64((counts - cap).clamp(min=0).sum())
            for k, v in params.items():
                out[case + "_grad_" + k] = v.grad.numpy()
            out[case + "_grad_x"] = x.grad.numpy()

        with open(os.path.join(d, "model.pkl"), "rb") as f:
            params = pickle.load(f)
        experts = params["dense"]["blocks"]["moe"]
        for k in ("w_up", "w_gate", "w_down"):
            experts[k] = experts[k][:, 2 * j:2 * j + 2]   # (layers, this rank's experts, ...)
        params = tree_map(lambda a: torch.tensor(a, requires_grad=True), params)
        cfg = _module("olmoe-1b-7b").make_config(reduced=True)
        # aux_loss_coef 0: the loss whose gradient is held is the cross-entropy
        # (the reported ce and aux do not depend on the coefficient)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32, aux_loss_coef=0.0,
                                  moe=dataclasses.replace(cfg.moe, capacity_factor=__NODROP__))
        bt = slice(i * 2, (i + 1) * 2)
        batch = dict(tokens=torch.from_numpy(inp["tokens"][bt]),
                     labels=torch.from_numpy(inp["labels"][bt]))
        loss, aux = tf.train_loss(params, batch, cfg, lm_rules(mesh))
        loss.backward()  # through the differentiable all-reduces, every rank
        for path, p in flatten_with_path(params):
            out["model_grad_" + keystr(path)] = p.grad.numpy()
        grads_finite = all(bool(np.isfinite(v).all()) for k, v in out.items()
                           if k.startswith("model_grad_"))
        out["model_ce"], out["model_aux"] = aux["ce"].numpy(), aux["aux_loss"].numpy()
        for k, v in aux["touched"].items():
            out["model_touched_" + k] = v.numpy()
        np.savez(os.path.join(d, f"port{rank}.npz"), **out)
        print(json.dumps(dict(rank=rank, ok=True, margin=min(margins),
                              grads_finite=grads_finite)))
    finally:
        dist.destroy_process_group()
""")
for _k, _v in dict(DATA=DATA, MODEL=MODEL, B=B, CASES=CASES, NODROP=CASES["nodrop"]).items():
    _WORKER = _WORKER.replace(f"__{_k}__", repr(_v))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(d: pathlib.Path):
    """The shared numpy inputs: the reference's MoE params and olmoe's
    reduced train state, made from ``jax.random.key(0)``, and the tokens."""
    moe = ref_layers.MoEConfig(n_experts=8, top_k=2, d_ff=32, gated=True)
    p = ref_layers.moe_params_init(jax.random.key(0), 64, moe)
    rng = np.random.default_rng(0)
    bundle = ref_get_cell("olmoe-1b-7b", "train_4k", reduced=True)
    tokens = rng.integers(0, 512, (4, 64)).astype(np.int32)
    np.savez(d / "in.npz", x=rng.normal(size=(B, S, 64)).astype(np.float32),
             cot=rng.normal(size=(B, S, 64)).astype(np.float32),
             tokens=tokens, labels=((tokens + 1) % 512).astype(np.int32),
             **{k: np.asarray(v) for k, v in p.items()})
    with open(d / "model.pkl", "wb") as f:
        pickle.dump(_to_numpy(bundle.make_state(jax.random.key(0)))["params"], f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides run once for the file's tests: the reference's
    subprocess and the port's 8 ranks at once."""
    d = tmp_path_factory.mktemp("moe_ep")
    _inputs(d)
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=ROOT)]
    procs += [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(RANKS), port,
                                str(d)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True, env=env, cwd=ROOT)
              for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs[1:]]
    return (dict(np.load(d / "ref.npz")), ranks,
            [dict(np.load(d / f"port{r}.npz")) for r in range(RANKS)])


def test_routing_margins_and_ranks(runs):
    _, ranks, _ = runs
    assert [r["rank"] for r in ranks] == list(range(RANKS))
    for r in ranks:
        assert r["ok"] and r["grads_finite"]
        assert r["margin"] > MARGIN, r


@pytest.mark.parametrize("case", list(CASES))
def test_ep_layer_matches_reference_shard_map(runs, case):
    ref, ranks, port = runs
    assert min(r["margin"] for r in ranks) > MARGIN
    dropped = sum(int(port[r][case + "_dropped"]) for r in range(RANKS))
    if CASES[case] >= 4.0:
        assert dropped == 0
    else:
        assert dropped > 0, "the capacity factor meant to drop tokens dropped none"
    want = ref[case + "_out"].reshape(DATA, -1, S, 64)
    for r in range(RANKS):
        i = r // MODEL
        np.testing.assert_allclose(port[r][case + "_out"], want[i], rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(port[r][case + "_touched"], ref[case + "_touched"])
        np.testing.assert_allclose(port[r][case + "_aux"], ref[case + "_aux"], rtol=1e-6)
        # the model ranks of one batch shard hold one sum
        np.testing.assert_array_equal(port[r][case + "_out"], port[i * MODEL][case + "_out"])


def test_ep_model_loss_matches_reference(runs):
    ref, ranks, port = runs
    assert min(r["margin"] for r in ranks) > MARGIN
    coef = 0.01
    for r in range(RANKS):
        np.testing.assert_allclose(port[r]["model_aux"], ref["model_aux"], rtol=1e-5)
    ce = np.mean([float(port[i * MODEL]["model_ce"]) for i in range(DATA)])
    loss = ce + coef * float(port[0]["model_aux"])
    np.testing.assert_allclose(loss, float(ref["model_loss"]), rtol=1e-5)
    for k in ("moe_w_up", "moe_w_gate", "moe_w_down"):
        for r in range(RANKS):
            np.testing.assert_array_equal(port[r]["model_touched_" + k],
                                          ref["model_touched_" + k])
    union = np.any([port[r]["model_touched_tok_emb"] for r in range(RANKS)], axis=0)
    np.testing.assert_array_equal(union, ref["model_touched_tok_emb"])


def _combine(grads, holders):
    """The rule ``_moe_ep`` states: the sum of a gradient over the ranks
    that hold its parameter, over the world size."""
    return sum(grads[r] for r in holders) / RANKS


def _close(got, want, what):
    """Within 1e-5 of the gradient's largest entry (f32 sums in another
    order, over ranks and experts)."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_ep_layer_gradients_match_reference_shard_map(runs, case):
    ref, ranks, port = runs
    assert min(r["margin"] for r in ranks) > MARGIN
    g = lambda k: [port[r][f"{case}_grad_{k}"] for r in range(RANKS)]
    _close(_combine(g("router"), range(RANKS)), ref[case + "_grad_router"], "router")
    for k in ("w_up", "w_gate", "w_down"):
        want = ref[f"{case}_grad_{k}"]
        for r in range(RANKS):
            i, j = divmod(r, MODEL)
            e = slice(2 * j, 2 * j + 2)
            if case == "fsdp":    # one holder: rank (i, j) has d_model shard i
                h = (e, slice(i * 32, (i + 1) * 32)) if k != "w_down" else (
                    e, slice(None), slice(i * 32, (i + 1) * 32))
                _close(g(k)[r] / RANKS, want[h], f"{k} rank {r}")
            elif i == 0:          # held by the data ranks of model index j
                _close(_combine(g(k), [j, MODEL + j]), want[e], f"{k} experts of {j}")
    want = ref[case + "_grad_x"].reshape(DATA, -1, S, 64)
    for i in range(DATA):         # shard i is held by its model ranks
        _close(_combine(g("x"), range(i * MODEL, (i + 1) * MODEL)), want[i], f"x shard {i}")


def test_ep_model_gradients_match_reference(runs):
    ref, ranks, port = runs
    assert min(r["margin"] for r in ranks) > MARGIN
    keys = sorted(k for k in ref if k.startswith("model_grad_"))
    assert keys == sorted(k for k in port[0] if k.startswith("model_grad_"))
    for k in keys:
        grads = [port[r][k] for r in range(RANKS)]
        if "['moe']['w_" in k:    # (layers, experts, ...): experts j held by model index j
            got = np.concatenate([_combine(grads, [j, MODEL + j]) for j in range(MODEL)],
                                 axis=1)
        else:
            got = _combine(grads, range(RANKS))
        _close(got, ref[k], k)
