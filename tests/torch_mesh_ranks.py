"""The rank program of ``tests/test_torch_mesh.py``: it runs on every rank
of a 4-rank gloo group (``torch_shard_ranks.launch``) on the ``(2, 2)``
debug mesh, holds the meshed steps (``launch/train.py::meshed_step``) to
the one-process steps it computes itself, and raises on a mismatch (the
spawning test re-raises it).  No jax here: the spawned ranks import only
torch and the port; the spawning test holds the losses this program
writes (:func:`jax_steps`) to the JAX package's steps.

Every family's meshed step is tensor-parallel: each rank computes on
its shards.  :class:`Collectives` (a ``CommDebugMode``) records every
collective a step makes, with the largest tensor it touches and the
storage of every tensor it touches, so the checks can see that no step
gathers a model-sharded param whole and that no decode step hands a
cache or state leaf to a collective."""
import json
import os
import re
import time
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.checkpoint import latest_step, load_pytree
from repro_torch.configs import (TrainConfig, get_config, get_smoke_config,
                                 reduced)
from repro_torch.core.layerwise import layer_mask
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import (build_fl_bucketed_train_step,
                                      build_fl_train_step, build_prefill_step,
                                      build_serve_step, build_train_step,
                                      make_train_state)
from repro_torch.models.api import build as build_model
from repro_torch.models.api import extra_inputs
from repro_torch.optim.optimizers import adamw_init
from repro_torch.sharding.rules import (cache_specs, get_sharding_policy,
                                        map_with_path, placements,
                                        set_sharding_policy)
from repro_torch.tree import tree_leaves, tree_map

STEP = dict(rtol=1e-5, atol=1e-6)          # tests/test_shard.py's
ARCH = "phi3-mini-3.8b"
#: a MoE config: its load-balance loss is a product of token means, which
#: the meshed step must take over the whole batch
MOE_ARCH = "mixtral-8x22b"
#: the leaves whose gradient is a sum that cancels but for rounding: the
#: sLSTM's gate bias (its input gate's part, which the gate's stabilising
#: max cancels) and an attention's k projection bias (whisper's, in its
#: self- and cross-attention: it adds the same vector to every key,
#: which the softmax cancels, up to RoPE's rotation in self-attention).
#: Their elements whose one-process first moment is below AdamW's eps
#: take AdamW's step on rounding noise, which the two reduction orders
#: round differently: they are held by the moments at the step
#: tolerances and the params within 2 lr only
CANCELLING = r"(^slstm/b|/wk/b)$"
#: xLSTM (its mLSTM's row-parallel q/k/v, its sLSTM's whole time loop),
#: held under every policy; it takes no FL gates, nor do the families of
#: :data:`FAMILIES`
XLSTM_ARCH = "xlstm-1.3b"
#: the other families whose blocks are not only ``models/transformer.py``'s
#: (the Mamba2 hybrid, whisper, the VLM, with two KV heads for its four
#: query heads as its GQA), each under :data:`FAMILY_POLICIES` and the
#: policies named beside it: the VLM's GQA cross layer under
#: ``repeat_kv`` and ``attn_heads`` (its local KV heads), and the
#: hybrid's state under ``zero1``
FAMILIES = (("zamba2-1.2b", {}, ("zero1",)), ("whisper-medium", {}, ()),
            ("llama-3.2-vision-11b", {"num_kv_heads": 2},
             ("repeat_kv+attn_heads",)))
FAMILY_POLICIES = ("default", "act_seq", "attn_seq", "dp2d")
#: xLSTM's and these families' checks take one step each but for xLSTM's
#: default, as does :data:`XLSTM_UNEVEN`'s: the regions run whole in a
#: step, and the update of a second step from nonzero moments is
#: family-blind, held by the two-step cases; two steps of each family
#: are held to the JAX package's in :func:`jax_steps`
#: an xLSTM config whose heads do not divide the model axis (3 on 2): the
#: mLSTM's chunk scan runs on whole heads on every rank
XLSTM_UNEVEN = dict(d_model=192, num_heads=3)
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                   loss_chunk=8, remat="full")
#: the policies the meshed steps run under (zero1 on replicated weights,
#: and attn_heads with repeat_kv, as the reference pairs them)
POLICIES = {"default": {},
            "repeat_kv+attn_heads": {"repeat_kv": True, "attn_heads": True},
            "attn_seq": {"attn_seq": True}, "act_seq": {"act_seq": True},
            "block_gather": {"block_gather": True},
            "fsdp=False": {"fsdp": False},
            "zero1": {"fsdp": False, "zero1": True}, "dp2d": {"dp2d": True}}
DEFAULTS = dict(fsdp=True, act_model=True, repeat_kv=False, zero1=False,
                attn_seq=False, attn_heads=False, act_seq=False,
                block_gather=False, dp2d=False)
#: the smoke configs' overrides: two KV heads for four query heads, so
#: the grouped attention and ``repeat_kv``'s repeat are exercised
OVER = {"num_kv_heads": 2}
#: configs whose shapes the model axis does not split evenly: yi-34b's
#: smoke config with 3 query heads over 1 KV head (the q/k/v products'
#: columns shard mid-head, so the heads are gathered whole, as the
#: reference gathers yi-34b's 56 heads on 16), and mixtral's with 3
#: experts (the experts replicate over model, their FFN width shards)
UNEVEN = (("yi-34b", dict(d_model=192, num_heads=3, num_kv_heads=1,
                          head_dim=64)),
          (MOE_ARCH, dict(num_experts=3, num_kv_heads=2)))
#: the JAX comparison's steps (``tests/torch_lm.py::train_runs``'s
#: settings: 2 steps, B 4 x S 32)
JAX_TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       loss_chunk=16, remat="full")
#: the checkpoint run: two meshed steps of the train main's loop at its
#: ``--smoke --batch 4 --seq 16 --steps 3`` settings; the spawning test
#: resumes it to step 3 in one process
CKPT_ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
             "--seq", "16", "--steps", "3"]
CKPT_TCFG = TrainConfig(learning_rate=3e-4, warmup_steps=10, total_steps=3,
                        remat="full", loss_chunk=16)


def _batches(cfg, n, B=4, S=16, seed=1, fl=False):
    """``n`` batches from numpy draws, with the family's stub-frontend
    inputs (N(0, 1)); with ``fl``, four clients, one row each, on the
    smoke config's submodels 0, 1, 0, 1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int64))
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for k, (shape, dt) in extra_inputs(cfg, B, S).items():
            b[k] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dt)
        if fl:
            gates = torch.stack([layer_mask(cfg, i % 2, device="cpu")
                                 for i in range(B)], dim=1)
            b.update(layer_gates=gates, layer_counts=gates.sum(dim=1),
                     n_clients=float(B))
        out.append(b)
    return out


def _close(got, ref, what, **tol):
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   err_msg=what, **(tol or STEP))


def _same_state(meshed, one, lrs, what):
    """The gathered meshed state against the one-process state: the
    moments (the averaged gradients) at the step tolerances, the params
    within 2 lr per update (a param whose gradient sits at AdamW's eps
    moves by up to lr either way on a rounding of its gradient, as in
    ``tests/torch_lm.py::assert_trained_like_jax``) and all but a few of
    each param's elements at the step tolerances (an update that was
    never written back moves every element by about lr; in the leaves of
    :data:`CANCELLING`, of the elements whose gradient is not rounding
    noise), the step equal."""
    whole = T.gather_state(meshed)
    _close(whole["opt"]["mu"], one["opt"]["mu"], what)
    _close(whole["opt"]["nu"], one["opt"]["nu"], what)
    _close(whole["params"], one["params"], what, rtol=0,
           atol=2.0 * sum(lrs))
    paths = tree_leaves(map_with_path(lambda p, t: p, one["params"]))
    for path, a, b, mu in zip(paths, tree_leaves(whole["params"]),
                              tree_leaves(one["params"]),
                              tree_leaves(one["opt"]["mu"])):
        a, b = a.detach().numpy(), b.detach().numpy()
        off = ~np.isclose(a, b, **STEP)
        if re.search(CANCELLING, path):
            off &= np.abs(mu.numpy()) >= TCFG.eps
        assert np.mean(off) < 1e-4, (what, path)
    assert whole["opt"]["step"] == one["opt"]["step"] == len(lrs)
    return whole


def _check_shards(state, mesh, what, whole=None):
    """Every ``DTensor`` of the state holds the slice its placements name
    (``distribute_tensor``'s own slicing of the gathered tensor,
    ``whole`` where the caller has it)."""
    whole = T.gather_state(state) if whole is None else whole
    for t, w in zip(tree_leaves(state), tree_leaves(whole)):
        if isinstance(t, DTensor):
            ref = distribute_tensor(w, mesh, t.placements,
                                    src_data_rank=None).to_local()
            assert torch.equal(t.to_local(), ref), what


def _data_sharded(tree):
    """Leaves placed on the ``data`` mesh dim (dim 0 of the debug mesh)."""
    return sum(isinstance(t.placements[0], Shard) for t in tree_leaves(tree))


def _storage(t):
    """The address of ``t``'s storage (a ``DTensor``'s local tensor's)."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    try:
        return t.untyped_storage().data_ptr()
    except RuntimeError:              # a wrapper without storage
        return 0


class Collectives(CommDebugMode):
    """``CommDebugMode``'s dispatch of collectives (``DTensor`` ops
    desugared first, the functional and ``torch.distributed`` collectives
    it registers), keeping for each its op, its process group's name (a
    functional collective's; ``"c10d"`` for a ``torch.distributed`` call,
    whose group it does not name), the element count of the largest
    tensor among its inputs and outputs, and its bytes (that tensor's).
    Its per-op module bookkeeping, which nothing here reads, is skipped:
    it doubled a meshed step's time."""

    def __init__(self):
        super().__init__()
        self.seen = []
        #: the storages of every tensor a collective touched
        self.storages = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t == DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        packet = func._overloadpacket
        if packet in self.comm_registry or packet in c10d_collective_ops:
            leaves = tree_flatten((args, kwargs, out))[0]
            tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
            big = max(tensors, key=lambda t: t.numel(), default=None)
            group = ("c10d" if packet in c10d_collective_ops else
                     [a for a in leaves if isinstance(a, str)][-1])
            self.seen.append((str(packet).split(".")[-1], group,
                              0 if big is None else big.numel(),
                              0 if big is None else
                              big.numel() * big.element_size()))
            self.storages.update(_storage(t) for t in tensors)
        return out


def _model_sharded(tree, mesh):
    """The param leaves that ``model`` shards."""
    i = mesh.mesh_dim_names.index("model")
    return [t for t in tree_leaves(tree)
            if isinstance(t, DTensor) and t.placements[i].is_shard()]


def _no_whole_gather(params, seen, mesh, what):
    """No collective over the model axis (and no ``torch.distributed``
    call, whose group the record does not name) touches a tensor as large
    as one matrix of a model-sharded param (one layer's; a stacked
    leaf's trailing two dims): gathering one whole would.  The FSDP
    gathers run over ``data``; the model axis carries only activations
    and their gradients."""
    whole = min(t.shape[-2] * t.shape[-1]
                for t in _model_sharded(params, mesh))
    model = mesh.get_group("model").group_name
    big = [s for s in seen if s[1] in (model, "c10d") and s[2] >= whole]
    assert seen and not big, (what, whole, big)


def _check_local_sizes(params, mesh, what):
    """Each leaf's local tensor holds its share of the whole: half of a
    model-sharded leaf on the model axis, halved again where ``data``
    shards it too."""
    for t in tree_leaves(params):
        n = 1
        for i, p in enumerate(t.placements):
            n *= mesh.size(i) if p.is_shard() else 1
        assert t.to_local().numel() * n == t.numel(), what
    for t in _model_sharded(params, mesh):
        assert t.to_local().numel() * 2 <= t.numel(), what


#: the one-process steps by (config, step kind, repeat_kv, steps): the
#: other knobs steer only the mesh
_ONE = {}


def _run(build, cfg, mesh, batches, tcfg=TCFG):
    """Steps one process and meshed, from the same init: (the
    one-process state, metrics; the meshed state, metrics; the meshed
    steps' collectives, :class:`Collectives`' records)."""
    model, step = build(cfg, tcfg)[:2]
    key = (cfg, build, get_sharding_policy()["repeat_kv"], len(batches))
    if key not in _ONE:
        one = make_train_state(model, torch.Generator().manual_seed(0),
                               tcfg)
        m1 = []
        for b in batches:
            one, m = step(one, b)
            m1.append((float(m["loss"]), float(m["grad_norm"]),
                       float(m["lr"])))
        _ONE[key] = one, m1
    one, m1 = _ONE[key]
    meshed = T.place_state(
        make_train_state(model, torch.Generator().manual_seed(0), tcfg), mesh)
    run = T.meshed_step(step, mesh)
    m2, seen = [], []
    for b in batches:
        with Collectives() as rec:
            meshed, m = run(meshed, b)
        seen += rec.seen
        m2.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
    return one, m1, meshed, m2, seen


def _step_checks(cfg, mesh, pol, name, fl, steps=2):
    """``steps`` meshed steps (train or masked FL) against the
    one-process steps: metrics, state, shards and the policy's FSDP and
    moments, each rank's local sizes and no collective as large as a
    model-sharded param."""
    set_sharding_policy(**DEFAULTS)
    set_sharding_policy(**pol)
    what = f"{cfg.name} {'fl' if fl else 'train'} {name}"
    build = build_fl_train_step if fl else build_train_step
    try:
        one, m1, meshed, m2, seen = _run(
            build, cfg, mesh,
            _batches(cfg, steps, seed=3 if fl else 1, fl=fl))
        np.testing.assert_allclose(m2, m1, rtol=1e-5, err_msg=what)
        whole = _same_state(meshed, one, [m[2] for m in m1], what)
        _check_shards(meshed, mesh, what, whole)
        _check_local_sizes(meshed["params"], mesh, what)
        _no_whole_gather(meshed["params"], seen, mesh, what)
        fsdp = _data_sharded(meshed["params"])
        moments = _data_sharded(meshed["opt"]["mu"])
        if pol.get("fsdp", True):
            assert fsdp and moments == fsdp, what
        else:
            assert fsdp == 0 and bool(moments) == pol.get("zero1", False), \
                what
    finally:
        set_sharding_policy(**DEFAULTS)


class Peak(TorchDispatchMode):
    """The largest tensor, and the most bytes of CPU tensor storage alive
    at once, among what the ops under it make (a ``DTensor`` by its local
    tensor; views by their base's storage)."""

    def __init__(self):
        super().__init__()
        self.bytes, self.refs = {}, {}
        self.now = self.peak = self.largest = 0

    def _drop(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            self.now -= self.bytes.pop(key)
            del self.refs[key]

    def _track(self, t):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor) or t.is_meta:
            return
        try:
            st = t.untyped_storage()
            key = st.data_ptr()
        except RuntimeError:           # a wrapper without storage
            return
        if not key:
            return
        self.largest = max(self.largest, t.numel())
        if key not in self.bytes:
            self.bytes[key], self.refs[key] = st.nbytes(), 0
            self.now += st.nbytes()
            self.peak = max(self.peak, self.now)
        self.refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            self._track(t)
        return out


def _state_bytes(state, local):
    """The params' and moments' bytes: each rank's shards, or whole."""
    return sum((t.to_local() if local else t).numel() * t.element_size()
               for t in tree_leaves([state["params"], state["opt"]["mu"],
                                     state["opt"]["nu"]]))


def _sharded_build_checks(cfg, mesh):
    """``sharded_train_state`` equals ``place_state`` of the one-process
    state bit for bit; it holds at most its shards plus one whole leaf
    (with its initialiser's float32 draw) at once, far below the whole
    state; and ``train()`` on the mesh makes no tensor larger than the
    state's largest leaf."""
    model = build_model(cfg)
    with Peak() as peak:
        state = T.sharded_train_state(model, torch.device("cpu"), mesh)
    ref = T.place_state(
        make_train_state(model, torch.Generator().manual_seed(0), TCFG),
        mesh)
    for a, b in zip(tree_leaves(state), tree_leaves(ref)):
        if isinstance(a, int):
            assert a == b
            continue
        assert a.placements == b.placements
        assert torch.equal(a.to_local(), b.to_local())
    leaf = max(t.numel() for t in tree_leaves(ref["params"]))
    bound = _state_bytes(state, True) + 2 * 4 * leaf
    assert peak.peak <= bound < _state_bytes(ref, False) / 2, \
        (peak.peak, bound, _state_bytes(ref, False))
    assert peak.largest <= leaf, (peak.largest, leaf)
    with Peak() as peak:
        T.train(cfg, CKPT_TCFG, batch=4, seq=16, steps=1,
                device=torch.device("cpu"), mesh=mesh)
    assert peak.largest <= leaf, (peak.largest, leaf)


def _bucket_major(batch, nb):
    return {k: torch.stack([batch[k][b::nb] for b in range(nb)])
            for k in ("tokens", "labels")}


#: the archs whose meshed steps :func:`jax_steps` runs from the JAX
#: package's params, and under which policies (the spawning test writes
#: each arch's inputs while the ranks run their other checks; a rank
#: waits for them up to ``JAX_WAIT`` seconds)
JAX_WAIT = 300.0
JAX_ARCHS = ((ARCH, ("default", "dp2d")), (MOE_ARCH, ("default", "dp2d")),
             (XLSTM_ARCH, ("default",))) + tuple(
                 (arch, ("default",)) for arch, _, _ in FAMILIES)


def jax_steps(mesh, jax_dir):
    """The meshed train steps of each arch's smoke config from the params
    and batches the spawning test writes (``tests/torch_lm.py::
    train_runs``' inputs, converted from the JAX package's), under the
    policies of :data:`JAX_ARCHS`: their losses and grad norms, written
    by rank 0 for the test to hold to the JAX package's steps."""
    out = {}
    for arch, names in JAX_ARCHS:
        path = f"{jax_dir}/{arch}.pt"
        deadline = time.monotonic() + JAX_WAIT
        while not os.path.exists(path):
            assert time.monotonic() < deadline, f"no {path}"
            time.sleep(0.1)
        saved = torch.load(path)
        cfg = get_smoke_config(arch)
        for name in names:
            set_sharding_policy(**POLICIES[name])
            try:
                _, step = build_train_step(cfg, JAX_TCFG)
                params = tree_map(lambda t: t.clone(), saved["params"])
                state = T.place_state(
                    {"params": params, "opt": adamw_init(params)}, mesh)
                run = T.meshed_step(step, mesh)
                rows = []
                for b in saved["batches"]:
                    state, m = run(state, b)
                    rows.append((float(m["loss"]), float(m["grad_norm"])))
                out[f"{arch} {name}"] = rows
            finally:
                set_sharding_policy(**DEFAULTS)
    if dist.get_rank() == 0:
        with open(f"{jax_dir}/meshed.json", "w") as f:
            json.dump(out, f)


def _loop_collectives(mesh):
    """The collectives of one meshed xLSTM train step at S 8 and at S 16
    (one loss chunk and one mLSTM chunk at both): equal in number and
    kind, so none runs inside the sLSTM's time loop."""
    cfg = reduced(get_config(XLSTM_ARCH))
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       loss_chunk=16, remat="full")
    model, step = build_train_step(cfg, tcfg)
    counts = []
    for S in (8, 16):
        state = T.sharded_train_state(model, torch.device("cpu"), mesh)
        with Collectives() as rec:
            T.meshed_step(step, mesh)(state, _batches(cfg, 1, S=S)[0])
        counts.append(sorted((s[0], s[1]) for s in rec.seen))
    assert counts[0] and counts[0] == counts[1], counts


#: the meshed prefill and decode cases: (label, arch, the smoke config's
#: overrides, the cache length, {cache leaf: the dim that ``model``
#: shards, None where it is whole on the model axis}, the sharding
#: policies), each layout of ``rules.cache_specs`` on the (2, 2) mesh
#: (``tests/test_torch_mesh.py`` holds these layouts to the reference's
#: ``cache_specs``): KV heads (phi3-mini with :data:`OVER`, also under
#: ``repeat_kv+attn_heads``); the cache rows and the head dim (yi-34b's
#: :data:`UNEVEN` config, one KV head, at an even and an odd cache
#: length); the MoE gather on expert shards and on FFN-width shards
#: (mixtral with 4 and 3 experts, and the batch through the capacity
#: region); xLSTM on heads and on the mLSTM's key dim
#: (:data:`XLSTM_UNEVEN`); the Mamba2 state's conv channels and heads
#: with the shared site's KV heads (zamba2); whisper's self and cross
#: caches on heads; the VLM's self cache on its rows and its cross cache
#: on the head dim (one KV head, 15 image tokens)
KV = ("k", "v")
DECODE = (
    ("heads", ARCH, OVER, 16, dict.fromkeys(KV, 3),
     ("default", "repeat_kv+attn_heads")),
    ("rows", UNEVEN[0][0], UNEVEN[0][1], 16, dict.fromkeys(KV, 2),
     ("default",)),
    ("head_dim", UNEVEN[0][0], UNEVEN[0][1], 15, dict.fromkeys(KV, 4),
     ("default",)),
    ("experts", MOE_ARCH, OVER, 16, dict.fromkeys(KV, 3), ("default",)),
    ("ffn width", UNEVEN[1][0], UNEVEN[1][1], 16, dict.fromkeys(KV, 3),
     ("default",)),
    ("dispatch", UNEVEN[1][0], dict(UNEVEN[1][1], moe_decode_impl="dispatch"),
     16, dict.fromkeys(KV, 3), ("default",)),
    ("xlstm heads", XLSTM_ARCH, {}, 16,
     {"mlstm/0": 2, "mlstm/1": 2, "mlstm/2": 2, "slstm/0": 2, "slstm/3": 2},
     ("default",)),
    ("xlstm dk", XLSTM_ARCH, XLSTM_UNEVEN, 16,
     {"mlstm/0": 3, "mlstm/1": 3, "mlstm/2": None, "slstm/0": 2,
      "slstm/3": 2}, ("default",)),
    ("zamba2", "zamba2-1.2b", {}, 16,
     {"mamba/ssm": 2, "mamba/conv": 3, "attn/k": 3, "attn/v": 3},
     ("default",)),
    ("whisper", "whisper-medium", {}, 16,
     {"self/k": 3, "self/v": 3, "cross/k": 3, "cross/v": 3}, ("default",)),
    ("vlm", "llama-3.2-vision-11b",
     {"num_kv_heads": 1, "num_image_tokens": 15}, 16,
     {"self/k": 3, "self/v": 3, "cross/k": 4, "cross/v": 4}, ("default",)))
#: the meshed decode's logits and cache against the one-process
#: decode's: STEP's rtol, and an atol above float32's rounding of the
#: row-parallel sums' order on values near zero (1.4e-6 seen at d 256)
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
#: the decode cases' batch, prefill length and decode steps; the steps
#: start two slots before the cache's end, so that they wrap its ring
DECODE_SHAPE = (4, 8, 4)
#: the decode runs held to the JAX package's (``tests/torch_lm.py::
#: decode_runs``' settings, its B 2 x S 12): arch, overrides
JAX_DECODE = ((ARCH, OVER), (XLSTM_ARCH, XLSTM_UNEVEN))


def _model_dim(t, mesh):
    p = t.placements[mesh.mesh_dim_names.index("model")]
    return p.dim if p.is_shard() else None


def _decode_case(mesh, label, arch, over, clen, layout, pol):
    """A meshed prefill and :data:`DECODE_SHAPE`'s decode steps of one
    :data:`DECODE` case under ``pol`` against the one-process steps
    (logits at :data:`STEP`, tokens equal): the cache built sharded in
    ``rules.cache_specs``' placements with ``layout`` on the model axis;
    after the steps every leaf keeps its placements and its storage and
    holds the one-process cache's values; no collective of a decode step
    touches a cache leaf's storage (none is gathered), and none over the
    model axis is as large as the smallest model-sharded param or KV
    cache shard."""
    what = f"decode {label} {pol}"
    B, S, steps = DECODE_SHAPE
    cfg = reduced(get_config(arch), **over)
    set_sharding_policy(**DEFAULTS)
    set_sharding_policy(**POLICIES[pol])
    try:
        model, prefill = build_prefill_step(cfg)
        _, serve = build_serve_step(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        batch = _batches(cfg, 1, B=B, S=S, seed=9)[0]
        batch.pop("labels")
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        one = prefill(params, batch)
        mp = T.sharded_train_state(model, torch.device("cpu"), mesh)["params"]
        got = T.meshed_prefill_step(prefill, mesh)(mp, batch)
        _close(got, one, what + " prefill", **DECODE_TOL)
        cache1 = model.decode_init(params, B, clen, extras=extras)
        cache = T.sharded_decode_cache(model, mp, B, clen, mesh,
                                       extras=extras)
        specs = T._by_path(cache_specs(cache1, mesh))
        leaves = {}
        map_with_path(lambda path, t: leaves.setdefault(path, t), cache)
        assert set(leaves) == set(specs), what
        for path, t in leaves.items():
            assert t.placements == placements(specs[path], mesh), \
                (what, path)
        for path, dim in layout.items():
            assert _model_dim(leaves[path], mesh) == dim, (what, path)
        if cfg.num_experts:
            w = mp["blocks"]["moe"]["w_gate"]
            assert _model_dim(w, mesh) == (1 if label == "experts" else 3)
        kept = {p: (t.placements, t.to_local().data_ptr())
                for p, t in leaves.items()}
        stores = {_storage(t) for t in leaves.values()}
        model_sharded = _model_sharded(mp, mesh) + [
            t for p, t in leaves.items()
            if p.split("/")[-1] in KV and _model_dim(t, mesh) is not None]
        least = min(t.to_local().numel() for t in model_sharded)
        name = mesh.get_group("model").group_name
        run = T.meshed_serve_step(serve, mesh)
        tok = torch.argmax(one[:, -1], dim=-1).to(torch.int32)[:, None]
        for i in range(steps):
            pos = clen - 2 + i
            t1, cache1, l1 = serve(params, cache1, tok, pos, logits=True)
            with Collectives() as rec:
                t2, cache, l2 = run(mp, cache, tok, pos, logits=True)
            _close(l2.full_tensor(), l1, f"{what} step {i}", **DECODE_TOL)
            assert torch.equal(t2, t1), (what, i)
            big = [c for c in rec.seen if c[1] in (name, "c10d")
                   and c[2] >= least]
            assert rec.seen and not big, (what, least, big)
            assert not rec.storages & stores, what
            tok = t1
        for path, t in leaves.items():
            assert (t.placements, t.to_local().data_ptr()) == kept[path], \
                (what, path)
        _close(T.gather_state(cache), cache1, what + " cache", **DECODE_TOL)
    finally:
        set_sharding_policy(**DEFAULTS)


def decode_checks(mesh):
    """Every :data:`DECODE` case under its policies."""
    for label, arch, over, clen, layout, pols in DECODE:
        for pol in pols:
            _decode_case(mesh, label, arch, over, clen, layout, pol)


def jax_decode(mesh, jax_dir):
    """The meshed decode of :data:`JAX_DECODE`'s configs from the params,
    tokens and stub inputs the spawning test writes (``tests/torch_lm.py::
    decode_runs``' inputs, converted from the JAX package's), teacher
    forced from position 0 over a cache of the tokens' length: their
    logits and next tokens, written by rank 0 for the test to hold to the
    JAX package's decode."""
    out = {}
    for arch, over in JAX_DECODE:
        path = f"{jax_dir}/{arch}-decode.pt"
        deadline = time.monotonic() + JAX_WAIT
        while not os.path.exists(path):
            assert time.monotonic() < deadline, f"no {path}"
            time.sleep(0.1)
        saved = torch.load(path)
        cfg = reduced(get_config(arch), **over)
        model, serve = build_serve_step(cfg)
        toks = saved["tokens"]
        B, S = toks.shape
        params = T.place_state({"params": saved["params"],
                                "opt": adamw_init(saved["params"])},
                               mesh)["params"]
        cache = T.sharded_decode_cache(model, params, B, S, mesh,
                                       extras=saved["extras"])
        run = T.meshed_serve_step(serve, mesh)
        logits, nxt = [], []
        for t in range(S):
            tok, cache, lg = run(params, cache, toks[:, t:t + 1], t,
                                 logits=True)
            logits.append(lg.full_tensor()[:, 0])
            nxt.append(tok[:, 0])
        out[arch] = (torch.stack(logits, 1), torch.stack(nxt, 1))
    if dist.get_rank() == 0:
        torch.save(out, f"{jax_dir}/meshed-decode.pt")


def mesh_steps(rank, ckpt_dir, jax_dir):
    """The builders' refusals; the tensor-parallel train and masked FL
    steps of phi3-mini's and mixtral's smoke configs (two KV heads)
    under every policy, the :data:`UNEVEN` configs', the bucketed FL
    step, xLSTM's train step under every policy and with heads that do
    not divide the model axis, and the :data:`FAMILIES`' train steps
    under :data:`FAMILY_POLICIES` and their own, against the one-process
    steps (:func:`_step_checks`); no collective in the sLSTM loop
    (:func:`_loop_collectives`); the leaf-by-leaf state build
    (:func:`_sharded_build_checks`); the meshed prefill and decode of
    :data:`DECODE` (:func:`decode_checks`); the meshed steps and decode
    from the JAX package's params (:func:`jax_steps`,
    :func:`jax_decode`); the checkpoint run."""
    for build, need in ((lambda: make_production_mesh(), 256),
                        (lambda: make_production_mesh(multi_pod=True), 512),
                        (lambda: make_debug_mesh(multi_pod=True), 8)):
        try:
            build()
        except ValueError as e:
            assert f"needs {need} ranks" in str(e) and "has 4" in str(e)
        else:
            raise AssertionError(f"a {need}-rank mesh built on 4 ranks")
    mesh = make_debug_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    for arch in (ARCH, MOE_ARCH):
        cfg = reduced(get_config(arch), **OVER)
        for name, pol in POLICIES.items():
            for fl in (False, True):
                _step_checks(cfg, mesh, pol, name, fl)
    for arch, over in UNEVEN:
        cfg = reduced(get_config(arch), **over)
        for fl in (False, True):
            _step_checks(cfg, mesh, {}, "default", fl)
    cfg = reduced(get_config(XLSTM_ARCH))
    for name, pol in POLICIES.items():
        _step_checks(cfg, mesh, pol, name, False,
                     steps=2 if name == "default" else 1)
    _step_checks(reduced(get_config(XLSTM_ARCH), **XLSTM_UNEVEN), mesh, {},
                 "default", False, steps=1)
    for arch, over, more in FAMILIES:
        cfg = reduced(get_config(arch), **over)
        for name in FAMILY_POLICIES + more:
            _step_checks(cfg, mesh, POLICIES[name], name, False, steps=1)
    _loop_collectives(mesh)
    cfg = reduced(get_config(ARCH), **OVER)
    one, m1, meshed, m2, _ = _run(
        build_fl_bucketed_train_step, cfg, mesh,
        [_bucket_major(b, 2) for b in _batches(cfg, 2, seed=5)])
    np.testing.assert_allclose(m2, m1, rtol=1e-5, err_msg="bucketed")
    _same_state(meshed, one, [m[2] for m in m1], "bucketed")
    _sharded_build_checks(cfg, mesh)
    decode_checks(mesh)
    jax_steps(mesh, jax_dir)
    jax_decode(mesh, jax_dir)

    cfg = get_smoke_config(ARCH)
    out = T.train(cfg, CKPT_TCFG, batch=4, seq=16, steps=2,
                  device=torch.device("cpu"), mesh=mesh, ckpt_dir=ckpt_dir)
    whole = T.gather_state(out["state"])
    saved = load_pytree(latest_step(ckpt_dir), T._on_disk(whole))
    for a, b in zip(tree_leaves(saved["params"]),
                    tree_leaves(whole["params"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(saved["opt"]["step"]) == 2
    dist.barrier()
