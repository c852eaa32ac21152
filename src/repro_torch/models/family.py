"""The model-family protocol, its layer-wise implementation and the
registry — port of ``repro.models.family``.

* :class:`ModelFamily` (``family.py:97-227``): the surface the FL stack
  reads, so ``repro_torch.fl`` and ``repro_torch.core.aggregation`` never
  import a concrete architecture.
* :class:`LayerwiseFamily` (``family.py:229-460``): all of it for
  parameters in the canonical layer-wise layout ``{"stem": tree,
  "stages": [stage_0, ...], "exits": [exit_0, ...]}``; submodel m trains
  stem + stages[:m+1] + exits[:m+1].  Aggregation groups are stem + each
  stage + each exit, flattened for the stacked ``layer_agg`` path in
  ``tree_leaves`` order (sorted dict keys, as ``jax.tree.leaves``).
  Subclasses supply ``init`` (from a ``torch.Generator``),
  ``apply_all_exits``, ``num_submodels`` and ``flops_per_sample``.
* the registry (``family.py:464-509``): :func:`register_family`,
  :func:`known_families`, :func:`get_family` and :func:`resolve_family`.
  The builtins, registered at import: ``cnn`` (:mod:`repro_torch.models.cnn`,
  the one with the HeteroFL/ScaleFL width slices), ``mlp``
  (:mod:`repro_torch.models.mlp`) and ``transformer``
  (:mod:`repro_torch.models.transformer_family`).

Client training has two forms: the bucket programs of
:mod:`repro_torch.fl.batch` (every participant of a submodel at once) and
:meth:`LayerwiseFamily.client_update` / :meth:`LayerwiseFamily.train_steps`,
one client's SGD loop, the per-client executor's (``family.py:275-437``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.core.baselines import kd_loss
from repro_torch.data.loader import client_schedule
from repro_torch.tree import tree_leaves, tree_map, tree_shapes, \
    tree_unflatten_like


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch axis, logits [..., B, C] and integer labels
    [..., B] (log-sum-exp form): a scalar for one batch, [P] for P
    stacked batches."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, y[..., None].long())[..., 0]
    return torch.mean(lse - tgt, dim=-1)


class ModelFamily:
    """What the FL stack reads from a model.  Families are registered
    singletons: they own their mask, template and cost caches."""

    #: registry key / display name
    name: str = "abstract"
    #: FL methods (client-update kinds) this family can train
    supported_methods: Tuple[str, ...] = ()
    #: image size the paper-scale energy model is calibrated at
    ref_hw: int = 32
    #: the bucket program's route (:mod:`repro_torch.fl.batch`).  False:
    #: ``vmap`` over participants of ``grad`` of the one-participant loss.
    #: True: the family's forward takes the participant axis written out
    #: (``apply_all_exits_stacked`` on trees with leaves [P, ...] and
    #: batches [P, B, ...]) and plain autograd differentiates it, as
    #: kernels bound through ctypes need: ``torch.func`` transforms cannot
    #: see inside them.
    stacked_forward: bool = False

    # -- model surface ---------------------------------------------------
    def init(self, gen: torch.Generator, num_classes: int = 10,
             width_mult: float = 1.0, hw: int = 32):
        raise NotImplementedError

    def num_submodels(self) -> int:
        raise NotImplementedError

    def apply_all_exits(self, params, x):
        """Logits from every exit held by ``params`` (truncated trees ok)."""
        raise NotImplementedError

    def flops_per_sample(self, model_idx: int, image_hw: int = 32,
                         width_mult: float = 1.0) -> float:
        """Analytic forward FLOPs for Model_{idx+1} (energy-model input)."""
        raise NotImplementedError

    def param_shapes(self, num_classes: int = 10, width_mult: float = 1.0,
                     hw: int = 32):
        """The parameter tree as meta tensors (shapes and dtypes, no
        storage).  Default: one ``init`` at seed 0; families that can
        build the tree without drawing weights override it."""
        return tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
            self.init(torch.Generator().manual_seed(0), num_classes,
                      width_mult=width_mult, hw=hw))

    # -- data surface ------------------------------------------------------
    def make_dataset(self, n: int, num_classes: int = 10, hw: int = 32,
                     noise: float = 1.0, seed: int = 0):
        """The training corpus ``(x, y)`` (numpy; rows are samples, ``y``
        the class).  Default: the synthetic image set, ``x [n, hw, hw, 3]``
        float32 (``family.py:128-138``); token families override it."""
        from repro_torch.data.synthetic import synthetic_image_dataset
        return synthetic_image_dataset(n, num_classes, hw=hw, noise=noise,
                                       seed=seed)

    # -- submodel structure, aggregation layout, training, cost ----------
    def submodel_tree(self, tree, model_idx: int):
        raise NotImplementedError

    def submodel_params(self, method: str, global_params, model_idx: int):
        raise NotImplementedError

    def submodel_size_bytes(self, params, model_idx: int) -> int:
        raise NotImplementedError

    def update_mask(self, global_params, model_idx: int, scale: float = 1.0):
        raise NotImplementedError

    def stack_groups(self, params) -> List:
        raise NotImplementedError

    def held_groups(self, global_params, model_idx: int) -> List[bool]:
        raise NotImplementedError

    def unstack_groups(self, global_params, groups: List):
        raise NotImplementedError

    def stack_template(self, global_params, seg: int = 1024):
        raise NotImplementedError

    def loss_fn(self, method: str) -> Callable:
        raise NotImplementedError

    def client_update(self, method: str, global_params, model_idx: int,
                      x, y, *, epochs: int = 5, batch: int = 32,
                      lr: float = 0.05, seed: int = 0):
        raise NotImplementedError

    def cost_model(self, num_classes: int = 10
                   ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        """(submodel bytes, FLOP fractions) at paper scale (width 1.0,
        ``ref_hw`` images): what the Eq. 5/7 energy accounting charges."""
        raise NotImplementedError

    # -- factored MARL state ----------------------------------------------
    def state_summary_width(self, n_bins: Optional[int] = None) -> int:
        """Width of this family's factored QMIX state
        (:func:`repro_torch.core.fleet.summary_width` over its submodel
        count), whatever the fleet's size."""
        from repro_torch.core import fleet as core_fleet
        bins = core_fleet.SUMMARY_BINS if n_bins is None else n_bins
        return core_fleet.summary_width(self.num_submodels(), bins)

    def fleet_summary(self, fleet, round_idx=0, n_rounds: int = 1, *,
                      num_classes: int = 10, local_epochs: int = 5,
                      batch_size: int = 32):
        """:func:`repro_torch.core.fleet.fleet_summary` priced with this
        family's paper-scale cost model."""
        from repro_torch.core import fleet as core_fleet
        sizes, fractions = self.cost_model(num_classes)
        return core_fleet.fleet_summary(fleet, sizes, fractions, round_idx,
                                        n_rounds, local_epochs, batch_size)

    def supports(self, method: str) -> bool:
        return method in self.supported_methods

    def unsupported(self, method: str) -> ValueError:
        """The reference's error for a method this family lacks."""
        return ValueError(f"family {self.name!r} does not support method "
                          f"{method!r} (supported: {self.supported_methods})")

    def __repr__(self):
        return f"<ModelFamily {self.name!r}>"


class LayerwiseFamily(ModelFamily):
    """Generic machinery over the canonical layer-wise tree; subclasses
    supply ``init``, ``apply_all_exits``, ``num_submodels`` and
    ``flops_per_sample`` (and, with ``stacked_forward``,
    ``apply_all_exits_stacked``, which ``stacked_loss_fn``
    differentiates)."""

    supported_methods = ("drfl",)

    def __init__(self):
        # masks depend only on the tree's shapes, its device and
        # (model_idx, scale); their 0-d leaves are never written
        self._mask_cache: dict = {}
        self._template_cache: dict = {}
        self._cost_cache: dict = {}

    # -- submodel structure ----------------------------------------------
    def submodel_tree(self, tree, model_idx: int):
        return {"stem": tree["stem"],
                "stages": tree["stages"][:model_idx + 1],
                "exits": tree["exits"][:model_idx + 1]}

    def submodel_params(self, method: str, global_params, model_idx: int):
        if method == "drfl":
            return self.submodel_tree(global_params, model_idx)
        raise self.unsupported(method)

    def _size_tree(self, params, model_idx: int):
        """What a Model_{idx+1} client holds: depth prefix + ITS exit."""
        return {"stem": params["stem"],
                "stages": params["stages"][:model_idx + 1],
                "exits": [params["exits"][model_idx]]}

    def submodel_size_bytes(self, params, model_idx: int) -> int:
        return sum(l.numel() * l.element_size()
                   for l in tree_leaves(self._size_tree(params, model_idx)))

    # -- aggregation layout ----------------------------------------------
    def update_mask(self, global_params, model_idx: int, scale: float = 1.0):
        """0-d float32 masks over the layer-wise tree: ``scale`` (1.0, or a
        staleness alpha) on the stem, stages <= m and exits <= m, 0.0 on
        the rest — the reference's masks, on the params' device."""
        dev = tree_leaves(global_params)[0].device
        key = (tree_shapes(global_params), str(dev), int(model_idx),
               float(scale))
        hit = self._mask_cache.get(key)
        if hit is not None:
            return hit

        def const(tree, v):
            t = torch.tensor(v, dtype=torch.float32, device=dev)
            return tree_map(lambda _: t, tree)
        mask = {"stem": const(global_params["stem"], scale),
                "stages": [const(st, scale if i <= model_idx else 0.0)
                           for i, st in enumerate(global_params["stages"])],
                "exits": [const(e, scale if i <= model_idx else 0.0)
                          for i, e in enumerate(global_params["exits"])]}
        if len(self._mask_cache) > 512:     # staleness scales are open-ended
            self._mask_cache.clear()
        self._mask_cache[key] = mask
        return mask

    def stack_groups(self, params) -> List:
        return ([params["stem"]] + list(params["stages"])
                + list(params["exits"]))

    def held_groups(self, global_params, model_idx: int) -> List[bool]:
        held = [i <= model_idx for i in range(len(global_params["stages"]))]
        return [True] + held + held

    def unstack_groups(self, global_params, groups: List):
        n_stages = len(global_params["stages"])
        return {"stem": groups[0],
                "stages": groups[1:1 + n_stages],
                "exits": groups[1 + n_stages:]}

    def stack_template(self, global_params, seg: int = 1024):
        key = (tree_shapes(global_params), int(seg))
        if key not in self._template_cache:
            self._template_cache[key] = aggregation.build_stack_template(
                self.stack_groups(global_params), seg=seg)
        return self._template_cache[key]

    # -- losses and evaluation -------------------------------------------
    @staticmethod
    def _joint_ce(outs, y):
        """Joint CE over every held exit: weight 1.0 on the deepest, 0.3 on
        the others, normalised (``family.py:327-335``)."""
        loss = cross_entropy(outs[-1], y)
        for o in outs[:-1]:
            loss = loss + 0.3 * cross_entropy(o, y)
        return loss / (1.0 + 0.3 * (len(outs) - 1))

    def _drfl_loss(self, sub, x, y):
        return self._joint_ce(self.apply_all_exits(sub, x), y)

    def _slice_loss(self, sub, x, y):
        """Width-sliced trees (HeteroFL): CE at the deepest exit."""
        return cross_entropy(self.apply_all_exits(sub, x)[-1], y)

    def _scalefl_loss(self, sub, x, y):
        """Depth + width tree (ScaleFL): CE at every held exit plus the
        deepest exit distilled into each shallower one."""
        outs = self.apply_all_exits(sub, x)
        teacher = outs[-1]
        loss = cross_entropy(teacher, y)
        for o in outs[:-1]:
            loss = loss + 0.5 * (cross_entropy(o, y)
                                 + kd_loss(o, teacher.detach()))
        return loss / max(len(outs), 1)

    def _drfl_step_loss(self, params, x, y, model_idx: int):
        """The per-client DR-FL step's loss over the FULL tree: the joint
        CE of the depth-prefix submodel, so every leaf past it gets no
        gradient and its delta is exactly zero."""
        return self._drfl_loss(self.submodel_tree(params, model_idx), x, y)

    def stacked_loss_fn(self, sub, x, y):
        """Every participant's DR-FL loss, [P], from stacked trees and
        batches: the bucket step of ``stacked_forward`` families."""
        return self._joint_ce(self.apply_all_exits_stacked(sub, x), y)

    def loss_fn(self, method: str) -> Callable:
        try:
            return {"drfl": self._drfl_loss,
                    "heterofl": self._slice_loss,
                    "scalefl": self._scalefl_loss}[method]
        except KeyError:
            raise ValueError(f"unknown method {method!r}") from None

    # -- client training (the per-client executor) ------------------------
    def train_steps(self, method: str, global_params, model_idx: int,
                    xs: torch.Tensor, ys: torch.Tensor, *, lr: float):
        """One client's local SGD over the batches ``xs [T, B, ...]``,
        ``ys [T, B]`` (on the params' device): ``(delta, mean loss)``, the
        mean loss a 0-d device tensor (nothing here waits for the card).

        ``drfl`` steps the full tree with the gradient of
        :meth:`_drfl_step_loss`, so the delta is the full structure, zero
        outside the submodel; the other methods train the sliced tree of
        :meth:`submodel_params` and return the sliced delta."""
        if not self.supports(method):
            raise self.unsupported(method)
        if method == "drfl":
            start = global_params

            def loss_of(p, xb, yb):
                return self._drfl_step_loss(p, xb, yb, model_idx)
        else:
            start = self.submodel_params(method, global_params, model_idx)
            loss_of = self.loss_fn(method)
        leaves = tree_leaves(start)
        losses = []
        for t in range(xs.shape[0]):
            req = [l.detach().requires_grad_() for l in leaves]
            with torch.enable_grad():
                loss = loss_of(tree_unflatten_like(start, req), xs[t], ys[t])
                grads = torch.autograd.grad(loss, req, allow_unused=True)
            # p - lr * g, two multi-tensor launches for the whole tree; a
            # leaf the loss does not reach has a zero gradient: p - lr*0
            got = [i for i, g in enumerate(grads) if g is not None]
            stepped = torch._foreach_sub(
                [leaves[i].detach() for i in got],
                torch._foreach_mul([grads[i] for i in got], lr))
            for i, p in zip(got, stepped):
                leaves[i] = p
            losses.append(loss.detach())
        delta = torch._foreach_sub(leaves, tree_leaves(start))
        mean = (torch.stack(losses).mean() if losses
                else torch.zeros((), device=leaves[0].device))
        return tree_unflatten_like(start, delta), mean

    def client_update(self, method: str, global_params, model_idx: int,
                      x, y, *, epochs: int = 5, batch: int = 32,
                      lr: float = 0.05, seed: int = 0):
        """One client's local run on its own data ``x``, ``y`` (numpy or
        tensors): the reference's ``epoch_batches`` sequence from
        ``default_rng(seed)``, gathered on the params' device;
        ``(delta, mean loss)`` as :meth:`train_steps`."""
        dev = tree_leaves(global_params)[0].device
        x = torch.as_tensor(x, device=dev)
        x = x if x.is_floating_point() else x.long()
        y = torch.as_tensor(y, device=dev).long()
        steps = torch.as_tensor(
            client_schedule(np.arange(len(x)), seed, epochs, batch),
            dtype=torch.int64, device=dev)
        return self.train_steps(method, global_params, model_idx, x[steps],
                                y[steps], lr=lr)

    @torch.no_grad()
    def eval_fn(self, params, x, y) -> torch.Tensor:
        """Per-exit accuracy over one batch, float32 [n_exits]."""
        return torch.stack([(torch.argmax(o, -1) == y).float().mean()
                            for o in self.apply_all_exits(params, x)])

    # -- cost model --------------------------------------------------------
    def cost_model(self, num_classes: int = 10):
        """(submodel bytes, FLOP fractions) at paper scale (width 1.0,
        ``ref_hw`` images), from shapes alone: no weights are made."""
        key = int(num_classes)
        if key not in self._cost_cache:
            M = self.num_submodels()
            ref = self.param_shapes(num_classes, width_mult=1.0,
                                    hw=self.ref_hw)
            sizes = tuple(
                sum(l.numel() * l.element_size()
                    for l in tree_leaves(self._size_tree(ref, m)))
                for m in range(M))
            full = self.flops_per_sample(M - 1, self.ref_hw, 1.0)
            fractions = tuple(self.flops_per_sample(m, self.ref_hw, 1.0)
                              / full for m in range(M))
            self._cost_cache[key] = (sizes, fractions)
        return self._cost_cache[key]


_REGISTRY: Dict[str, ModelFamily] = {}
_DEFAULT = "cnn"
_BUILTINS_LOADED = False


def register_family(family: ModelFamily,
                    name: Optional[str] = None) -> ModelFamily:
    """Register a family singleton under ``name`` (default: its name)."""
    _REGISTRY[name or family.name] = family
    return family


def _ensure_builtins():
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    # the builtins register themselves at import
    from repro_torch.models import cnn, mlp, transformer_family  # noqa: F401


def known_families() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get_family(name: Optional[str] = None) -> ModelFamily:
    _ensure_builtins()
    key = name or _DEFAULT
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown model family {key!r} "
            f"(registered: {', '.join(sorted(_REGISTRY))})") from None


def resolve_family(family=None) -> ModelFamily:
    """None -> the default family; str -> registry lookup; a
    :class:`ModelFamily` passes through."""
    if family is None or isinstance(family, str):
        return get_family(family)
    if isinstance(family, ModelFamily):
        return family
    raise TypeError(f"expected ModelFamily, name or None, got {family!r}")
