"""Layer-wise model families and their registry — port of
``repro.models.family`` (``LayerwiseFamily``, ``family.py:229-460``).

Parameters follow the canonical layer-wise layout ``{"stem": tree,
"stages": [stage_0, ...], "exits": [exit_0, ...]}``; submodel m trains
stem + stages[:m+1] + exits[:m+1].  Aggregation groups are stem + each
stage + each exit, flattened for the stacked ``layer_agg`` path in
``tree_leaves`` order (sorted dict keys, as ``jax.tree.leaves``).

Ported: the ``cnn`` family (:mod:`repro_torch.models.cnn`) and the
``transformer`` family (:mod:`repro_torch.models.transformer_family`).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core import aggregation
from repro_torch.tree import tree_leaves, tree_shapes


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch axis, logits [..., B, C] and integer labels
    [..., B] (log-sum-exp form): a scalar for one batch, [P] for P
    stacked batches."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, y[..., None].long())[..., 0]
    return torch.mean(lse - tgt, dim=-1)


class LayerwiseFamily:
    """Generic machinery over the canonical layer-wise tree; subclasses
    supply ``init``, ``apply_all_exits``, ``num_submodels``,
    ``param_shapes`` and ``flops_per_sample`` (and, with
    ``stacked_forward``, ``apply_all_exits_stacked``, which
    ``stacked_loss_fn`` differentiates)."""

    name = "abstract"
    #: image size the paper-scale energy model is calibrated at
    ref_hw = 32
    #: the bucket program's route.  False: ``vmap`` over participants of
    #: ``grad`` of the one-participant loss.  True: the family's forward
    #: takes the participant axis written out (``apply_all_exits_stacked``
    #: on trees with leaves [P, ...] and batches [P, B, ...]) and plain
    #: autograd differentiates it, as kernels bound through ctypes need:
    #: ``torch.func`` transforms cannot see inside them.
    stacked_forward = False

    def __init__(self):
        self._template_cache: dict = {}
        self._cost_cache: dict = {}

    # -- data -------------------------------------------------------------
    def make_dataset(self, n: int, num_classes: int = 10, hw: int = 32,
                     noise: float = 1.0, seed: int = 0):
        """The training corpus ``(x, y)`` (numpy; rows are samples, ``y``
        the class).  Default: the synthetic image set, ``x [n, hw, hw, 3]``
        float32 (``family.py:128-138``); token families override it."""
        from repro_torch.data.synthetic import synthetic_image_dataset
        return synthetic_image_dataset(n, num_classes, hw=hw, noise=noise,
                                       seed=seed)

    # -- submodel structure ----------------------------------------------
    def submodel_tree(self, tree, model_idx: int):
        return {"stem": tree["stem"],
                "stages": tree["stages"][:model_idx + 1],
                "exits": tree["exits"][:model_idx + 1]}

    def submodel_params(self, method: str, global_params, model_idx: int):
        if method != "drfl":
            raise NotImplementedError(
                f"method {method!r} is not ported (ROADMAP Queue 1, "
                "'baseline arms')")
        return self.submodel_tree(global_params, model_idx)

    def _size_tree(self, params, model_idx: int):
        """What a Model_{idx+1} client holds: depth prefix + ITS exit."""
        return {"stem": params["stem"],
                "stages": params["stages"][:model_idx + 1],
                "exits": [params["exits"][model_idx]]}

    # -- aggregation layout ----------------------------------------------
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

    def stacked_loss_fn(self, sub, x, y):
        """Every participant's DR-FL loss, [P], from stacked trees and
        batches: the bucket step of ``stacked_forward`` families."""
        return self._joint_ce(self.apply_all_exits_stacked(sub, x), y)

    def loss_fn(self, method: str):
        if method != "drfl":
            raise NotImplementedError(
                f"method {method!r} is not ported (ROADMAP Queue 1, "
                "'baseline arms')")
        return self._drfl_loss

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
            ref = self.param_shapes(num_classes, width_mult=1.0)
            sizes = tuple(
                sum(l.numel() * l.element_size()
                    for l in tree_leaves(self._size_tree(ref, m)))
                for m in range(M))
            full = self.flops_per_sample(M - 1, self.ref_hw, 1.0)
            fractions = tuple(self.flops_per_sample(m, self.ref_hw, 1.0)
                              / full for m in range(M))
            self._cost_cache[key] = (sizes, fractions)
        return self._cost_cache[key]


_REGISTRY: Dict[str, LayerwiseFamily] = {}
_DEFAULT = "cnn"


def register_family(family: LayerwiseFamily) -> LayerwiseFamily:
    _REGISTRY[family.name] = family
    return family


def get_family(name: Optional[str] = None) -> LayerwiseFamily:
    # importing a family's module registers it
    from repro_torch.models import cnn, transformer_family  # noqa: F401
    key = name or _DEFAULT
    if key not in _REGISTRY:
        raise NotImplementedError(
            f"model family {key!r} is not ported (ROADMAP Queue 1, "
            "'other families'); ported: " + ", ".join(sorted(_REGISTRY)))
    return _REGISTRY[key]


def resolve_family(family=None) -> LayerwiseFamily:
    if family is None or isinstance(family, str):
        return get_family(family)
    if isinstance(family, LayerwiseFamily):
        return family
    raise TypeError(f"expected a family, its name or None, got {family!r}")
