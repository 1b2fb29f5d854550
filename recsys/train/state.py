"""Train-state plumbing shared by all trainers.

Covers the reference's optimizer patterns with optax:
  * two-lr param groups (BERT vs rest, `item_tower.py:1012-1022`) via
    ``optax.multi_transform`` over path labels;
  * linear warmup -> linear decay schedule (`item_tower.py:1037-1043`);
  * grad clipping (clip 5.0, `v1_usertower_train.py:850`);
  * freeze -> unfreeze-with-scaled-lr phase switching
    (`v1_usertower_train.py:968-982`) expressed as a *static* multi-transform
    mask keyed on a phase flag — resume-safe because the optimizer tree
    shape never changes (SURVEY.md §7.3 calls this out).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import optax


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Step counter, params and optimizer state as one pytree; the optax
    transformation rides along as static metadata."""

    step: jax.Array
    params: Any
    opt_state: Any
    tx: optax.GradientTransformation = dataclasses.field(
        metadata={"static": True})

    def replace(self, **updates) -> "TrainState":
        return dataclasses.replace(self, **updates)

    def apply_gradients(self, grads):
        updates, new_opt = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(step=self.step + 1,
                            params=optax.apply_updates(self.params, updates),
                            opt_state=new_opt)

    @classmethod
    def create(cls, params, tx):
        import jax.numpy as jnp
        return cls(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=tx.init(params), tx=tx)


jax.tree_util.register_dataclass(TrainState)


def warmup_linear_schedule(base_lr: float, total_steps: int,
                           warmup_frac: float = 0.1) -> optax.Schedule:
    warmup = max(int(total_steps * warmup_frac), 1)
    return optax.join_schedules(
        [optax.linear_schedule(0.0, base_lr, warmup),
         optax.linear_schedule(base_lr, 0.0, max(total_steps - warmup, 1))],
        [warmup])


def label_params(params, fn: Callable[[str], str]):
    """Label every leaf by its '/'-joined path through ``fn``."""
    flat = jax.tree_util.tree_flatten_with_path(params)
    def _name(path):
        return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
    labels = [fn(_name(path)) for path, _ in flat[0]]
    return jax.tree_util.tree_unflatten(flat[1], labels)


def grouped_adamw(groups: dict[str, optax.GradientTransformation],
                  params, label_fn: Callable[[str], str],
                  grad_clip: float | None = None) -> optax.GradientTransformation:
    tx = optax.multi_transform(groups, label_params(params, label_fn))
    if grad_clip:
        tx = optax.chain(optax.clip_by_global_norm(grad_clip), tx)
    return tx


def freeze_gate_schedule(freeze_steps: int) -> optax.Schedule:
    """1.0 after ``freeze_steps``, else 0.0 — chained BEFORE an inner adam so
    gradients are hard-zeroed during the frozen phase (no moment warmup),
    making freeze->unfreeze a pure schedule with a static optimizer tree
    (the reference mutates torch param groups instead,
    `v1_usertower_train.py:968-982`)."""
    import jax.numpy as jnp

    def sched(step):
        return jnp.where(step >= freeze_steps, 1.0, 0.0)

    return sched


def with_lr_factor(tx: optax.GradientTransformation) -> optax.GradientTransformation:
    """Append a runtime-mutable update scale (serialized in opt state) —
    the ReduceLROnPlateau mechanism (reference `v1_usertower_train.py:957-960`)."""
    return optax.chain(tx, optax.inject_hyperparams(optax.scale)(step_size=1.0))


def set_lr_factor(opt_state, factor: float):
    """Rewrite the injected scale inside a ``with_lr_factor`` opt state."""
    import jax.numpy as jnp

    inj = opt_state[-1]
    hp = dict(inj.hyperparams)
    hp["step_size"] = jnp.asarray(factor, jnp.float32)
    return opt_state[:-1] + (inj._replace(hyperparams=hp),)


class PlateauScheduler:
    """Host-side metric watcher: multiplies the lr factor by ``factor`` after
    ``patience`` epochs without improvement."""

    def __init__(self, factor: float = 0.5, patience: int = 2, maximize: bool = True,
                 min_scale: float = 1e-3):
        self.factor, self.patience, self.maximize = factor, patience, maximize
        self.min_scale = min_scale
        self.best: float | None = None
        self.bad = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        improved = self.best is None or (
            (metric > self.best) if self.maximize else (metric < self.best))
        if improved:
            self.best, self.bad = metric, 0
        else:
            self.bad += 1
            if self.bad >= self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad = 0
        return self.scale
