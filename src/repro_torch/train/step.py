"""The training step (counterpart of ``repro.train.step``): loss -> grads
(with microbatch accumulation) -> clip -> optimizer.

``train_step(state, batch)`` runs eagerly: the forward (``Model.forward``
with the config's remat policy), the chunked cross-entropy, autograd, then
``apply_optimizer``, which makes new tensors, so a step that fails leaves
the state it was given.  On a CUDA device the step first refuses, through
``dispatch.check_card_support``'s ``"train"`` backend, a config whose
trained path reaches a hand kernel with no backward.  The step counters
live on the host (0-dim int32), so the schedule and the optimizer's
scalars need no read from the card; the loss the caller reads is the
step's one host sync.  ``state_pspecs`` / ``batch_pspec`` belong to
``dist/``, which is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from .._device import resolve_device
from ..config import ModelConfig, TrainConfig
from ..convert import params_from_jax, params_to_jax
from ..kernels import dispatch
from ..models.api import Model
from ..optim import OptState, apply_optimizer, init_optimizer, warmup_cosine
from ..tree import leaves, tree_map, unflatten
from .losses import chunked_cross_entropy

TRAIN_BACKEND = "train"


@dataclass
class TrainState:
    """params, optimizer state and the step counter (host, int32).  ``cfg``
    (the model's config) gives the layout the state is checkpointed in: the
    reference's, each stacked layer axis stacked, so either package restores
    what the other saved."""

    params: Any
    opt: OptState
    step: torch.Tensor
    cfg: ModelConfig = field(repr=False, compare=False)

    def _layout(self, tree, device):
        if device == "meta":
            moved = tree_map(lambda t: t.detach().to("meta"), tree)
        else:
            moved = tree_map(lambda t: t.detach().to(device, copy=True), tree)
        return params_to_jax(moved, self.cfg, device=device)

    def _unlayout(self, tree):
        return params_from_jax(tree, self.cfg, device="cpu")

    def checkpoint_tree(self, device):
        """The state as the reference's ``TrainState`` flattens: [params,
        [optimizer inner, optimizer step], step], copied to ``device``
        ("cpu": a host snapshot; "meta": the names alone)."""
        opt = self.opt
        if opt.kind == "adamw":
            inner = {k: self._layout(v, device) for k, v in opt.inner.items()}
        else:
            inner = self._layout(opt.inner, device)
        copy = (lambda t: t.to("meta")) if device == "meta" else (lambda t: t.clone())
        return [self._layout(self.params, device), [inner, copy(opt.step)], copy(self.step)]

    def from_checkpoint_tree(self, tree) -> "TrainState":
        """Inverse of :meth:`checkpoint_tree` on restored host tensors."""
        params, (inner, opt_step), step = tree
        if self.opt.kind == "adamw":
            inner = {k: self._unlayout(v) for k, v in inner.items()}
        else:
            inner = self._unlayout(inner)
        return TrainState(self._unlayout(params), OptState(self.opt.kind, inner, opt_step),
                          step, cfg=self.cfg)

    def to(self, device) -> "TrainState":
        """params and optimizer state on ``device``; the counters stay on
        the host."""
        move = lambda t: t.to(device)  # noqa: E731
        return TrainState(tree_map(move, self.params),
                          OptState(self.opt.kind, tree_map(move, self.opt.inner), self.opt.step),
                          self.step, cfg=self.cfg)


def loss_fn(model: Model, params, batch, train_cfg: TrainConfig):
    hidden, aux = model.forward(params, batch, remat=train_cfg.remat)
    head = model.head_weight(params)
    loss, metrics = chunked_cross_entropy(hidden, head, batch["targets"], batch["loss_mask"])
    return loss + aux, {**metrics, "aux": aux}


def loss_and_grads(model, params, batch, train_cfg):
    """(loss, metrics, grads tree) of one (micro)batch: autograd with
    respect to views of the param leaves (the leaves themselves are not
    marked)."""
    flat = leaves(params)
    if not all(p.is_floating_point() for p in flat):
        raise ValueError(f"{model.cfg.name}: integer param leaves (int4) cannot be trained")
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(model, unflatten(params, live), batch, train_cfg)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, grads)


def build_train_step(model: Model, train_cfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (new state, metrics)``; batch
    tensors lie on the params' device.  metrics: ce, tokens, aux (the last
    microbatch's), loss (the mean over microbatches), grad_norm, lr."""
    schedule = warmup_cosine(train_cfg.lr, train_cfg.warmup_steps, train_cfg.total_steps)
    checked: set = set()

    def train_step(state: TrainState, batch):
        device = leaves(state.params)[0].device
        if device.type == "cuda" and device not in checked:
            dispatch.check_card_support(model.cfg, device, TRAIN_BACKEND)
            checked.add(device)
        mb = train_cfg.microbatches
        if mb <= 1:
            loss, metrics, grads = loss_and_grads(model, state.params, batch, train_cfg)
        else:
            def split(x, i):
                return x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[i]

            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
            for i in range(mb):
                mb_loss, metrics, g = loss_and_grads(
                    model, state.params, {k: split(v, i) for k, v in batch.items()}, train_cfg)
                loss = loss + mb_loss
                grads = tree_map(lambda a, b: a + b.to(torch.float32), grads, g)
            loss = loss / mb
            grads = tree_map(lambda g: g / mb, grads)
        lr = schedule(state.step)
        new_params, new_opt, opt_metrics = apply_optimizer(
            state.opt, state.params, grads, lr,
            weight_decay=train_cfg.weight_decay, grad_clip=train_cfg.grad_clip)
        metrics = {**metrics, **opt_metrics, "loss": loss, "lr": lr}
        return TrainState(new_params, new_opt, state.step + 1, cfg=state.cfg), metrics

    return train_step


def init_train_state(model: Model, train_cfg: TrainConfig, seed_or_generator=0, *,
                     device=None) -> TrainState:
    """Random params (``model.init``) and zero optimizer state on ``device``
    (the card unless ``device="cpu"``; it raises with no card).  On a CUDA
    device a config the ``"train"`` backend refuses is refused first."""
    dispatch.check_card_support(model.cfg, torch.device(device or "cuda"), TRAIN_BACKEND)
    device = resolve_device(device)
    if isinstance(seed_or_generator, torch.Generator):
        params = model.init(generator=seed_or_generator, device=device)
    else:
        params = model.init(int(seed_or_generator), device=device)
    opt = init_optimizer(train_cfg.optimizer, params)
    return TrainState(params, opt, torch.zeros((), dtype=torch.int32), cfg=model.cfg)
