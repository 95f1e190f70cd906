"""The train step and loop (reference ``launch/train.py``): the paper's
technique as a training-loop feature, microbatching and the injection
simulation.

Step anatomy (memory mode, the paper's recommendation):

  1. the step-boundary scrub of params and optimizer moments, installed by
     ``ApproxSpace.wrap_train_step``: repair once, write back in place
  2. forward and backward (``model.loss``), reading the weights clean in
     memory mode or through the use-site repair in register mode
  3. the AdamW update (f32 moments, the step counter in exact memory)

The train state is flat, ``{path: value}`` under the reference's paths:
``params/<path>`` (the model's own tensors, layer weights stacked as the
reference stacks them: (L, ...) for the transformer, (G, M, ...) and
(G, ...) for the xLSTM's and Zamba's groups), ``opt/step``, ``opt/mu/<path>``,
``opt/nu/<path>``, ``stats`` (host counters) and, with a space,
``rule_counts`` (int64 [n_rules, 3], the boundary scrub's per-rule ledger,
folded into ``space.rule_stats()`` by ``train_loop``).  The step updates
the tensors in place.  Every ported family trains: ``TransformerLM`` (a
VLM batch's ``patch_embeds`` sliced with its tokens into microbatches),
``XLSTMLM`` and ``ZambaLM``.

``train_loop`` arms the autopilot's online guard when the space's config
carries an ``AutopilotConfig``: every ``window`` steps the state's rule
ledger is folded into the space and the guard observes it; a trip's
decisions go into the history.

``train_loop`` saves through a ``checkpoint.CheckpointManager`` every
``checkpoint_every`` steps (the rule ledger folded and zeroed first), and
resumes from a restored state: ``bind_state`` copies its params into the
model's tensors.

Injection (``ber > 0``) simulates approximate memory between steps, from a
``torch.Generator`` seeded by (seed, step): its flips cannot be the
reference's, only their statistics.  Not ported: meshes (ROADMAP slice 6).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import stats as stats_lib
from ..optim import AdamW, cosine_with_warmup
from ..runtime import ApproxSpace

State = Dict[str, Any]


def make_optimizer(
    peak_lr: float = 3e-4,
    warmup: int = 100,
    total: int = 10000,
    weight_decay: float = 0.1,
) -> AdamW:
    return AdamW(
        lr=cosine_with_warmup(peak_lr, warmup, total),
        weight_decay=weight_decay,
    )


def init_train_state(model, opt: AdamW,
                     space: Optional[ApproxSpace] = None) -> State:
    """The train state over ``model``'s weights (as they stand: the model
    was built from its seed), zero moments and step 0.  With ``space`` it
    also carries the ``rule_counts`` block."""
    params = model.param_tree()
    state: State = {f"params/{p}": t for p, t in params.items()}
    state.update({f"opt/{k}": v for k, v in opt.init(params).items()})
    state["stats"] = stats_lib.zeros()
    if space is not None:
        state["rule_counts"] = np.zeros((space.ruleset.n_rules, 3), np.int64)
    return state


@torch.no_grad()
def bind_state(model, state: State) -> State:
    """``state`` with its params in ``model``'s own tensors, which the step
    updates in place: a ``params/...`` leaf that is another tensor (a
    restored checkpoint's) is copied into the model's."""
    out = dict(state)
    for path, own in model.param_tree().items():
        leaf = out[f"params/{path}"]
        if leaf is not own:
            own.copy_(leaf)
            out[f"params/{path}"] = own
    return out


def resident(state: State) -> Dict[str, torch.Tensor]:
    """The approximate-memory resident of a train state: params + opt."""
    return {p: t for p, t in state.items() if p.startswith(("params/", "opt/"))}


def build_train_step(model, opt: AdamW, *, n_micro: int = 1,
                     space: Optional[ApproxSpace] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: the raw compute
    (``raw_train_step``) wrapped by ``space.wrap_train_step``, which
    installs the boundary scrub."""
    space = space or ApproxSpace(model.cfg.repair)
    return space.wrap_train_step(raw_train_step(model, opt, n_micro=n_micro))


def raw_train_step(model, opt: AdamW, *, n_micro: int = 1) -> Callable:
    """The step's compute alone: forward, backward and the AdamW update, in
    place on the state's tensors.

    ``n_micro > 1`` splits the batch into that many row blocks, adds each
    block's gradients into an f32 accumulator in order and averages them,
    as the reference's scan does.  The state's params must be the model's
    own tensors (``init_train_state``, ``convert.train_state_from_jax``)."""
    params = model.param_tree()
    grads = model.bind_grads()

    def grads_of(batch):
        for g in grads.values():
            g.zero_()
        loss, metrics = model.loss(batch)
        loss.backward()
        return loss.detach(), metrics

    def train_step(state, batch):
        for path, t in params.items():
            if state[f"params/{path}"] is not t:
                raise ValueError(
                    f"params/{path} is not the model's own tensor: build the "
                    "state with init_train_state or train_state_from_jax"
                )
        if n_micro == 1:
            _, metrics = grads_of(batch)
            step_grads = grads
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % n_micro:
                raise ValueError(f"batch {rows} must split into {n_micro}")
            mb = rows // n_micro
            acc = {p: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                   for p, g in grads.items()}
            loss_sum = None
            for i in range(n_micro):
                loss, _ = grads_of({k: v[i * mb:(i + 1) * mb]
                                    for k, v in batch.items()})
                for p, g in grads.items():
                    acc[p] += g.float()
                loss_sum = loss if loss_sum is None else loss_sum + loss
            step_grads = {p: a / n_micro for p, a in acc.items()}
            metrics = {"loss": loss_sum / n_micro}
        opt_state = {k[4:]: v for k, v in state.items() if k.startswith("opt/")}
        opt_metrics = opt.update(step_grads, opt_state, params)
        return state, {**metrics, **opt_metrics}

    return train_step


def inject_state(state: State, generator: torch.Generator, ber: float,
                 space: Optional[ApproxSpace] = None) -> State:
    """One approximate-memory window of bit flips over the approximate
    region of params + moments, in place (simulation only); the flip count
    lands in ``state["stats"]``."""
    space = space or ApproxSpace(ber=ber)
    _, stats = space.inject(resident(state), generator, ber,
                            stats=state["stats"])
    return {**state, "stats": stats}


def _window_generator(device: torch.device, seed: int, step: int):
    return torch.Generator(device=device).manual_seed(
        int(seed) * 1_000_003 + 10_000 + int(step))


def train_loop(
    model,
    opt: AdamW,
    data_fn: Callable[[int], Dict[str, torch.Tensor]],
    *,
    steps: int,
    seed: int = 0,
    ber: float = 0.0,
    state: Optional[State] = None,
    start_step: int = 0,
    checkpoint_manager=None,
    checkpoint_every: int = 0,
    log_every: int = 10,
    n_micro: int = 1,
    space: Optional[ApproxSpace] = None,
    mesh=None,
) -> Tuple[State, list]:
    """Run steps ``start_step .. steps - 1``: an injection window before
    each step when ``ber > 0`` (its generator seeded by ``seed`` and the
    step), then the step.  One ``ApproxSpace`` owns the run.  Returns
    ``(state, history)``: every ``log_every``-th step and the last, with
    the step's metrics and the cumulative stats.

    With ``checkpoint_manager`` and ``checkpoint_every``, the state is
    saved after every ``checkpoint_every``-th step (as step ``i + 1``),
    its rule ledger folded and zeroed first, so a restored checkpoint never
    re-folds what the space already holds; the loop waits for the last
    write.  A given ``state`` (a restored checkpoint) is bound to the
    model first (``bind_state``).

    With ``space.config.autopilot`` the online guard observes after every
    ``window``-th step, the rule ledger folded first; a trip appends
    ``{"step": i, "autopilot": decisions}`` to the history.  The step
    plans its boundary scrub from the space's rules on every call, so a
    tightened rule takes effect from the next step without a rebuild."""
    if mesh is not None:
        raise NotImplementedError(
            "train_loop(mesh=...) is not ported: ROADMAP slice 6 (multi-GPU)"
        )
    space = space or ApproxSpace(model.cfg.repair,
                                 ber=ber if ber > 0 else None)
    if state is None:
        state = init_train_state(model, opt, space=space)
    else:
        state = bind_state(model, state)
    step_fn = build_train_step(model, opt, n_micro=n_micro, space=space)
    guard = None
    if space.config.autopilot is not None:
        from ..autopilot.guard import OnlineGuard   # deferred: autopilot imports us
        guard = OnlineGuard(space, space.config.autopilot)
    history = []
    for i in range(start_step, steps):
        if ber > 0.0:
            state = inject_state(state, _window_generator(model.device, seed, i),
                                 ber, space)
        state, metrics = step_fn(state, data_fn(i))
        if guard is not None and (i + 1) % guard.cfg.window == 0:
            # the step's ledger must reach rule_stats() before the window
            state = _fold_rule_counts(space, state)
            decisions = guard.observe()
            if decisions:
                history.append({"step": i, "autopilot": decisions})
        if log_every and (i % log_every == 0 or i == steps - 1):
            history.append({"step": i,
                            **{k: float(v) for k, v in metrics.items()},
                            **stats_lib.as_dict(state["stats"])})
        if checkpoint_manager is not None and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            state = _fold_rule_counts(space, state)
            checkpoint_manager.save(i + 1, state)
    if checkpoint_manager is not None:
        checkpoint_manager.wait()
    # the tail since the last checkpoint (or the whole run), folded once
    return _fold_rule_counts(space, state), history


def _fold_rule_counts(space: ApproxSpace, state: State) -> State:
    """Fold the state's per-rule boundary-scrub ledger into the space's
    and zero the block (no-op for states without one)."""
    if "rule_counts" not in state:
        return state
    space.record_rule_counts(state["rule_counts"])
    return {**state, "rule_counts": np.zeros_like(state["rule_counts"])}
