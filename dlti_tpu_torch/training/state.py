"""Train state: the port of ``dlti_tpu/training/state.py``
(``partition_params``, ``create_train_state``).

The state holds the step count, the model (whose frozen base and trainable
LoRA leaves are its parameters), the optimizer state over the trainable
subset only, and, for fp16 runs, the dynamic loss scaler's state:
``{"scale": float32, "good_steps": int32, "hysteresis_left": int32}``, 0-d
tensors on the parameters' device that the step updates in place (None
otherwise).

:func:`state_leaves` names the state as the JAX ``TrainState``'s pytree
leaves, in JAX's flatten order, for the checkpoint store; for
``chain(clip_by_global_norm, adamw(schedule))``::

    .step                                       int32 []
    .params['lm_head'], .params['model'][...]   sorted keys
    .opt_state[1][0].count                      int32 [] (Adam's count)
    .opt_state[1][0].mu[('model', 'layers_0', ...)]   sorted key tuples
    .opt_state[1][0].nu[(...)]                  every mu before every nu
    .opt_state[1][2].count                      int32 [] (the schedule's)
    .scaler['good_steps'], .scaler['hysteresis_left'], .scaler['scale']
                                                fp16 runs only

The port's one ``AdamWState.count`` (a 0-d int32 tensor on the
parameters' device) is both counts, so the snapshot copies it with the
other device leaves; :func:`load_state_leaves` reads both back and checks
that they agree.

The state carries its ``parallel.sharding.Layout`` (on one device without
a strategy, the single-device mesh's, which places every leaf whole): under
a ZeRO strategy a leaf may be this rank's shard (ZeRO-3 parameters,
ZeRO-1/2/3 moments, a mixture of experts' expert leaves under expert
parallelism) or rest in pinned host memory (offload).
:func:`state_leaves` still gives every leaf whole, under the same names: a
sharded one all-gathered into host memory, leaf after leaf (a collective
every rank joins; rank 0 keeps it), anything else the live tensor. So a
checkpoint of any strategy and world is the baseline's, and
:func:`load_state_leaves` takes each rank's shard of the whole leaves it is
given, so it restores under any other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from dlti_tpu_torch.models.interop import jax_path
from dlti_tpu_torch.models.lora import is_lora_name
from dlti_tpu_torch.parallel.mesh import single_device_mesh
from dlti_tpu_torch.parallel.sharding import Layout, gather_whole, plan_layout, shard_of
from dlti_tpu_torch.training.optimizer import AdamWState, ClipAdamW

_ADAM = ".opt_state[1][0]"
_SCHEDULE_COUNT = ".opt_state[1][2].count"
# The scaler's keys in JAX's flatten order (a dict's keys, sorted).
SCALER_KEYS = ("good_steps", "hysteresis_left", "scale")


def _is_trainable(name: str, lora_enabled: bool) -> bool:
    return not lora_enabled or is_lora_name(name)


def partition_params(params: Mapping[str, torch.Tensor], lora_enabled: bool
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Split ``{name: tensor}`` into (trainable, frozen): the LoRA leaves
    under LoRA, everything in a full fine-tune."""
    trainable = {n: t for n, t in params.items() if _is_trainable(n, lora_enabled)}
    frozen = {n: t for n, t in params.items() if not _is_trainable(n, lora_enabled)}
    return trainable, frozen


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: AdamWState
    tx: ClipAdamW
    layout: Layout
    lora_enabled: bool = True
    scaler: Optional[Dict[str, torch.Tensor]] = None

    def trainable(self) -> Dict[str, torch.Tensor]:
        return partition_params(dict(self.model.named_parameters()),
                                self.lora_enabled)[0]

    def _param_axis(self, name: str) -> tuple:
        """(dim, mesh view) along which ``name`` is this rank's shard."""
        return self.layout.param_axis(name)

    def _moment_axis(self, name: str) -> tuple:
        """(dim, mesh view) along which ``name``'s moments are this rank's shard."""
        return self.layout.moment_axis(name)


def create_train_state(model: nn.Module, tx: ClipAdamW, lora_enabled: bool = True,
                       fp16_initial_scale: Optional[float] = None,
                       fp16_hysteresis: int = 2,
                       layout: Optional[Layout] = None) -> TrainState:
    """Step 0, the model with its trainable leaves requiring grad (and only
    those), and the optimizer state over them. ``fp16_initial_scale`` (e.g.
    2**16) turns on the dynamic loss scaler, with a full hysteresis budget,
    as the reference's ``create_train_state``. ``layout``: the ZeRO
    placement ``parallel.sharding.shard_model`` gave the model; without
    one, every leaf whole on the trainable leaves' device."""
    trainable, _ = partition_params(dict(model.named_parameters()), lora_enabled)
    if not trainable:
        raise ValueError("no trainable params found (LoRA enabled but no "
                         "adapters grafted)")
    if layout is None:
        device = next(iter(trainable.values())).device
        layout = plan_layout(model, single_device_mesh(device), lora_enabled)
    for name, p in model.named_parameters():
        p.requires_grad_(name in trainable)
    scaler = None
    if fp16_initial_scale is not None:
        device = next(iter(trainable.values())).device
        scaler = {
            "scale": torch.tensor(fp16_initial_scale, dtype=torch.float32, device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device),
            "hysteresis_left": torch.tensor(fp16_hysteresis, dtype=torch.int32,
                                            device=device)}
    return TrainState(step=0, model=model, opt_state=tx.init(trainable, layout), tx=tx,
                      layout=layout, lora_enabled=lora_enabled, scaler=scaler)


def params_key(name: str) -> str:
    """A parameter's leaf name in the JAX ``TrainState``:
    ``.params['model']['layers_0']['attn']['q_proj']['kernel']``."""
    return ".params" + "".join(f"[{k!r}]" for k in jax_path(name))


def frozen_param_keys(state: TrainState) -> List[str]:
    """The leaf names of the parameters no step changes (the base under
    LoRA; none in a full fine-tune)."""
    trainable = state.trainable()
    return [params_key(n) for n, _ in state.model.named_parameters()
            if n not in trainable]


def whole_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """``{name: parameter}`` with every leaf whole, what an export merges:
    each leaf where it lives (an offloaded one in pinned host memory), a
    sharded one all-gathered into host memory, leaf after leaf. At a world
    above 1 every rank must call this together, and only rank 0 gets the
    leaves (the others an empty dict)."""
    mesh = state.layout.mesh
    out = {}
    for n, p in state.model.named_parameters():
        t = gather_whole(p.detach(), *state._param_axis(n))
        if mesh.is_writer:
            out[n] = t
    return out


def state_leaves(state: TrainState, whole: bool = True) -> List[Tuple[str, torch.Tensor]]:
    """The state as ``[(jax leaf name, tensor)]`` in the JAX flatten order
    (see the module docstring). Tensors are the live ones (parameters,
    moments, the count and the scaler, on their device or in pinned host
    memory); the step is a new CPU int32 scalar. A leaf this rank holds a
    shard of comes back whole, all-gathered into host memory one leaf at a
    time (every rank must call this together; rank 0 keeps it, the others
    get a ``meta`` tensor in its place). ``whole=False`` gives instead a
    ``meta`` tensor of each leaf's whole shape and dtype, with no
    collective (a restore target)."""
    layout = state.layout
    mesh = layout.mesh

    def out(t: torch.Tensor, axis: tuple, shape) -> torch.Tensor:
        if whole:
            g = gather_whole(t, *axis)
            if g is t or mesh.is_writer:
                return g
        return torch.empty(shape, dtype=t.dtype, device="meta")

    params = sorted(state.model.named_parameters(), key=lambda kv: jax_path(kv[0]))
    moments = sorted(state.opt_state.mu, key=jax_path)
    count = state.opt_state.count
    scaler = ([(f".scaler[{k!r}]", state.scaler[k]) for k in SCALER_KEYS]
              if state.scaler is not None else [])
    mom = {n: (state._moment_axis(n), layout.leaves[n].shape) for n in moments}
    return ([(".step", torch.tensor(state.step, dtype=torch.int32))]
            + [(params_key(n), out(p, state._param_axis(n), layout.leaves[n].shape))
               for n, p in params]
            + [(f"{_ADAM}.count", count)]
            + [(f"{_ADAM}.mu[{jax_path(n)!r}]", out(state.opt_state.mu[n], *mom[n]))
               for n in moments]
            + [(f"{_ADAM}.nu[{jax_path(n)!r}]", out(state.opt_state.nu[n], *mom[n]))
               for n in moments]
            + [(_SCHEDULE_COUNT, count)]
            + scaler)


@torch.no_grad()
def load_state_leaves(state: TrainState,
                      leaves: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """Load ``leaves`` (named as :func:`state_leaves` names them, whole,
    e.g. from ``restore_train_state``) into ``state``, in place: parameters,
    moments, the count and the scaler keep their tensors (and devices, and
    this rank's shard of each sharded leaf), so a CUDA graph that captured
    them stays valid; the step becomes an int. Reads the counts back to the
    host once."""
    got = dict(leaves)
    want = [name for name, _ in state_leaves(state, whole=False)]
    if sorted(got) != sorted(want):
        missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        raise ValueError(f"leaves do not match the state: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    adam_count, schedule_count = int(got[f"{_ADAM}.count"]), int(got[_SCHEDULE_COUNT])
    if adam_count != schedule_count:
        raise ValueError(f"Adam's count {adam_count} and the schedule's count "
                         f"{schedule_count} disagree")
    for n, p in state.model.named_parameters():
        p.copy_(shard_of(got[params_key(n)], *state._param_axis(n)))
    opt = state.opt_state
    for n in state.trainable():
        axis = state._moment_axis(n)
        opt.mu[n].copy_(shard_of(got[f"{_ADAM}.mu[{jax_path(n)!r}]"], *axis))
        opt.nu[n].copy_(shard_of(got[f"{_ADAM}.nu[{jax_path(n)!r}]"], *axis))
    opt.count.fill_(adam_count)
    for k in SCALER_KEYS if state.scaler is not None else ():
        state.scaler[k].copy_(got[f".scaler[{k!r}]"])
    state.step = int(got[".step"])
