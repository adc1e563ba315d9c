"""Pipeline parallelism: the GPipe schedule over the ``pipe`` axis, the port
of ``dlti_tpu/parallel/pipeline.py``.

The block stack is split into ``pipe`` contiguous stages: stage ``k`` of
``P`` holds layers ``k * L/P .. (k+1) * L/P - 1`` (its model's
``model.layers.0 ..``, ``LlamaForCausalLM(..., stage=(k, P))``), and every
stage holds the embedding, the final norm and the head. With ``M``
microbatches the schedule runs ``M + P - 1`` ticks: at tick ``t`` stage 0
takes microbatch ``t``, stage ``k`` works on microbatch ``t - k``, and after
each tick every stage's output moves to the next stage
(``parallel.tensor.permute_``, the counterpart of ``jax.lax.ppermute``).
The last stage's outputs, microbatch by microbatch, are summed to every
stage (a masked all-reduce, the reference's ``psum``), and every stage
applies the final norm, the head and the loss to them, so every stage holds
the loss and the gradients of the leaves every stage holds. A stage whose
tick falls outside ``0 <= t - k < M`` (the pipeline's fill and drain) skips
its compute and sends zeros: the reference computes a clipped microbatch
there and throws it away, which changes nothing. The bubble is ``(P - 1) /
(M + P - 1)`` of the ticks.

The train step (:func:`make_pipeline_train_step`) runs the backward of the
schedule by hand, tick by tick in reverse: each tick's stage output gets
its gradient (from the next stage, through the reverse permute, and on the
last stage from the loss), the stage's parameters their share, and its
input's gradient goes back to the previous stage. Every rank thus issues
its collectives in one order whatever it computes. Its objective is the
reference's, ``(loss_sum + coef * sum_m aux_m * n_tok_m) / n_tok`` over
the whole batch (the microbatches' router losses, a mixture of experts
only, each summed over the stages that compute it), with the fp16 scaler,
the bf16 nonfinite gate, an int8 frozen base and ``loss_chunk``; LoRA
dropout draws the single-device masks (microbatch ``m``'s key, the global
layer index, the rows' global numbers), so a pipelined step equals the
unpipelined step on the same ``accum`` microbatches.

Under ZeRO-3 (``fsdp`` above 1) a stage's layers rest as ``fsdp`` shards,
each placed by the one rule (``parallel.sharding.strategy_axes``, the
stacked layout's ``dim_shift=1``, ``taken=(0,)``), so a stage holds
``layers_per_stage / fsdp`` layers' worth at rest: each block is gathered
at its use in every tick (``parallel.sharding.ParamFetcher``), in the
forward ticks and again in the backward's remat recompute, and its
gradient is reduce-scattered over ``fsdp``. ``fsdp`` peers share the pipe
coordinate, so they run one tick schedule and issue their gathers in one
order.

Layout in and out: :func:`to_pipeline_params` / :func:`from_pipeline_params`
between the flat tree (``model.layers.{i}...``) and the reference's
stacked one (``layers...`` with a leading layer dim), :func:`stage_params`
for a stage's model, :func:`pipeline_param_placement` for the reference's
placement rule, which ``training.state`` follows to name a pipe checkpoint.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch

from dlti_tpu_torch.models.moe import collect_aux_loss
from dlti_tpu_torch.parallel.tensor import all_reduce_, permute_
from dlti_tpu_torch.utils.hashing import mix32

_LAYER = re.compile(r"model\.layers\.(\d+)\.(.*)")


# ----------------------------------------------------------------------
# Param layout: flat tree <-> stacked tree, a stage's tree, placement
# ----------------------------------------------------------------------

def to_pipeline_params(params: Mapping[str, torch.Tensor], num_layers: int
                       ) -> Dict[str, torch.Tensor]:
    """The flat tree (this package's names) as the reference's pipeline
    tree, by ``params_from_jax`` names: every ``model.layers.{i}.X`` stacked
    into ``layers.X`` with a leading layer dim; ``model.embed_tokens``,
    ``model.final_norm.scale`` and ``lm_head`` lose their ``model.`` level."""
    out: Dict[str, torch.Tensor] = {}
    stacked: Dict[str, list] = {}
    for name, t in params.items():
        m = _LAYER.fullmatch(name)
        if m:
            stacked.setdefault(m.group(2), [None] * num_layers)[int(m.group(1))] = t
        else:
            out[name.removeprefix("model.")] = t
    for rest, ts in stacked.items():
        out[f"layers.{rest}"] = torch.stack(ts)
    return out


def from_pipeline_params(pparams: Mapping[str, torch.Tensor], num_layers: int
                         ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`to_pipeline_params`."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in pparams.items():
        if name.startswith("layers."):
            for i in range(num_layers):
                out[f"model.layers.{i}.{name[len('layers.'):]}"] = t[i]
        elif name.split(".")[0] == "lm_head":
            out[name] = t
        else:
            out[f"model.{name}"] = t
    return out


def stage_of(name: str, stage: int, num_stages: int, num_layers: int) -> Optional[str]:
    """Leaf ``name`` of the flat tree as stage ``stage`` names it (layer ``i``
    of its own becomes ``model.layers.{i - first}``), or None when another
    stage holds it."""
    m = _LAYER.fullmatch(name)
    if not m:
        return name
    per_stage = num_layers // num_stages
    i = int(m.group(1)) - stage * per_stage
    return f"model.layers.{i}.{m.group(2)}" if 0 <= i < per_stage else None


def stage_params(params: Mapping[str, torch.Tensor], stage: int, num_stages: int,
                 num_layers: int, donate: bool = False) -> Dict[str, torch.Tensor]:
    """Stage ``stage``'s tree of the flat ``params``: its layers under their
    local names and the leaves every stage holds (``donate``: each source
    leaf is popped from ``params``)."""
    if num_layers % num_stages:
        raise ValueError(f"num_layers={num_layers} must divide into pipe={num_stages} "
                         "stages")
    out = {}
    for name in list(params):
        local = stage_of(name, stage, num_stages, num_layers)
        t = params.pop(name) if donate else params[name]
        if local is not None:
            out[local] = t
    return out


def pipeline_param_placement(shapes: Mapping[str, tuple], tensor: int = 1,
                             expert: int = 1, fsdp: int = 1) -> Dict[str, tuple]:
    """The reference's ``pipeline_param_shardings`` as a partition spec per
    leaf of a stacked tree (``shapes``: name to shape, by
    :func:`to_pipeline_params` names): a stacked leaf's layer dim over
    ``pipe``, and the one placement rule
    (``parallel.sharding.strategy_axes``) for the rest, shifted by one dim
    past the layer dim (``dim_shift=1``, ``taken=(0,)``) for a stacked leaf:
    an expert leaf's expert dim over ``expert``, the tensor rule's dim over
    ``tensor``, and the largest remaining dim ``fsdp`` divides over
    ``fsdp``. The live layout (``parallel.sharding.plan_layout``) places a
    stage's layers one by one by the same rule, so a layer's part is its
    slice of this one."""
    from dlti_tpu_torch.parallel.sharding import strategy_axes

    out = {}
    for name, shape in shapes.items():
        spec = [None] * len(shape)
        if name.startswith("layers."):
            spec[0] = "pipe"
            flat, shift, taken = f"model.layers.0.{name[len('layers.'):]}", 1, (0,)
        else:
            top = name.split(".")[0] == "lm_head"
            flat, shift, taken = name if top else f"model.{name}", 0, ()
        for d, axis in strategy_axes(flat, shape, ep=expert, tp=tensor, fsdp=fsdp,
                                     dim_shift=shift, taken=taken).items():
            spec[d] = axis
        out[name] = tuple(spec)
    return out


# ----------------------------------------------------------------------
# The schedule
# ----------------------------------------------------------------------

def _microbatch_seed(step_seed, m: int):
    """Microbatch ``m``'s dropout key in a step keyed ``step_seed``: the
    unpipelined step's (``training.step.make_device_step``)."""
    return None if step_seed is None else mix32(step_seed ^ mix32(m + 0x3C6EF372))


class _Schedule:
    """One batch's microbatches ``(M, rows, seq)`` on a stage: the
    embedding, each microbatch's positions, segment ids, token mask (a
    mixture of experts) and dropout hashes, and the RoPE tables."""

    def __init__(self, model, batch: Mapping[str, torch.Tensor], step_seed, row_rank: int,
                 embed_grad: bool):
        lm = model.model
        cfg = model.cfg
        ids = batch["input_ids"]
        self.M, self.rows, self.seq = ids.shape
        dev = ids.device
        with torch.set_grad_enabled(embed_grad):
            self.x = lm.embed(ids.reshape(-1, self.seq)).reshape(self.M, self.rows, self.seq, -1)
        positions = batch.get("positions")
        self.positions = (torch.arange(self.seq, device=dev)[None, None, :].expand(ids.shape)
                          if positions is None else positions)
        self.segments = batch.get("segment_ids")
        self.moe = cfg.num_experts > 0
        self.token_mask = None
        if self.moe:
            mask = batch.get("loss_mask")
            if self.segments is not None:
                mask = (self.segments != 0).to(torch.int32)
            self.token_mask = mask
        table_len = max(cfg.max_seq_len, self.seq)
        self.cos, self.sin = lm._rope_tables(table_len, dev)
        self.step_seed = step_seed
        self.row_offset = row_rank * self.rows * self.seq
        self.lm = lm

    def stage(self, x: torch.Tensor, m: int) -> tuple:
        """This stage's layers on microbatch ``m``'s activations ``x``:
        ``(out, aux or None)``."""
        lm = self.lm
        hashes = lm.layer_hashes(_microbatch_seed(self.step_seed, m), self.rows * self.seq,
                                 x.device, self.row_offset)
        out, auxes = lm.run_layers(
            x, self.cos, self.sin, self.positions[m],
            None if self.segments is None else self.segments[m], hashes,
            None if self.token_mask is None else self.token_mask[m], self.moe)
        return out, (collect_aux_loss(auxes) if self.moe else None)


def _forward_ticks(sched: _Schedule, pipe, train: bool) -> tuple:
    """The forward schedule on this stage: ``(outputs, stash, aux)``, the
    last stage's ``(M, rows, seq, h)`` outputs (zeros elsewhere), each
    computed tick's ``(input, output, aux, m)`` when ``train`` (its graph
    kept), and this stage's router loss per microbatch (float32 ``(M,)``,
    detached)."""
    P, k = pipe.world, pipe.rank
    M = sched.M
    x = sched.x
    outputs = torch.zeros_like(x, requires_grad=False)
    aux = torch.zeros((M,), dtype=torch.float32, device=x.device)
    stash = {}
    buf = torch.zeros_like(x[0], requires_grad=False)
    for t in range(M + P - 1):
        m = t - k
        send = None
        if 0 <= m < M:
            inp = (x[m] if k == 0 else buf).detach()
            if train:
                inp.requires_grad_(k > 0 or x.requires_grad)
            with torch.set_grad_enabled(train):
                out, a = sched.stage(inp, m)
            if train:
                stash[t] = (inp, out, a, m)
            send = out.detach()
            if k == P - 1:
                outputs[m] = send
            if a is not None:
                aux[m] = a.detach()
        if send is None:
            send = torch.zeros_like(buf)
        buf = permute_(send, 1, pipe)
    return outputs, stash, aux


def _check(cfg, pipe_world: int, rows: int, num_microbatches: int) -> None:
    if cfg.num_layers % pipe_world:
        raise ValueError(f"num_layers={cfg.num_layers} must divide into pipe={pipe_world} "
                         "stages")
    if rows % num_microbatches:
        raise ValueError(f"batch={rows} must divide by microbatches={num_microbatches}")


@torch.no_grad()
def pipeline_forward(model, input_ids: torch.Tensor, mesh, *, num_microbatches: int = 4,
                     positions: Optional[torch.Tensor] = None,
                     segment_ids: Optional[torch.Tensor] = None,
                     token_mask: Optional[torch.Tensor] = None,
                     return_hidden: bool = False, return_aux: bool = False):
    """The whole model on ``input_ids`` ``(b, seq)`` with the block stack
    pipelined over ``mesh``'s ``pipe`` axis (``model``: this rank's stage),
    deterministic and without gradients (the train step runs its own
    backward): float32 logits ``(b, seq, vocab)`` on every stage, the same
    function as the unpipelined model's, or the final norm's output with
    ``return_hidden``; ``return_aux`` adds each microbatch's router loss
    (``(M,)``, a mixture of experts). ``b`` must divide by
    ``num_microbatches``. ``token_mask``: a mixture of experts' padding mask
    (packed rows take theirs from ``segment_ids``)."""
    pipe = mesh.pipe
    cfg = model.cfg
    b, s = input_ids.shape
    _check(cfg, pipe.world, b, num_microbatches)
    M = num_microbatches

    def mb(t):
        return None if t is None else t.reshape(M, b // M, s)

    batch = {"input_ids": mb(input_ids)}
    if positions is not None:
        batch["positions"] = mb(positions.expand(b, s))
    if segment_ids is not None:
        batch["segment_ids"] = mb(segment_ids)
    if token_mask is not None:
        batch["loss_mask"] = mb(token_mask)
    sched = _Schedule(model, batch, None, mesh.batch.rank, embed_grad=False)
    outputs, _, aux = _forward_ticks(sched, pipe, train=False)
    y = all_reduce_(outputs, pipe).reshape(b, s, -1)
    out = model.model.norm(y)
    if not return_hidden:
        out = model.logits(out)
    if return_aux:
        return out, all_reduce_(aux, pipe)
    return out


def pipeline_head_matrix(model) -> torch.Tensor:
    """The ``(hidden, vocab)`` head a stage's chunked loss multiplies by (every
    stage holds it): the flat model's ``head_matrix``."""
    return model.head_matrix()


def to_pipeline_state(state, mesh, lora=None):
    """A fresh single-process ``TrainState`` as this rank's stage state under
    ``mesh``: the stage's layers of its model (local names), placed by the
    mesh, and the optimizer state re-initialized over its trainable leaves
    (use at step 0: converting mid-run would discard the moments)."""
    from dlti_tpu_torch.models.interop import load_model, shard_params
    from dlti_tpu_torch.parallel.sharding import shard_model
    from dlti_tpu_torch.training.state import create_train_state

    cfg = state.model.cfg
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    params = stage_params(params, mesh.pipe.rank, mesh.pp, cfg.num_layers)
    params = shard_params(params, mesh, cfg, lora)
    model = load_model(cfg, params, mesh.device, lora=lora, trainable_lora=True,
                       mesh=mesh, stage=(mesh.pipe.rank, mesh.pp))
    layout = shard_model(model, mesh, state.lora_enabled)
    return create_train_state(model, state.tx, lora_enabled=state.lora_enabled,
                              layout=layout)


def make_pipeline_train_step(model, *, accum_steps: int = 4, loss_chunk: int = 0,
                             fp16_scale_window: int = 1000, fp16_min_scale: float = 1.0,
                             fp16_hysteresis: int = 2):
    """Build ``device_step(state, batch, step_seed) -> metrics`` for a stage's
    model: the GPipe schedule of the batch's ``accum_steps`` microbatches
    (``batch`` this batch rank's ``(accum, rows, seq)``), its backward tick by
    tick (see the module docstring), then ``training.step.finish_step``:
    the same metrics and update as the unpipelined step."""
    from dlti_tpu_torch.training.step import (
        causal_lm_loss, chunked_causal_lm_loss, finish_step,
    )
    from dlti_tpu_torch.parallel.sharding import owned_grad

    cfg = model.cfg
    moe = cfg.num_experts > 0
    coef = cfg.router_aux_loss_coef if moe else 0.0
    if loss_chunk and moe:
        raise ValueError("loss_chunk does not compose with MoE aux-loss collection; "
                         "set train.loss_chunk=0 for MoE models")
    if loss_chunk and model.model.tp is not None:
        raise NotImplementedError("loss_chunk under tensor parallelism (a chunked loss "
                                  "over a vocabulary-split head) is not ported yet "
                                  "(see ROADMAP.md)")

    def device_step(state, batch: Dict[str, torch.Tensor], step_seed) -> dict:
        layout = state.layout
        mesh = layout.mesh
        pipe = mesh.pipe
        P, k = pipe.world, pipe.rank
        net = state.model
        lm = net.model
        ids = batch["input_ids"]
        M = ids.shape[0]
        if M != accum_steps:
            raise ValueError(f"the batch holds {M} microbatches, the step {accum_steps}")
        trainable = state.trainable()
        names = list(trainable)
        stage_names = [n for n in names if layout.leaves[n].stage]
        shared_names = [n for n in names if not layout.leaves[n].stage]
        grads = {n: torch.zeros_like(trainable[n], dtype=torch.float32) for n in names}
        scale = state.scaler["scale"] if state.scaler is not None else None
        embed_grad = any(n.startswith("model.embed_tokens") for n in shared_names)
        sched = _Schedule(net, batch, step_seed, mesh.batch.rank, embed_grad)
        dev = ids.device
        loss_mask = batch.get("loss_mask")
        # Each microbatch's trained tokens (this rank's rows), weighing its aux.
        n_tok_m = ((torch.full((M,), float(sched.rows * (sched.seq - 1)), device=dev))
                   if loss_mask is None else loss_mask[:, :, 1:].float().sum((1, 2)))

        outputs, stash, aux = _forward_ticks(sched, pipe, train=True)
        y = all_reduce_(outputs, pipe)

        # Every stage: final norm, head and loss on the whole outputs; the
        # last stage's share of their gradient starts the backward.
        shared = [trainable[n] for n in shared_names]
        gy = torch.zeros_like(y)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        n_tok = torch.zeros((), dtype=torch.float32, device=dev)
        for m in range(M):
            ym = y[m].detach().requires_grad_()
            mask = None if loss_mask is None else loss_mask[m]
            with torch.enable_grad():
                hidden = lm.norm(ym)
                if loss_chunk:
                    ls, nt = chunked_causal_lm_loss(hidden, pipeline_head_matrix(net), ids[m],
                                                    mask, loss_chunk)
                else:
                    ls, nt = causal_lm_loss(net.logits(hidden), ids[m], mask)
                objective = ls if scale is None else ls * scale
            got = torch.autograd.grad(objective, [ym, *shared], allow_unused=True)
            gy[m] = got[0]
            for n, g in zip(shared_names, got[1:]):
                if g is not None:
                    grads[n] += g.float()
            loss_sum += ls.detach()
            n_tok += nt

        # The backward schedule, ticks in reverse.
        stage_leaves = [trainable[n] for n in stage_names]
        dx = torch.zeros_like(sched.x) if (k == 0 and sched.x.requires_grad) else None
        g_next = torch.zeros_like(y[0])
        for t in reversed(range(M + P - 1)):
            send = None
            if t in stash:
                inp, out, a, m = stash.pop(t)
                g_out = g_next + gy[m] if k == P - 1 else g_next
                outs, gouts = [out], [g_out]
                if a is not None:
                    w = coef * n_tok_m[m]
                    outs.append(a)
                    gouts.append(w if scale is None else w * scale)
                wrt = stage_leaves + ([inp] if inp.requires_grad else [])
                got = torch.autograd.grad(outs, wrt, gouts, allow_unused=True)
                for n, g in zip(stage_names, got):
                    if g is not None:
                        grads[n] += g.float()
                if inp.requires_grad:
                    if k == 0:
                        dx[m] = got[-1]
                    else:
                        send = got[-1]
                del inp, out, a, got
            if send is None:
                send = torch.zeros_like(g_next)
            g_next = permute_(send, -1, pipe)
        if lm.fetcher is not None:
            lm.fetcher.end()
        if sched.x.requires_grad:
            # The embedding's gradient from stage 0's inputs, on every stage.
            dx = all_reduce_(dx if dx is not None else torch.zeros_like(sched.x), pipe)
            emb = [trainable[n] for n in shared_names]
            got = torch.autograd.grad(sched.x, emb, dx, allow_unused=True)
            for n, g in zip(shared_names, got):
                if g is not None:
                    grads[n] += g.float()

        # This stage's layers' router losses, summed over the stages.
        aux_sum = all_reduce_((aux * n_tok_m).sum(), pipe) if moe else torch.zeros_like(n_tok)
        grad_list = [grads[n] for n in names]
        if mesh.distributed:
            totals = all_reduce_(torch.stack([loss_sum, n_tok, aux_sum]), mesh.batch)
            loss_sum, n_tok, aux_sum = totals[0], totals[1], totals[2]
            grad_list = [owned_grad(g, n, layout) for n, g in zip(names, grad_list)]
        return finish_step(state, names, grad_list, loss_sum, n_tok, aux_sum, moe=moe,
                           fp16_scale_window=fp16_scale_window, fp16_min_scale=fp16_min_scale,
                           fp16_hysteresis=fp16_hysteresis)

    return device_step


def make_pipeline_eval_step(model, loss_chunk: int = 0):
    """Build ``eval_step(state, batch) -> {"loss", "num_tokens"}`` on a
    stage's model: :func:`pipeline_forward` of the whole ``(rows, seq)``
    eval batch as one microbatch (the bubble does not matter at eval
    cadence), deterministic, ``loss_chunk`` as in the train step; the sums
    are all-reduced over the batch axes."""
    from dlti_tpu_torch.training.step import causal_lm_loss, chunked_causal_lm_loss

    @torch.no_grad()
    def eval_step(state, batch: Dict[str, torch.Tensor]) -> dict:
        mesh = state.layout.mesh
        ids = batch["input_ids"]
        out = pipeline_forward(state.model, ids, mesh, num_microbatches=1,
                               positions=batch.get("positions"),
                               segment_ids=batch.get("segment_ids"),
                               return_hidden=bool(loss_chunk))
        if loss_chunk:
            loss_sum, n_tok = chunked_causal_lm_loss(out, pipeline_head_matrix(state.model),
                                                     ids, batch.get("loss_mask"), loss_chunk)
        else:
            loss_sum, n_tok = causal_lm_loss(out, ids, batch.get("loss_mask"))
        if mesh.distributed:
            totals = all_reduce_(torch.stack([loss_sum, n_tok.float()]), mesh.batch)
            loss_sum, n_tok = totals[0], totals[1]
        return {"loss": loss_sum / torch.clamp(n_tok, min=1.0), "num_tokens": n_tok}

    return eval_step
