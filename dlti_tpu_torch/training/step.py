"""The train step: the port of ``dlti_tpu/training/step.py``
(``causal_lm_loss``, ``chunked_causal_lm_loss``, ``apply_loss_scaler``,
``guard_nonfinite_update``, ``make_train_step``, ``make_multi_step``,
``make_eval_step``).

One optimizer step: forward and backward over each microbatch of the
leading ``accum`` axis with float32 gradient accumulation, the token-mean
loss (gradients divided by the total token count), the optimizer (clip +
AdamW), and the metrics :data:`METRICS` as 0-d tensors on the device:
``loss``, ``grad_norm`` (before clipping), ``num_tokens``, ``nonfinite``,
``skipped_update``, ``loss_scale`` and ``overflow``.

bf16 and float32 runs (no scaler): a step whose loss or gradient norm is
not finite leaves the parameters and the optimizer state (its count, and
with it the schedule) as they were; ``loss_scale`` is 1 and ``overflow`` 0.
fp16 runs (``state.scaler``, DeepSpeed's dynamic loss scaler): each
microbatch's objective is multiplied by the scale before the backward and
the float32 gradients are divided by ``tokens * scale``; a step whose
gradient norm alone is not finite overflows, skips its update the same
way, and the scaler (:func:`apply_loss_scaler`) absorbs it into its
hysteresis or halves the scale; ``nonfinite`` and ``skipped_update`` equal
``overflow``. Either way the step count still advances.

Nothing in a step reads the device back, and the scale is read from its
0-d tensor, so a step can be captured as a CUDA graph: :class:`StepWindow`
does that on the card, the counterpart of the reference's
``make_multi_step``, and runs a window of steps with one host
synchronisation.

A mixture of experts (``cfg.num_experts`` > 0) adds its router's
load-balance loss to the objective, ``loss_sum + router_aux_loss_coef *
aux * tokens`` a microbatch (``aux`` the sum of the layers' losses), and
reports it apart as ``aux_loss`` (the token-weighted mean of ``aux``;
:data:`MOE_METRICS`): ``loss`` stays the pure cross entropy. An unpacked
batch's ``loss_mask`` is its padding mask and keeps padding out of the
routing; a packed batch's padding comes from its ``segment_ids``.
``loss_chunk`` does not compose with it and raises, as in the reference.

Data parallelism (the state's ``parallel.sharding.Layout`` has a mesh with
a process group): each rank runs its rows of every microbatch, drawing LoRA dropout
for them by their global row numbers; the token count and the loss sum are
all-reduced before they divide, so loss and gradients are the global token
mean; each gradient is all-reduced or reduce-scattered to the part this
rank owns (``parallel.sharding.owned_grad``; ZeRO-3's sharded leaves
reduce-scatter in the backward); the norm is the whole gradient's, equal on
every rank, so the bf16 guard and the fp16 scaler take the same decision
everywhere. In fp16 each microbatch's gradients are summed over the ranks
and rounded to float16 (``parallel.sharding.reduce_in_dtype``), where the
reference's sharded step sums its float16 partial products: a sum past
float16's range overflows on every rank as on one device, so the scaler
skips the steps a single device skips. The collectives run synchronously on the current stream, inside
the CUDA graph on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dlti_tpu_torch.models.llama import lm_head_logits
from dlti_tpu_torch.ops.launches import GraphLaunches
from dlti_tpu_torch.parallel.sharding import (
    all_reduce_, owned_grad, reduce_in_dtype, sharded_sq_norm,
)
from dlti_tpu_torch.training.state import TrainState
from dlti_tpu_torch.utils.device import resolve_dtype, upload
from dlti_tpu_torch.utils.hashing import MASK32, fold_seed, mix32

# The per-step metrics, in the column order of StepWindow.run's output; a
# mixture of experts adds its load-balance loss.
METRICS = ("loss", "grad_norm", "num_tokens", "nonfinite", "skipped_update",
           "loss_scale", "overflow")
MOE_METRICS = METRICS + ("aux_loss",)


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                   loss_mask: Optional[torch.Tensor] = None) -> tuple:
    """Next-token cross-entropy: returns (sum of token losses, token count),
    labels being the inputs shifted left, masked by ``loss_mask[:, 1:]``."""
    targets = input_ids[:, 1:].long()
    logits = logits[:, :-1, :].float()
    mask = _shifted_mask(targets, loss_mask)
    token_loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1), reduction="none")
    return (token_loss.reshape(targets.shape) * mask).sum(), mask.sum()


def _shifted_mask(targets: torch.Tensor, loss_mask: Optional[torch.Tensor]):
    if loss_mask is None:
        return torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    return loss_mask[:, 1:].float()


def _chunk_loss(x, head, targets, mask):
    logits = lm_head_logits(x, head)
    tl = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                         reduction="none")
    return (tl.reshape(targets.shape) * mask).sum()


def chunked_causal_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                           input_ids: torch.Tensor,
                           loss_mask: Optional[torch.Tensor] = None,
                           chunk: int = 128) -> tuple:
    """:func:`causal_lm_loss` from the final hidden state ``(B, S, H)`` and
    the ``(H, V)`` head, without ever building ``(B, S, V)`` logits: the
    head GEMM (:func:`lm_head_logits`, float32 output) and the cross-entropy
    run per sequence chunk of ``chunk`` positions, the tail padded with
    masked rows, each chunk under ``torch.utils.checkpoint`` so the backward
    recomputes its logits instead of keeping them. The same function as the
    unchunked loss up to summation order."""
    x = hidden[:, :-1, :]
    targets = input_ids[:, 1:].long()
    mask = _shifted_mask(targets, loss_mask)
    s1 = x.shape[1]
    pad = -(-s1 // chunk) * chunk - s1
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s1 + pad, chunk):
        args = (x[:, lo:lo + chunk], head, targets[:, lo:lo + chunk],
                mask[:, lo:lo + chunk])
        if torch.is_grad_enabled():
            loss_sum = loss_sum + checkpoint(_chunk_loss, *args, use_reentrant=False,
                                             preserve_rng_state=False)
        else:
            loss_sum = loss_sum + _chunk_loss(*args)
    return loss_sum, mask.sum()


def guard_nonfinite_update(grad_norm: torch.Tensor, loss: torch.Tensor) -> tuple:
    """The bf16 path's nonfinite gate: ``(finite, metrics)``, where
    ``finite`` (a 0-d bool tensor) says whether the update may be applied
    (loss and grad norm finite) and the metrics are ``nonfinite`` and
    ``skipped_update`` (float32 0/1), with ``loss_scale`` 1 and ``overflow``
    0 (no scaler). Reads nothing back to the host: the optimizer applies
    ``finite`` with ``torch.where``."""
    finite = torch.isfinite(grad_norm) & torch.isfinite(loss)
    bad = (~finite).float()
    return finite, {"nonfinite": bad, "skipped_update": bad,
                    "loss_scale": torch.ones_like(grad_norm),
                    "overflow": torch.zeros_like(grad_norm)}


def apply_loss_scaler(scaler: Dict[str, torch.Tensor], grad_norm: torch.Tensor, *,
                      scale_window: int, min_scale: float, hysteresis: int) -> tuple:
    """DeepSpeed's dynamic fp16 loss-scaler update (the reference's
    ``apply_loss_scaler``): ``(finite, metrics)``. ``finite`` (a 0-d bool
    tensor, the gradient norm alone) says whether the update may be
    applied. On an overflow the hysteresis budget absorbs it first, then
    the scale halves (not below ``min_scale``); after ``scale_window``
    consecutive good steps the scale doubles; any change of the scale
    re-arms the hysteresis. ``scaler``'s three tensors are updated in place
    (``torch.where(..., out=)``), so a CUDA graph that captured the update
    advances them on every replay. The metrics are ``loss_scale`` (the new
    scale) and ``overflow``, ``nonfinite`` and ``skipped_update`` (float32
    0/1, all three the same)."""
    finite = torch.isfinite(grad_norm)
    scale, good, hyst = scaler["scale"], scaler["good_steps"], scaler["hysteresis_left"]
    hyst_after = torch.where(finite, hyst, torch.clamp(hyst - 1, min=0))
    shrink = ~finite & (hyst <= 1)
    scale_after = torch.where(shrink, torch.clamp(scale * 0.5, min=min_scale), scale)
    good_after = torch.where(finite, good + 1, torch.zeros_like(good))
    grow = good_after >= scale_window
    torch.where(grow, scale_after * 2.0, scale_after, out=scale)
    torch.where(grow, torch.zeros_like(good), good_after, out=good)
    torch.where(shrink | grow, torch.full_like(hyst, hysteresis), hyst_after, out=hyst)
    bad = (~finite).float()
    return finite, {"loss_scale": scale.clone(), "overflow": bad, "nonfinite": bad,
                    "skipped_update": bad}


def step_seed(seed: int, step):
    """The dropout key of optimizer step ``step`` (1-based; an int, or a
    0-d int64 tensor on the device) in a run seeded with ``seed``: a 32-bit
    key of the same type as ``step``, depending on (seed, step) alone, as
    the reference folds the step index into ``PRNGKey(seed)``."""
    return mix32(fold_seed(seed) ^ (step & MASK32))


def _loss(model, batch: dict, dropout_seed, loss_chunk: int, rank: int = 0,
          moe_aux: bool = False) -> tuple:
    """(sum of token losses, token count) of one ``(rows, seq)`` batch, rank
    ``rank``'s rows of its microbatch (dropout rows numbered from
    ``rank * rows * seq``); with ``moe_aux`` a third entry, the sum of the
    layers' load-balance losses, the batch's padding kept out of the
    routing by its ``loss_mask`` when the rows are not packed."""
    ids = batch["input_ids"]
    kw = dict(positions=batch.get("positions"), segment_ids=batch.get("segment_ids"),
              dropout_seed=dropout_seed, dropout_row_offset=rank * ids.numel())
    if moe_aux:
        mask = batch.get("loss_mask") if batch.get("segment_ids") is None else None
        logits, aux = model(ids, token_mask=mask, return_aux=True, **kw)
        return (*causal_lm_loss(logits, ids, batch.get("loss_mask")), aux)
    if loss_chunk:
        hidden = model(ids, return_hidden=True, **kw)
        return chunked_causal_lm_loss(hidden, model.head_matrix(), ids,
                                      batch.get("loss_mask"), loss_chunk)
    return causal_lm_loss(model(ids, **kw), ids, batch.get("loss_mask"))


def make_device_step(model, *, accum_steps: int = 1, loss_chunk: int = 0,
                     fp16_scale_window: int = 1000, fp16_min_scale: float = 1.0,
                     fp16_hysteresis: int = 2) -> Callable:
    """Build ``device_step(state, batch, step_seed) -> metrics``: one
    optimizer step that updates the parameters, optimizer state and (fp16)
    scaler in place and returns :data:`METRICS` as 0-d tensors, without
    touching ``state.step`` and without reading the device back. ``batch``
    holds tensors on the model's device shaped (accum, micro_bs, seq):
    ``input_ids`` and optionally ``loss_mask``, ``positions``,
    ``segment_ids``. ``step_seed`` (a 32-bit key: an int, or a 0-d int64
    tensor on the device, see :func:`step_seed`) seeds the LoRA dropout
    masks, one key per microbatch derived from it; None runs without
    dropout. ``loss_chunk`` > 0 takes :func:`chunked_causal_lm_loss`. With
    ``state.scaler`` the loss is scaled and the ``fp16_*`` settings drive
    :func:`apply_loss_scaler`. Under data parallelism (``state.layout``)
    ``batch`` is this rank's rows; see the module docstring. A mixture of
    experts adds ``aux_loss`` to the metrics."""
    cfg = model.cfg
    moe_coef = cfg.router_aux_loss_coef if cfg.num_experts > 0 else 0.0
    if loss_chunk and cfg.num_experts > 0:
        raise ValueError("loss_chunk does not compose with MoE aux-loss collection; "
                         "set train.loss_chunk=0 for MoE models")
    if loss_chunk and model.model.tp is not None:
        raise NotImplementedError("loss_chunk under tensor parallelism (a chunked loss "
                                  "over a vocabulary-split head) is not ported yet "
                                  "(see ROADMAP.md)")

    def device_step(state: TrainState, batch: Dict[str, torch.Tensor],
                    step_seed) -> dict:
        layout = state.layout
        batch_axis = layout.mesh.batch
        dp = layout.mesh.distributed
        trainable = state.trainable()
        names = list(trainable)
        leaves = [trainable[n] for n in names]
        dev = leaves[0].device
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        n_tok = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        scaler = state.scaler
        # fp16 across ranks: each microbatch's gradients are summed over the
        # ranks in float16 (reduce_in_dtype), where the reference reduces
        # them, so an overflow of the whole batch's sum is seen everywhere.
        half_sums = dp and scaler is not None
        compute = resolve_dtype(state.model.cfg.dtype)
        for a in range(accum_steps):
            micro = {k: v[a] for k, v in batch.items()}
            seed = None if step_seed is None else mix32(step_seed ^ mix32(a + 0x3C6EF372))
            parts = _loss(state.model, micro, seed, loss_chunk, batch_axis.rank,
                          moe_aux=cfg.num_experts > 0)
            ls, nt = parts[0], parts[1]
            objective = ls
            if cfg.num_experts > 0:
                # The microbatch's aux weighted by its tokens: the step's
                # division by the tokens leaves its token-weighted mean.
                objective = ls + moe_coef * parts[2] * nt
                aux_sum += parts[2].detach() * nt
            if scaler is not None:
                objective = objective * scaler["scale"]
            for n, acc, g in zip(names, grads, torch.autograd.grad(objective, leaves)):
                g = g.float()
                acc += reduce_in_dtype(g, n, layout, compute) if half_sums else g
            loss_sum += ls.detach()
            n_tok += nt
        if dp:  # the global sums, then each gradient's part this rank owns
            totals = all_reduce_(torch.stack([loss_sum, n_tok, aux_sum]), batch_axis)
            loss_sum, n_tok, aux_sum = totals[0], totals[1], totals[2]
            grads = [owned_grad(g, n, layout, summed=half_sums)
                     for n, g in zip(names, grads)]
        # Token-mean loss over the whole step (HF Trainer's semantics under
        # grad accumulation); the gradients also lose the fp16 loss scale.
        n_tok = torch.clamp(n_tok, min=1.0)
        denom = n_tok if scaler is None else n_tok * scaler["scale"]
        grads = {n: g / denom for n, g in zip(names, grads)}
        loss = loss_sum / n_tok
        grad_norm = torch.sqrt(sharded_sq_norm(grads, layout))
        if scaler is None:
            finite, extra = guard_nonfinite_update(grad_norm, loss)
        else:
            finite, extra = apply_loss_scaler(
                scaler, grad_norm, scale_window=fp16_scale_window,
                min_scale=fp16_min_scale, hysteresis=fp16_hysteresis)
        state.tx.update(grads, state.opt_state, trainable, apply=finite, layout=layout,
                        norm=grad_norm)
        metrics = {"loss": loss, "grad_norm": grad_norm, "num_tokens": n_tok, **extra}
        if cfg.num_experts > 0:
            metrics["aux_loss"] = aux_sum / n_tok
        return metrics

    return device_step


def make_train_step(model, *, accum_steps: int = 1, loss_chunk: int = 0,
                    **fp16) -> Callable:
    """Build ``train_step(state, batch, step_seed) -> metrics``: one
    :func:`make_device_step` step (``fp16``: its ``fp16_*`` settings), then
    ``state.step += 1``. The metrics stay on the device."""
    device_step = make_device_step(model, accum_steps=accum_steps, loss_chunk=loss_chunk,
                                   **fp16)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], step_seed) -> dict:
        metrics = device_step(state, batch, step_seed)
        state.step += 1
        return metrics

    return train_step


def make_eval_step(model, loss_chunk: int = 0) -> Callable:
    """Build ``eval_step(state, batch) -> {"loss", "num_tokens"}`` (0-d
    tensors): the token-mean loss of one ``(rows, seq)`` batch, no dropout,
    no update, ``loss_chunk`` as in the train step (a run that needs it to
    fit must not run out of memory at its first eval). Under data
    parallelism ``batch`` is this rank's rows and the sums are all-reduced."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> dict:
        loss_sum, n_tok = _loss(state.model, batch, None, loss_chunk)
        mesh = state.layout.mesh
        if mesh.distributed:
            totals = all_reduce_(torch.stack([loss_sum, n_tok.float()]), mesh.batch)
            loss_sum, n_tok = totals[0], totals[1]
        return {"loss": loss_sum / torch.clamp(n_tok, min=1.0), "num_tokens": n_tok}

    return eval_step


def batch_signature(batch: dict) -> tuple:
    """A host batch's keys, shapes and dtypes: batches with equal
    signatures stack into one window and share one captured graph."""
    return tuple(sorted((k, v.shape, v.dtype.str) for k, v in batch.items()))


class StepWindow:
    """Runs windows of train steps with one host synchronisation a window:
    :meth:`run` returns the window's metrics on the device and waits on
    nothing, and the caller reads them once.

    On the card (``cuda_graphs``, the default) one whole optimizer step
    (every microbatch's forward and backward, the clip and AdamW) is
    captured once as a CUDA graph over static buffers: the window's host
    batches, stacked in pinned memory and copied without blocking into
    ``(capacity, accum, micro_bs, seq)`` inputs, a device index of the
    step within the window, the step number that seeds dropout, and a
    ``(capacity, len(metrics))`` output (:attr:`metrics`: :data:`METRICS`,
    or :data:`MOE_METRICS` for a mixture of experts). Each replay reads its step's
    batch, writes its metrics row and advances the index and the step
    number, so the window is ``k`` replays. Before the capture one eager
    step on a side stream builds what a first call builds lazily (the
    kernel library, cuBLAS state, RoPE tables); the state it updated is
    then put back. The capture itself runs nothing: the launch counters it
    moved are put back, and each replay is credited with them. A batch of
    another shape, or a window longer than ``capacity``, captures again.

    ``cuda_graphs=False`` (and every run on the CPU, whatever it asks)
    runs the same steps eagerly, one after the other: the CPU path, and on
    the card the graph's yardstick (tests and ``chip_smoke.py`` only). The
    computing device is the state's mesh's (an offloaded frozen leaf rests
    on the host). ``fp16`` takes :func:`make_device_step`'s ``fp16_*``
    settings.
    """

    def __init__(self, model, *, accum_steps: int = 1, loss_chunk: int = 0,
                 seed: Optional[int] = None, capacity: int = 1,
                 cuda_graphs: bool = True, **fp16):
        self.device_step = make_device_step(model, accum_steps=accum_steps,
                                            loss_chunk=loss_chunk, **fp16)
        self.metrics = MOE_METRICS if model.cfg.num_experts > 0 else METRICS
        self.seed = seed
        self.capacity = max(1, capacity)
        self.cuda_graphs = cuda_graphs
        self.device: Optional[torch.device] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = GraphLaunches()
        self.captures = 0
        self._signature: Optional[tuple] = None
        self._inputs: Dict[str, torch.Tensor] = {}
        self._slot = self._step_no = self._out = None

    def run(self, state: TrainState, batches: Sequence[dict], first_step: int
            ) -> torch.Tensor:
        """Steps ``first_step`` .. ``first_step + k - 1`` (1-based) on the
        ``k`` host batches (numpy dicts shaped (accum, micro_bs, seq), all of
        one shape); advances ``state.step`` by ``k``. Returns the metrics,
        ``(k, len(self.metrics))`` float32 on the device (on the card a view of
        the static output, valid until the next window)."""
        k = len(batches)
        self.device = state.layout.mesh.device
        if not (self.cuda_graphs and self.device.type == "cuda"):
            rows = []
            for i, hb in enumerate(batches):
                batch = {key: upload(np.ascontiguousarray(v), self.device)
                         for key, v in hb.items()}
                m = self.device_step(state, batch, self._seed(first_step + i))
                rows.append(torch.stack([m[name] for name in self.metrics]))
                state.step += 1
            return torch.stack(rows)
        mesh = state.layout.mesh
        if mesh.distributed and dist.get_backend(mesh.group) != "nccl":
            raise ValueError(f"the train-step graph captures the step's collectives, which "
                             f"needs NCCL; the group runs {dist.get_backend(mesh.group)}: "
                             "run the steps eagerly (cuda_graphs=False)")
        sig = batch_signature(batches[0])
        fresh = self.graph is None or sig != self._signature or k > self.capacity
        if fresh:
            self._allocate(batches[0], max(k, self.capacity), sig)
        for key, buf in self._inputs.items():
            upload(np.stack([hb[key] for hb in batches]), self.device, out=buf[:k])
        upload(np.asarray(first_step, dtype=np.int64), self.device, out=self._step_no)
        self._slot.zero_()
        if fresh:
            self._capture(state)
        with torch.cuda.device(self.device):
            for _ in range(k):
                self.graph.replay()
        self.launches.credit(k)
        state.step += k
        return self._out[:k]

    def release(self) -> None:
        """Drop the graph (and with it its memory pool) and the buffers."""
        self.graph = None
        self._signature = None
        self._inputs = {}
        self._slot = self._step_no = self._out = None

    def _seed(self, step):
        return None if self.seed is None else step_seed(self.seed, step)

    def _allocate(self, batch: dict, capacity: int, sig: tuple) -> None:
        self.release()
        dev = self.device
        self.capacity, self._signature = capacity, sig
        self._inputs = {key: torch.empty((capacity,) + v.shape,
                                         dtype=torch.from_numpy(v[:0]).dtype, device=dev)
                        for key, v in batch.items()}
        self._slot = torch.zeros((1,), dtype=torch.long, device=dev)
        self._step_no = torch.zeros((), dtype=torch.long, device=dev)
        self._out = torch.zeros((capacity, len(self.metrics)), dtype=torch.float32,
                                device=dev)

    def _body(self, state: TrainState) -> None:
        """One step from the static buffers, in place (what the graph holds)."""
        batch = {key: buf.index_select(0, self._slot)[0] for key, buf in self._inputs.items()}
        m = self.device_step(state, batch, self._seed(self._step_no))
        self._out.index_copy_(0, self._slot,
                              torch.stack([m[n] for n in self.metrics])[None])
        self._slot.add_(1)
        self._step_no.add_(1)

    def _capture(self, state: TrainState) -> None:
        opt = state.opt_state
        kept: List[torch.Tensor] = [*state.trainable().values(), *opt.mu.values(),
                                    *opt.nu.values(), opt.count,
                                    *(state.scaler or {}).values()]
        with torch.cuda.device(self.device), torch.no_grad():
            # Offloaded moments are host tensors the card writes without
            # blocking: settle those writes before the host reads or
            # restores them.
            torch.cuda.synchronize(self.device)
            saved = [t.clone() for t in kept]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), torch.enable_grad():
                self._body(state)  # the warm-up step
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize(self.device)
            for t, s in zip(kept, saved):
                t.copy_(s)
            del saved
            self._slot.zero_()
            self._step_no.sub_(1)
            graph = torch.cuda.CUDAGraph()
            with self.launches.capturing(), torch.cuda.graph(graph), torch.enable_grad():
                self._body(state)
        self.graph = graph
        self.captures += 1
