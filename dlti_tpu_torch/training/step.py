"""The train step: the port of ``dlti_tpu/training/step.py``'s bf16 path
(``causal_lm_loss``, ``chunked_causal_lm_loss``, ``guard_nonfinite_update``,
``make_train_step``, ``make_multi_step``, ``make_eval_step``).

One optimizer step: forward and backward over each microbatch of the
leading ``accum`` axis with float32 gradient accumulation, the token-mean
loss (gradients divided by the total token count), the optimizer (clip +
AdamW), and the metrics ``loss``, ``grad_norm`` (before clipping),
``num_tokens``, ``nonfinite`` and ``skipped_update``, as 0-d tensors on the
device. A step whose loss or gradient norm is not finite leaves the
parameters and the optimizer state (its count, and with it the schedule) as
they were; the step count still advances. Nothing in a step reads the
device back, so it can be captured as a CUDA graph: :class:`StepWindow`
does that on the card, the counterpart of the reference's
``make_multi_step``, and runs a window of steps with one host
synchronisation. The fp16 loss scaler is not ported (``Trainer`` refuses
it); the MoE aux loss is not ported either, and a MoE model raises here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dlti_tpu_torch.models.llama import lm_head_logits
from dlti_tpu_torch.ops.launches import GraphLaunches
from dlti_tpu_torch.training.optimizer import global_norm
from dlti_tpu_torch.training.state import TrainState
from dlti_tpu_torch.utils.device import upload
from dlti_tpu_torch.utils.hashing import MASK32, fold_seed, mix32

# The per-step metrics, in the column order of StepWindow.run's output.
METRICS = ("loss", "grad_norm", "num_tokens", "nonfinite", "skipped_update")


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
    ``skipped_update`` (float32 0/1). Reads nothing back to the host: the
    optimizer applies ``finite`` with ``torch.where``."""
    finite = torch.isfinite(grad_norm) & torch.isfinite(loss)
    bad = (~finite).float()
    return finite, {"nonfinite": bad, "skipped_update": bad}


def step_seed(seed: int, step):
    """The dropout key of optimizer step ``step`` (1-based; an int, or a
    0-d int64 tensor on the device) in a run seeded with ``seed``: a 32-bit
    key of the same type as ``step``, depending on (seed, step) alone, as
    the reference folds the step index into ``PRNGKey(seed)``."""
    return mix32(fold_seed(seed) ^ (step & MASK32))


def _loss(model, batch: dict, dropout_seed, loss_chunk: int) -> tuple:
    """(sum of token losses, token count) of one ``(rows, seq)`` batch."""
    ids = batch["input_ids"]
    kw = dict(positions=batch.get("positions"), segment_ids=batch.get("segment_ids"),
              dropout_seed=dropout_seed)
    if loss_chunk:
        hidden = model(ids, return_hidden=True, **kw)
        return chunked_causal_lm_loss(hidden, model.head_matrix(), ids,
                                      batch.get("loss_mask"), loss_chunk)
    return causal_lm_loss(model(ids, **kw), ids, batch.get("loss_mask"))


def make_device_step(model, *, accum_steps: int = 1, loss_chunk: int = 0) -> Callable:
    """Build ``device_step(state, batch, step_seed) -> metrics``: one
    optimizer step that updates the parameters and optimizer state in place
    and returns :data:`METRICS` as 0-d tensors, without touching
    ``state.step`` and without reading the device back. ``batch`` holds
    tensors on the model's device shaped (accum, micro_bs, seq):
    ``input_ids`` and optionally ``loss_mask``, ``positions``,
    ``segment_ids``. ``step_seed`` (a 32-bit key: an int, or a 0-d int64
    tensor on the device, see :func:`step_seed`) seeds the LoRA dropout
    masks, one key per microbatch derived from it; None runs without
    dropout. ``loss_chunk`` > 0 takes :func:`chunked_causal_lm_loss`."""
    if model.cfg.num_experts > 0:
        raise NotImplementedError("MoE training is not ported yet (see ROADMAP.md)")

    def device_step(state: TrainState, batch: Dict[str, torch.Tensor],
                    step_seed) -> dict:
        trainable = state.trainable()
        names = list(trainable)
        leaves = [trainable[n] for n in names]
        dev = leaves[0].device
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        n_tok = torch.zeros((), dtype=torch.float32, device=dev)
        for a in range(accum_steps):
            micro = {k: v[a] for k, v in batch.items()}
            seed = None if step_seed is None else mix32(step_seed ^ mix32(a + 0x3C6EF372))
            ls, nt = _loss(state.model, micro, seed, loss_chunk)
            for acc, g in zip(grads, torch.autograd.grad(ls, leaves)):
                acc += g.float()
            loss_sum += ls.detach()
            n_tok += nt
        # Token-mean loss over the whole step (HF Trainer's semantics under
        # grad accumulation).
        n_tok = torch.clamp(n_tok, min=1.0)
        grads = {n: g / n_tok for n, g in zip(names, grads)}
        loss = loss_sum / n_tok
        grad_norm = global_norm(grads)
        finite, extra = guard_nonfinite_update(grad_norm, loss)
        state.tx.update(grads, state.opt_state, trainable, apply=finite)
        return {"loss": loss, "grad_norm": grad_norm, "num_tokens": n_tok, **extra}

    return device_step


def make_train_step(model, *, accum_steps: int = 1, loss_chunk: int = 0) -> Callable:
    """Build ``train_step(state, batch, step_seed) -> metrics``: one
    :func:`make_device_step` step, then ``state.step += 1``. The metrics
    stay on the device."""
    device_step = make_device_step(model, accum_steps=accum_steps, loss_chunk=loss_chunk)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], step_seed) -> dict:
        metrics = device_step(state, batch, step_seed)
        state.step += 1
        return metrics

    return train_step


def make_eval_step(model, loss_chunk: int = 0) -> Callable:
    """Build ``eval_step(state, batch) -> {"loss", "num_tokens"}`` (0-d
    tensors): the token-mean loss of one ``(rows, seq)`` batch, no dropout,
    no update, ``loss_chunk`` as in the train step (a run that needs it to
    fit must not run out of memory at its first eval)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor]) -> dict:
        loss_sum, n_tok = _loss(state.model, batch, None, loss_chunk)
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
    ``(capacity, len(METRICS))`` output. Each replay reads its step's
    batch, writes its metrics row and advances the index and the step
    number, so the window is ``k`` replays. Before the capture one eager
    step on a side stream builds what a first call builds lazily (the
    kernel library, cuBLAS state, RoPE tables); the state it updated is
    then put back. The capture itself runs nothing: the launch counters it
    moved are put back, and each replay is credited with them. A batch of
    another shape, or a window longer than ``capacity``, captures again.

    ``cuda_graphs=False`` (and every CPU run) runs the same steps eagerly,
    one after the other: the CPU path, and on the card the graph's
    yardstick (tests and ``chip_smoke.py`` only).
    """

    def __init__(self, model, *, accum_steps: int = 1, loss_chunk: int = 0,
                 seed: Optional[int] = None, capacity: int = 1,
                 cuda_graphs: bool = True):
        self.device_step = make_device_step(model, accum_steps=accum_steps,
                                            loss_chunk=loss_chunk)
        self.seed = seed
        self.capacity = max(1, capacity)
        self.device = next(model.parameters()).device
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
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
        ``(k, len(METRICS))`` float32 on the device (on the card a view of
        the static output, valid until the next window)."""
        k = len(batches)
        if not self.cuda_graphs:
            rows = []
            for i, hb in enumerate(batches):
                batch = {key: upload(np.ascontiguousarray(v), self.device)
                         for key, v in hb.items()}
                m = self.device_step(state, batch, self._seed(first_step + i))
                rows.append(torch.stack([m[name] for name in METRICS]))
                state.step += 1
            return torch.stack(rows)
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
        self._out = torch.zeros((capacity, len(METRICS)), dtype=torch.float32, device=dev)

    def _body(self, state: TrainState) -> None:
        """One step from the static buffers, in place (what the graph holds)."""
        batch = {key: buf.index_select(0, self._slot)[0] for key, buf in self._inputs.items()}
        m = self.device_step(state, batch, self._seed(self._step_no))
        self._out.index_copy_(0, self._slot, torch.stack([m[n] for n in METRICS])[None])
        self._slot.add_(1)
        self._step_no.add_(1)

    def _capture(self, state: TrainState) -> None:
        opt = state.opt_state
        kept: List[torch.Tensor] = [*state.trainable().values(), *opt.mu.values(),
                                    *opt.nu.values(), opt.count]
        with torch.cuda.device(self.device), torch.no_grad():
            saved = [t.clone() for t in kept]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), torch.enable_grad():
                self._body(state)  # the warm-up step
            torch.cuda.current_stream().wait_stream(side)
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
