"""Mixture-of-Experts MLP: the port of ``dlti_tpu/models/moe.py``
(``MoEMLP``, ``collect_aux_loss``).

Mixtral-style top-k routed SwiGLU experts in the reference's GShard/Switch
form: every shape is static, and the only effect of the data is which
tokens an expert's fixed capacity drops.

* **Router.** A float32 ``(h, E)`` product with full float32 accumulation
  (never TF32), softmax, and the top ``k`` probabilities with lower expert
  indices first on ties, as ``lax.top_k`` breaks them (``k`` passes of
  ``argmax``, which returns the first maximum); the ``k`` weights are
  renormalised (Mixtral) and multiplied by ``valid``, the token mask.
* **Capacity.** ``C = max(int(capacity_factor * T * k / E), 1)`` with ``T``
  the tokens of the call (every data-parallel rank's together). Each
  (token, slot) assignment takes a rank inside its expert, counted
  slot-major: every token's first choice before any token's second.
  Padding takes no rank; an assignment ranked ``C`` or later is dropped.
* **Dispatch and combine** without one-hot products and without atomics:
  slot ``j`` writes each token's row to its ``(expert, rank)`` row of a
  buffer (``index_put``; the rows of slot ``j`` are distinct, a dropped
  assignment writes a row of its own past the experts'), the experts run
  over ``(E, C, h)`` as three batched products, and the combine gathers
  each slot's row back and sums the ``k`` weighted rows in float32. The
  backward of every step is a gather or an elementwise op, so it is
  deterministic: a CUDA graph replays the eager step's bits.
* **Load-balance loss** ``E * sum_e f_e * P_e`` over valid tokens (Switch
  eq. 4 with Mixtral's k normalisation): ``f_e`` the share of assignments
  routed to expert ``e``, ``P_e`` its mean router probability. Computed
  only when asked for (training); :func:`collect_aux_loss` sums a forward's
  per-layer values.

int8 expert weights (``models.quantization.QuantizedWeight`` of ``(E, h,
m)`` with ``(E, 1, m)`` scales) are expanded at their use, one at a time,
and a differentiable forward keeps only the int8 payloads for its backward
(:class:`_Int8Experts`): a layer's 2.8 GB of expanded Mixtral experts never
outlive the layer, in the remat recompute and the backward too.

Under data or expert parallelism ``parallel.sharding.shard_model`` sets
:attr:`MoEMLP.groups` (a ``parallel.sharding.MoEGroups``): the
per-(slot, expert) counts of every batch rank are all-gathered to offset
this rank's ranks and the aux loss's sums are all-reduced, so capacity and
the loss are the global microbatch's, as the reference's one program sees
it; with the experts split over the ``expert`` axis each rank routes every
token, runs only its own experts, and the partial combine is summed over
the expert group. Under tensor parallelism (:attr:`MoEMLP.tp`) each rank
holds its part of every expert's hidden units (``w1``/``w3`` split on dim
2, ``w2`` on dim 1) and routes every token as every other rank does (the
router and its input are whole, so routing, capacity and the aux loss are
bit-equal across ranks); the tokens and combine weights enter through the
tensor group's copy and the combined output is summed over it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dlti_tpu_torch.config import ModelConfig
from dlti_tpu_torch.models.quantization import QuantizedWeight, dequantize
from dlti_tpu_torch.parallel.tensor import copy_in, reduce_out
from dlti_tpu_torch.utils.device import resolve_dtype

# The reference's error for LoRA targets on a mixture of experts' MLP.
MLP_TARGETS = ("gate_proj", "up_proj", "down_proj")


def check_lora_targets(lora) -> None:
    """Raise the reference's error when ``lora`` targets an MLP projection
    of a mixture-of-experts model (its experts have no adapter branch)."""
    if lora is not None and lora.enabled and any(
            t in MLP_TARGETS for t in lora.target_modules):
        raise NotImplementedError(
            "LoRA on MLP projections is not supported for MoE models (experts "
            "have no adapter branch); target attention projections only")


def router_logits(x32: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
    """``x32 @ w32`` in float32 with float32 accumulation: TF32 is switched
    off around the product when a caller turned it on."""
    if x32.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return x32 @ w32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = True
    return x32 @ w32


def top_k_lower_first(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of each row of
    ``probs`` (non-negative), largest first, the lower index first among
    equals: ``lax.top_k``'s order. ``values`` is differentiable."""
    work = probs.detach()
    idx: List[torch.Tensor] = []
    for _ in range(k):
        i = torch.argmax(work, dim=-1, keepdim=True)
        idx.append(i)
        work = work.scatter(-1, i, -1.0)
    indices = torch.cat(idx, dim=-1)
    return torch.gather(probs, -1, indices), indices


def expert_ffn(xe: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU over stacked experts: ``silu(xe @ w1) * (xe @ w3) @ w2`` with
    ``xe (E, C, h)``, ``w1``/``w3 (E, h, m)``, ``w2 (E, m, h)``."""
    return torch.bmm(F.silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3), w2)


class _Int8Experts(torch.autograd.Function):
    """:func:`expert_ffn` on int8 experts, differentiable in ``xe`` only:
    each weight is expanded at its use and let go before the next, and the
    backward keeps ``xe`` and the int8 payloads, expanding again."""

    @staticmethod
    def forward(ctx, xe, q1, s1, q3, s3, q2, s2):
        ctx.save_for_backward(xe, q1, s1, q3, s3, q2, s2)
        dt = xe.dtype
        a = torch.bmm(xe, dequantize(q1, s1, dt))
        hidden = F.silu(a) * torch.bmm(xe, dequantize(q3, s3, dt))
        del a
        return torch.bmm(hidden, dequantize(q2, s2, dt))

    @staticmethod
    def backward(ctx, g):
        xe, q1, s1, q3, s3, q2, s2 = ctx.saved_tensors
        dt = xe.dtype
        dh = torch.bmm(g, dequantize(q2, s2, dt).transpose(1, 2))
        w1 = dequantize(q1, s1, dt)
        a = torch.bmm(xe, w1)
        w3 = dequantize(q3, s3, dt)
        b = torch.bmm(xe, w3)
        a32 = a.float()
        sig = torch.sigmoid(a32)
        d_a = (dh.float() * b.float() * (sig * (1 + a32 * (1 - sig)))).to(dt)
        d_b = dh * F.silu(a)
        dxe = torch.bmm(d_a, w1.transpose(1, 2)) + torch.bmm(d_b, w3.transpose(1, 2))
        return dxe, None, None, None, None, None, None


class Routing(NamedTuple):
    """One call's routing: ``probs (T, E)`` float32, the renormalised and
    masked top-k ``weights (T, k)``, ``experts (k, T)`` (slot-major), each
    assignment's rank ``pos (k, T)`` inside its expert, ``keep (k, T)``,
    the ``capacity`` C and the valid assignments ``counts (k, E)`` of every
    batch rank together."""

    probs: torch.Tensor
    weights: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int
    counts: torch.Tensor


class MoEMLP(nn.Module):
    """Top-k routed expert SwiGLU MLP (a drop-in for ``LlamaMLP``):
    ``router`` float32 ``(h, E)``, ``w1``/``w3 (E, h, m)`` and ``w2 (E, m,
    h)`` in the param dtype, or ``QuantizedWeight`` pairs of those shapes.
    Under expert parallelism the experts are this rank's ``E / ep``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, h, m = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        pdtype = resolve_dtype(cfg.param_dtype)

        def param(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.router = param((h, E), torch.float32)
        self.w1 = param((E, h, m), pdtype)
        self.w3 = param((E, h, m), pdtype)
        self.w2 = param((E, m, h), pdtype)
        # parallel.sharding.MoEGroups under data or expert parallelism.
        self.groups = None
        # The tensor group's mesh view under tensor parallelism.
        self.tp = None

    def _experts(self, xe: torch.Tensor) -> torch.Tensor:
        ws = (self.w1, self.w3, self.w2)
        if isinstance(self.w1, QuantizedWeight):
            return _Int8Experts.apply(xe, *[t for w in ws for t in (w.q, w.scale)])
        return expert_ffn(xe, *(w.to(xe.dtype) for w in ws))

    def route(self, xt: torch.Tensor, valid: torch.Tensor) -> Routing:
        """The routing of tokens ``xt (T, h)`` with mask ``valid (T,)``
        (float 0/1): which experts take each token, at which rank, and
        which assignments the capacity keeps (see the module docstring)."""
        cfg = self.cfg
        E, k = cfg.num_experts, cfg.num_experts_per_tok
        T = xt.shape[0]
        groups = self.groups
        probs = torch.softmax(router_logits(xt.float(), self.router.float()), dim=-1)
        topk_w, topk_idx = top_k_lower_first(probs, k)                     # (T, k)
        topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
        topk_w = topk_w * valid[:, None]

        # Each assignment's rank inside its expert, slot-major over every
        # batch rank's tokens: earlier slots first, then earlier batch
        # ranks' tokens of this slot, then this rank's earlier tokens.
        experts = topk_idx.T                                               # (k, T)
        onehot = F.one_hot(experts, E) * (valid > 0).long()[None, :, None]  # (k, T, E)
        local_cnt = onehot.sum(1)                                          # (k, E)
        if groups is not None and groups.batch_world > 1:
            all_cnt = groups.gather_counts(local_cnt)                      # (dp, k, E)
            earlier = all_cnt[:groups.batch_rank].sum(0)
            counts = all_cnt.sum(0)
            T_all = T * groups.batch_world
        else:
            earlier, counts, T_all = torch.zeros_like(local_cnt), local_cnt, T
        C = max(int(cfg.moe_capacity_factor * T_all * k / E), 1)
        base = torch.cumsum(counts, 0) - counts + earlier                  # (k, E)
        pos = ((torch.cumsum(onehot, 1) - onehot + base[:, None, :]) * onehot).sum(-1)
        keep = (pos < C) & (valid > 0)[None, :]                            # (k, T)
        return Routing(probs, topk_w, experts, pos, keep, C, counts)

    def forward(self, x: torch.Tensor, token_mask: Optional[torch.Tensor] = None,
                want_aux: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(y, aux)``: the output ``(b, s, h)`` and, with ``want_aux``,
        this layer's load-balance loss (a 0-d float32 tensor; else None).
        ``token_mask (b, s)``: 1 for real tokens, 0 for padding, which is
        neither routed nor counted."""
        cfg = self.cfg
        dtype = resolve_dtype(cfg.dtype)
        b, s, h = x.shape
        E, k = cfg.num_experts, cfg.num_experts_per_tok
        T = b * s
        groups = self.groups
        split = groups is not None and groups.split
        dev = x.device
        valid = (torch.ones(T, dtype=torch.float32, device=dev) if token_mask is None
                 else token_mask.reshape(T).float())
        xt = x.reshape(T, h)
        r = self.route(xt, valid)

        # This rank's experts: [e0, e0 + E_local).
        E_local = self.w1.shape[0]
        e0 = groups.expert_rank * E_local if split else 0
        mine = r.keep & (r.experts >= e0) & (r.experts < e0 + E_local)
        rows = E_local * r.capacity
        spare = rows + torch.arange(T, device=dev)
        dest = torch.where(mine, (r.experts - e0) * r.capacity + r.pos, spare[None, :])

        xin, topk_w = xt.to(dtype), r.weights
        if split:
            # Each rank's gradients reach x and the weights through its own
            # experts alone: the backward sums them over the expert group.
            xin, topk_w = groups.expert_in(xin), groups.expert_in(topk_w)
        if self.tp is not None:
            # Each rank's hidden units see the tokens and weights whole.
            xin, topk_w = copy_in(xin, self.tp), copy_in(topk_w, self.tp)
        # The combine weights in the compute dtype, as the reference's
        # einsum takes them; dropped and other ranks' assignments weigh 0.
        slot_w = (topk_w.T * mine).to(dtype).float()                       # (k, T)
        buf = xin.new_zeros(rows + T, h)
        for j in range(k):
            buf = buf.index_put((dest[j],), xin)
        out_e = self._experts(buf[:rows].view(E_local, r.capacity, h)).reshape(rows, h)
        out_pad = torch.cat([out_e, out_e.new_zeros(T, h)])
        y = sum(slot_w[j][:, None] * out_pad[dest[j]].float() for j in range(k))
        if split:
            y = groups.expert_out(y)
        if self.tp is not None:
            y = reduce_out(y, self.tp)
        y = y.to(dtype).reshape(b, s, h)

        aux = None
        if want_aux:
            stats = torch.cat([(r.probs * valid[:, None]).sum(0), valid.sum()[None]])
            if groups is not None and groups.batch_world > 1:
                stats = groups.batch_sum(stats)
            n_valid = torch.clamp(stats[E].detach(), min=1.0)
            frac = r.counts.sum(0).float() / (n_valid * k)
            aux = E * torch.sum(frac * (stats[:E] / n_valid))
        return y, aux


def collect_aux_loss(auxes) -> torch.Tensor:
    """The sum of a forward's per-layer load-balance losses."""
    auxes = list(auxes)
    return torch.stack(auxes).sum() if auxes else torch.zeros(())
