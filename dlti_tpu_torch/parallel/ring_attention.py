"""Ring attention: exact attention over the ``sequence`` axis, the port of
``dlti_tpu/parallel/ring_attention.py``.

Each rank of a sequence group holds one contiguous chunk of every row's
tokens: its queries, keys and values. For a group of ``N`` ranks the ring
runs ``N`` steps: at step ``t`` rank ``r`` folds the key/value chunk it
holds (rank ``r - t``'s) into a float32 online-softmax state (the same
m/l/acc recurrence as flash attention, :func:`_block_accumulate`), then
passes the chunk on to rank ``r + 1`` (``parallel.tensor.permute_``, the
counterpart of ``jax.lax.ppermute``). Keys and values travel in their
unexpanded GQA form (``num_kv_heads``) and are repeated to ``num_heads``
only inside the block product. The causal and sliding-window masks are
driven by the token positions RoPE was applied at, and packed rows by
their segment ids (id 0 is padding, whose rows come out zero); each
rank's positions and segment ids are gathered once a forward
(:class:`RingContext`), so the mask of every chunk agrees with the
positions its keys were embedded at. A chunk that provably contributes
nothing to any of this rank's rows (entirely in the future, entirely
behind every row's window, or with segment ids disjoint from this rank's)
is skipped, the reference's conservative whole-chunk skips: skipping and
computing a fully masked block give the same bits, so the skip is decided
on the host once a forward, and a CUDA graph capture (which cannot read
the decision back) computes every block instead.

The block step is plain PyTorch, float32 products of the inputs (the
reference's ``einsum``s with ``preferred_element_type=float32``, which run
outside any Pallas kernel) on the CPU and the card alike. The whole ring
is one ``torch.autograd.Function``: its backward recomputes each block's
probabilities from the saved log-sum-exp and the chunks the forward held
(flash attention's backward, which equals the reference's autodiff of the
recurrence), accumulates dQ locally and sends every chunk's dK/dV back to
its owner (``N - 1`` permutes). A layer's remat recompute reuses the
chunks its first forward received. Every rank knows every rank's skips (the
gathered positions), so a chunk no later rank folds, or a dK/dV no rank
computed, is not sent, and every rank issues the same collectives in the
same order.

:func:`ring_attention` is the global-view entry point: whole ``(b, s, h,
d)`` inputs on every rank, split as the reference's ``shard_map`` splits
them (rows over the batch axes, tokens over ``sequence``, heads over
``tensor`` when both head counts divide), and the output gathered whole
again; a sequence extent of 1 is plain attention. The model calls
:func:`ring_attention_local` on its chunk.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import torch

from dlti_tpu_torch.ops.attention import reference_attention, repeat_kv
from dlti_tpu_torch.parallel.tensor import all_reduce_, gather_dim, permute_

# Finite stand-in for -inf: every exp()/max() stays total (no inf - inf =
# NaN) while exp(NEG_INF - anything finite) underflows to exactly 0.
NEG_INF = -1e30


def _allowed(q_pos, kv_pos, q_seg, kv_seg, causal: bool, window: int):
    """The ``(b, 1, sq, sk)`` visibility of a block, or None (all visible)."""
    allowed = None
    if causal:
        allowed = kv_pos[:, None, None, :] <= q_pos[:, None, :, None]
        if window:
            allowed = allowed & (kv_pos[:, None, None, :] > q_pos[:, None, :, None] - window)
    if q_seg is not None:
        same = ((q_seg[:, None, :, None] == kv_seg[:, None, None, :])
                & (kv_seg[:, None, None, :] != 0))
        allowed = same if allowed is None else allowed & same
    return allowed


def _scores(q32, k, rep: int, scale: float):
    """``(b, h, sq, sk)`` float32 scores of float32 queries against a chunk
    of (unexpanded) keys."""
    kr = repeat_kv(k, rep).float()
    return torch.einsum("bqhd,bkhd->bhqk", q32, kr) * scale


def _block_accumulate(carry, q, k, v, q_pos, kv_pos, q_seg, kv_seg, scale, causal,
                      window):
    """Fold one K/V chunk into the online-softmax state.

    carry: (m, l, acc) with m, l ``(b, h, sq)`` float32 and acc ``(b, sq, h,
    d)`` float32. q: ``(b, sq, h, d)``; k/v: ``(b, sk, hk, d)``; q_pos/kv_pos:
    ``(b, sq)``/``(b, sk)`` global token positions driving the causal (and
    sliding-window) mask; q_seg/kv_seg: optional segment ids for packed
    rows (id 0 = padding)."""
    m, l, acc = carry
    rep = q.shape[2] // k.shape[2]
    s = _scores(q.float(), k, rep, scale)
    allowed = _allowed(q_pos, kv_pos, q_seg, kv_seg, causal, window)
    if allowed is not None:
        s = torch.where(allowed, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if allowed is not None:
        # A fully masked row has m_new == NEG_INF and exp(s - m_new) == 1 at
        # every masked entry: zero them explicitly.
        p = torch.where(allowed, p, 0.0)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1)
    vr = repeat_kv(v, rep)
    # The probabilities in the values' type, the product in float32.
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vr.float())
    acc_new = acc * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


class RingContext:
    """One forward's ring over ``mesh`` (a ``Mesh.sequence`` view): this
    rank's query positions ``q_pos`` ``(b, sq)`` and segment ids ``q_seg``
    (or None), every rank's gathered once (:meth:`kv_pos`,
    :meth:`kv_seg`), the mask settings, and :attr:`skips`: for each ring
    step ``t``, whether the chunk this rank holds then (rank ``r - t``'s)
    can be skipped (:attr:`table`: every rank's). Shared by every layer of the forward, its remat
    recompute included."""

    def __init__(self, mesh, q_pos: torch.Tensor, q_seg: Optional[torch.Tensor] = None,
                 causal: bool = True, window: Optional[int] = None):
        self.mesh = mesh
        self.causal = causal
        self.window = int(window or 0)
        n, r = mesh.world, mesh.rank
        self.q_pos = q_pos.to(torch.int32)
        self.q_seg = None if q_seg is None else q_seg.to(torch.int32)
        ids = self.q_pos[None] if self.q_seg is None else torch.stack([self.q_pos, self.q_seg])
        self._all = self._gather(ids)                     # (n, 1 or 2, b, sq)
        # table[i][t]: whether rank i skips the chunk it holds at step t.
        self.table = [[False] * n for _ in range(n)]
        capturing = ids.is_cuda and torch.cuda.is_current_stream_capturing()
        if not capturing and (causal or self.q_seg is not None):
            # Per chunk: min/max position, min/max segment id; read back once.
            flat = self._all.flatten(2)
            stats = torch.stack([flat.amin(-1), flat.amax(-1)], -1).tolist()  # (n, f, 2)
            for i, t in itertools.product(range(n), range(n)):
                mine, kv = stats[i], stats[(i - t) % n]
                skip = False
                if causal:
                    skip = kv[0][0] > mine[0][1]              # entirely in the future
                    if self.window:
                        skip |= kv[0][1] <= mine[0][0] - self.window
                if self.q_seg is not None:
                    skip |= kv[1][0] > mine[1][1] or kv[1][1] < mine[1][0]
                self.table[i][t] = bool(skip)
        self.skips: List[bool] = self.table[r]
        # By layer: the chunks a differentiable call received, for its
        # remat recompute (:func:`ring_attention_local`'s ``layer``).
        self.received = {}

    def forwarded(self, t: int) -> List[bool]:
        """By rank: whether the chunk a rank holds at step ``t`` is folded
        by a rank after it (its permute to step ``t + 1`` is needed)."""
        n = self.mesh.world
        return [any(not self.table[(i + u) % n][t + u] for u in range(1, n - t))
                for i in range(n)]

    def returned(self, t: int) -> List[bool]:
        """By rank: whether a rank folded the chunk it held at step ``t``
        (its dK/dV goes back to the chunk's owner)."""
        return [not row[t] for row in self.table]

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        n = self.mesh.world
        if n == 1:
            return t[None]
        buf = t.new_zeros((n,) + tuple(t.shape))
        buf[self.mesh.rank] = t
        return all_reduce_(buf, self.mesh)

    def kv_pos(self, c: int) -> torch.Tensor:
        return self._all[c, 0]

    def kv_seg(self, c: int) -> Optional[torch.Tensor]:
        return None if self.q_seg is None else self._all[c, 1]


def _permute_chunk(k: torch.Tensor, v: torch.Tensor, ring: RingContext, t: int) -> tuple:
    """Step ``t + 1``'s chunk: every rank's (k, v) to rank + 1 (zeros where no
    later rank folds it: nothing is sent)."""
    kv = permute_(torch.stack([k, v]), 1, ring.mesh, ring.forwarded(t))
    return kv[0], kv[1]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring: RingContext, layer):
        mesh = ring.mesh
        n, r = mesh.world, mesh.rank
        b, sq, h, d = q.shape
        scale = d ** -0.5
        m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
        chunks = []
        kc, vc = k, v
        # The chunks this layer received in its first forward, when this is
        # its remat recompute: the same values, so nothing is sent again.
        kept = ring.received.get(layer)
        for t in range(n):
            c = (r - t) % n
            chunks += [kc, vc]
            if not ring.skips[t]:
                m, l, acc = _block_accumulate((m, l, acc), q, kc, vc, ring.q_pos,
                                              ring.kv_pos(c), ring.q_seg, ring.kv_seg(c),
                                              scale, ring.causal, ring.window)
            if t != n - 1:
                kc, vc = kept[2 * t:2 * t + 2] if kept else _permute_chunk(kc, vc, ring, t)
        if layer is not None and kept is None:
            ring.received[layer] = chunks[2:]
        # A fully masked row (padding in a packed row) has l == 0 and acc == 0:
        # the guard makes its output exactly zero.
        l = torch.clamp(l, min=1e-30)
        out32 = acc / l.transpose(1, 2)[..., None]
        lse = m + torch.log(l)
        ctx.ring = ring
        ctx.save_for_backward(q, out32, lse, *chunks)
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        mesh = ring.mesh
        n, r = mesh.world, mesh.rank
        q, out32, lse, *chunks = ctx.saved_tensors
        b, sq, h, d = q.shape
        hk = chunks[0].shape[2]
        rep = h // hk
        scale = d ** -0.5
        q32 = q.float()
        do = g.float()
        delta = (do * out32).sum(-1).transpose(1, 2)                # (b, h, sq)
        dq = torch.zeros_like(q32)
        # Each chunk's (dk, dv) from this rank's queries, by ring step.
        dkv = torch.zeros((n, 2) + tuple(chunks[0].shape), dtype=torch.float32,
                          device=q.device)
        for t in range(n):
            if ring.skips[t]:
                continue
            c = (r - t) % n
            kc, vc = chunks[2 * t], chunks[2 * t + 1]
            s = _scores(q32, kc, rep, scale)
            allowed = _allowed(ring.q_pos, ring.kv_pos(c), ring.q_seg, ring.kv_seg(c),
                               ring.causal, ring.window)
            p = torch.exp(s - lse[..., None])
            if allowed is not None:
                p = torch.where(allowed, p, 0.0)
            del s
            vr = repeat_kv(vc, rep).float()
            dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vr)
            ds = p * (dp - delta[..., None]) * scale
            del dp, p
            kr = repeat_kv(kc, rep).float()
            dq += torch.einsum("bhqk,bkhd->bqhd", ds, kr)
            dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
            sk = kc.shape[1]
            dkv[t, 0] = dk.reshape(b, sk, hk, rep, d).sum(3)
            dkv[t, 1] = dv.reshape(b, sk, hk, rep, d).sum(3)
        # Step t's chunk is rank r - t's: send each back to its owner, in the
        # keys' type (as the reference's transposed ppermute carries them).
        mine = dkv[0]
        for t in range(1, n):
            mine = mine + permute_(dkv[t].to(chunks[0].dtype), -t, mesh,
                                   ring.returned(t)).float()
        k_dtype, v_dtype = chunks[0].dtype, chunks[1].dtype
        return dq.to(q.dtype), mine[0].to(k_dtype), mine[1].to(v_dtype), None, None


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: Optional[torch.Tensor] = None,
                         q_seg: Optional[torch.Tensor] = None, *, mesh=None,
                         causal: bool = True, window: Optional[int] = None,
                         ring: Optional[RingContext] = None,
                         layer: Optional[int] = None) -> torch.Tensor:
    """This rank's chunk of ring attention: ``q`` ``(b, sq, h, d)``, ``k``/``v``
    ``(b, sq, hk, d)`` the rank's contiguous chunk of every row, ``q_pos``
    ``(b, sq)`` the chunk's global token positions (the ones RoPE used) and
    ``q_seg`` its segment ids (packed rows), over ``mesh`` (a
    ``Mesh.sequence`` view). ``ring``: a :class:`RingContext` built once for
    several calls (the model's layers), in place of ``q_pos``, ``q_seg``,
    ``mesh``, ``causal`` and ``window``; ``layer``: the caller's index in
    it, under which a differentiable call keeps the chunks it received, so
    a remat recompute of the layer reuses them. Differentiable in q, k and
    v."""
    if ring is None:
        ring = RingContext(mesh, q_pos, q_seg, causal, window)
    return _Ring.apply(q, k, v, ring, layer if torch.is_grad_enabled() else None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                   positions: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None, causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """Global-view ring attention: ``q`` ``(b, s, h, d)``, ``k``/``v`` ``(b, s,
    hk, d)`` whole on every rank of ``mesh`` (a ``parallel.mesh.Mesh``),
    split as the reference's ``shard_map`` splits them (rows over the batch
    axes, tokens over ``sequence``, heads over ``tensor`` when the extent
    divides both head counts), each rank running its chunk's ring, and the
    output gathered whole on every rank (differentiable: each rank's
    gradient reaches its own chunk). ``positions`` ``(b, s)`` drive the
    causal mask (default ``0 .. s-1``), ``segment_ids`` the packed mask;
    ``window`` is the sliding window. A sequence extent of 1 is plain
    attention; a length the extent does not divide raises."""
    n = mesh.sp
    if n == 1:
        return reference_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                                   q_positions=positions, kv_positions=positions,
                                   window=window)
    b, s = q.shape[0], q.shape[1]
    if s % n != 0:
        raise ValueError(f"ring attention: seq len {s} not divisible by sequence "
                         f"axis size {n}")
    if positions is None:
        positions = torch.arange(s, device=q.device)[None, :].expand(b, s)
    positions = positions.expand(b, s).to(torch.int32)
    if segment_ids is not None:
        segment_ids = segment_ids.expand(b, s).to(torch.int32)
    h, hk = q.shape[2], k.shape[2]
    axes = [(1, mesh.sequence)]
    tp = mesh.tensor if mesh.tensor_parallel else None
    if tp is not None and tp.world > 1 and h % tp.world == 0 and hk % tp.world == 0:
        axes.append((2, tp))
    rows = mesh.batch
    if rows.world > 1 and b % rows.world == 0:
        axes.append((0, rows))

    def part(t, dims):
        for d, axis in axes:
            if d < dims:
                n_d = t.shape[d] // axis.world
                t = t.narrow(d, axis.rank * n_d, n_d)
        return t

    out = ring_attention_local(
        part(q, 4), part(k, 4), part(v, 4), part(positions, 2),
        None if segment_ids is None else part(segment_ids, 2),
        mesh=mesh.sequence, causal=causal, window=window)
    for d, axis in axes:
        out = gather_dim(out, d, axis)
    return out
