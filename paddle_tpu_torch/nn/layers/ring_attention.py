"""Blockwise (online-softmax), ring and Ulysses attention (counterpart of
``paddle_tpu/nn/layers/ring_attention.py``).

``blockwise_attention(q, k, v)`` over ``[B, H, S, D]`` is exact softmax
attention that visits the keys a block at a time, keeping a running max
``m``, sum ``l`` and output ``o`` in float32 (``_block_step``), so no
``[S, Sk]`` score matrix lives at once. The JAX package routes it, on a
single TPU chip, to its Pallas flash kernel when S and Sk divide by their
blocks; the port routes a CUDA tensor of such a shape to
``FlashAttentionFunction`` (the B1/B2 forward and B3/B4 backward kernels,
``causal`` passed through), whose kernels launch or raise. Every other
shape, and the CPU, take the torch blockwise program, as the JAX package
does off the TPU: up to ``_UNROLL_BLOCKS`` blocks an unrolled loop that
autograd differentiates, beyond it ``_BlockwiseScan``, the counterpart of
the custom-VJP ``_blockwise_scan``, whose backward recomputes each block's
probabilities from the saved ``lse`` (FlashAttention-2's backward) so that
only q, k, v, out and lse are kept. Under AMP the kernel route casts q, k
and v as the white-listed ``flash_attention``; the torch route is
``blockwise_attention``, on neither list, as in the JAX package.

**Sequence parallel** (a rank is a process, ``distributed/comm.py``): each
rank of the mesh's ``sp`` group holds ``[B, H, S/sp, D]``, the rows of its
sequence shard, whose global positions start at ``sp_rank * S/sp``.

- ``ring_attention_raw`` (the per-rank body): the local q stays put while K
  and V travel the ring (``collective.shift_``, rank i to i + 1). With
  ``use_pallas`` each step's local attention is the B1/B2 forward through
  ``flash_attention_partial``, returning that shard's unmerged ``(out,
  lse)``, and the partials merge by the max-shifted weights of
  ``_ring_pallas_raw``; without it, each step is ``_block_step``'s online
  softmax with the global causal mask (``_ring_raw``). On a causal ring the
  first step is the diagonal (the causal kernel), a shard from an earlier
  rank is all visible, and one from a later rank all masked: ``src <
  sp_rank`` is a host integer here, so the masked step is skipped (no
  launch), where the JAX package's ``lax.cond`` runs its zero branch; the
  merge weighs such a partial 0 either way. Each ring is ONE
  ``torch.autograd.Function``: its backward runs the ring again, dK and dV
  travelling with K and V and reaching home after ``sp`` shifts, so every
  rank issues its collectives in one order whatever steps it skipped (the
  autograd engine never orders them). The flash ring's backward is the
  partial's autograd formula at each step (``partial_backward``: the
  merge's lse cotangent folded into delta, then B3/B4).
- ``ring_attention`` takes and returns GLOBAL tensors: each rank cuts its
  shard of S, runs the ring and all-gathers the output.
- ``_ulysses_raw``: a tiled all-to-all trades the sequence shard for a head
  shard (``[B, H/sp, S, D]``), attention runs over the whole sequence with
  a plain causal mask (the flash kernels with ``use_pallas`` and S
  divisible by the block, else ``blockwise_attention``'s route: the
  kernels on a block-divisible CUDA shape, the torch blockwise program
  otherwise), and the inverse all-to-all brings the rows home.
  ``ulysses_attention`` is its global form.

The divisibility ``ValueError``s are the JAX package's.
"""
from __future__ import annotations

import torch

from ... import amp
from ...core.tensor import tensor_boundary
from ...ops.kernels.flash_attention import (FlashAttentionFunction,
                                            flash_attention_partial,
                                            partial_backward)

__all__ = ["blockwise_attention", "ring_attention", "ring_attention_raw",
           "ulysses_attention"]

_NEG = -1e30
#: more blocks than this take the recomputing scan (``_BlockwiseScan``)
_UNROLL_BLOCKS = 16


def _block_step(q, k, v, scale, o, m, l, mask=None):
    """One online-softmax step over a key block: q ``[B,H,Sq,D]`` and k
    f32, v ``[B,H,Sk,D]``, o ``[B,H,Sq,D]`` f32, m and l ``[B,H,Sq]`` f32;
    ``mask`` ``[Sq,Sk]`` additive. Returns the new (o, m, l)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.matmul(p, v.float())
    return o_new, m_new, l_new


def _start(q):
    B, H, S, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros(B, H, S, D, **f32),
            torch.full((B, H, S), _NEG, **f32), torch.zeros(B, H, S, **f32))


def _blockwise_raw(q, k, v, *, causal=False, block_size=512, scale=None):
    """The torch blockwise program (``_blockwise_raw``)."""
    S, D, Sk = q.shape[2], q.shape[3], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    block = min(block_size, Sk)
    n_blocks = -(-Sk // block)
    if n_blocks > _UNROLL_BLOCKS:
        return _BlockwiseScan.apply(q, k, v, causal, block, scale)
    qf = q.float()
    qpos = torch.arange(S, device=q.device)
    o, m, l = _start(q)
    for j in range(n_blocks):
        lo, hi = j * block, min((j + 1) * block, Sk)
        mask = None
        if causal:
            kpos = torch.arange(lo, hi, device=q.device)
            mask = torch.where(kpos[None, :] > qpos[:, None], _NEG, 0.0)
        o, m, l = _block_step(qf, k[:, :, lo:hi].float(), v[:, :, lo:hi],
                              scale, o, m, l, mask)
    return (o / l[..., None]).to(q.dtype)


def _block_masks(S, Sk, block, n_blocks, causal, device):
    """Per block j: (lo, ``[S, block]`` bool of the keys it may not see:
    padding past Sk, and the future when causal)."""
    qpos = torch.arange(S, device=device)
    for j in range(n_blocks):
        kpos = j * block + torch.arange(block, device=device)
        invalid = (kpos[None, :] >= Sk).expand(S, block)
        if causal:
            invalid = invalid | (kpos[None, :] > qpos[:, None])
        yield j * block, invalid


def _padded(t, n):
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[2]))


class _BlockwiseScan(torch.autograd.Function):
    """The blockwise forward over padded key blocks, saving (q, k, v, out,
    lse); its backward recomputes ``p = exp(s - lse)`` per block (0 where
    the score is masked), ``ds = p (dO v^T - delta) scale`` with ``delta =
    rowsum(dO * out)``, and accumulates dq while each block writes its dk
    and dv."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block, scale):
        S, Sk = q.shape[2], k.shape[2]
        n_blocks = -(-Sk // block)
        kp, vp = _padded(k, n_blocks * block), _padded(v, n_blocks * block)
        qf = q.float()
        o, m, l = _start(q)
        for lo, invalid in _block_masks(S, Sk, block, n_blocks, causal,
                                        q.device):
            mask = torch.where(invalid, _NEG, 0.0)
            o, m, l = _block_step(qf, kp[:, :, lo:lo + block].float(),
                                  vp[:, :, lo:lo + block], scale, o, m, l,
                                  mask)
        out = (o / l[..., None]).to(q.dtype)
        lse = m + torch.log(l.clamp(min=1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, block, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, block, scale = ctx.args
        S, Sk = q.shape[2], k.shape[2]
        n_blocks = -(-Sk // block)
        kp, vp = _padded(k, n_blocks * block), _padded(v, n_blocks * block)
        qf, gf = q.float(), g.float()
        delta = (gf * out.float()).sum(dim=-1)
        dq = torch.zeros_like(qf)
        dks, dvs = [], []
        for lo, invalid in _block_masks(S, Sk, block, n_blocks, causal,
                                        q.device):
            kj = kp[:, :, lo:lo + block].float()
            vj = vp[:, :, lo:lo + block].float()
            s = torch.where(invalid, _NEG,
                            torch.matmul(qf, kj.transpose(-1, -2)) * scale)
            p = torch.where(s <= _NEG / 2, 0.0, torch.exp(s - lse[..., None]))
            dp = torch.matmul(gf, vj.transpose(-1, -2))
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.matmul(ds, kj)
            dks.append(torch.matmul(ds.transpose(-1, -2), qf))
            dvs.append(torch.matmul(p.transpose(-1, -2), gf))
        dk = torch.cat(dks, dim=2)[:, :, :Sk]
        dv = torch.cat(dvs, dim=2)[:, :, :Sk]
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, \
            None


def kernel_route(q, k, block_size):
    """Does ``blockwise_attention`` go to the flash kernels? A CUDA
    tensor of four axes whose S and Sk divide by their blocks."""
    S, Sk = q.shape[2], k.shape[2]
    return (q.device.type == "cuda" and q.dim() == 4
            and S % min(block_size, S) == 0
            and Sk % min(block_size, Sk) == 0)


@tensor_boundary
def blockwise_attention(q, k, v, causal=False, block_size=512, scale=None):
    """Exact softmax attention over ``[B, H, S, D]`` with O(block) score
    memory: the flash kernels on a CUDA tensor whose S and Sk divide by
    ``min(block_size, S)`` and ``min(block_size, Sk)`` (they launch or
    raise), the torch blockwise program otherwise. ``causal`` masks key j
    from query i when j > i."""
    if kernel_route(q, k, block_size):
        q, k, v = amp.cast_if_amp("flash_attention", (q, k, v))
        return FlashAttentionFunction.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal,
            min(block_size, q.shape[2]), min(block_size, k.shape[2]), scale,
            0, 0)
    q, k, v = amp.cast_if_amp("blockwise_attention", (q, k, v))
    return _blockwise_raw(q, k, v, causal=causal, block_size=block_size,
                          scale=scale)


# ---------------------------------------------------------------------------
# sequence parallel: the ring and Ulysses
# ---------------------------------------------------------------------------


def _sp_group(axis_name="sp", group=None, mesh=None):
    """The Group an sp routine runs over: ``group``, else the mesh's
    ``axis_name`` group (the hybrid mesh's by default)."""
    if group is not None:
        return group
    from ...distributed import comm

    mesh = mesh if mesh is not None else comm.hybrid_mesh()
    if mesh is None:
        raise RuntimeError(
            "sequence-parallel attention needs a mesh with an 'sp' axis: "
            "fleet.init with hybrid_configs sp_degree, or pass mesh=")
    return mesh.group(axis_name)


def _shift(tensors, group):
    """Each tensor of ``tensors`` one step along the ring, in one
    collective a dtype (the tensors of a type travel as one flat buffer)."""
    from ...distributed import collective

    if group.nranks == 1:
        return list(tensors)
    out = list(tensors)
    by_type = {}
    for i, t in enumerate(tensors):
        by_type.setdefault(t.dtype, []).append(i)
    for idx in by_type.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        moved = collective.shift_(flat, group)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = moved[off:off + n].view_as(tensors[i])
            off += n
    return out


def _mask(idx, src, Sl, device):
    """``[Sl, Sl]`` bool: key j of shard ``src`` is in the future of query
    i of shard ``idx`` (global positions ``shard * Sl + i``)."""
    qpos = idx * Sl + torch.arange(Sl, device=device)
    kpos = src * Sl + torch.arange(Sl, device=device)
    return kpos[None, :] > qpos[:, None]


class _Ring(torch.autograd.Function):
    """``_ring_raw``: ``_block_step``'s online softmax over the ring's KV
    shards (float32), the global causal mask at each step. Saves (q, k, v,
    out, lse); the backward recomputes each step's probabilities from lse
    (FlashAttention-2's backward) while K, V, dK and dV travel the ring."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, idx = group.nranks, group.rank
        Sl = q.shape[2]
        qf = q.float()
        o, m, l = _start(q)
        kc, vc = k, v
        for step in range(n):
            src = (idx - step) % n
            mask = None
            if causal:
                mask = torch.where(_mask(idx, src, Sl, q.device), _NEG, 0.0)
            o, m, l = _block_step(qf, kc.float(), vc, scale, o, m, l, mask)
            if step < n - 1:
                kc, vc = _shift([kc, vc], group)
        out = (o / l[..., None]).to(q.dtype)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.args
        n, idx = group.nranks, group.rank
        Sl = q.shape[2]
        qf, gf = q.float(), g.float()
        delta = (gf * out.float()).sum(dim=-1)
        dq = torch.zeros_like(qf)
        kc, vc = k.float(), v.float()
        dkc, dvc = torch.zeros_like(kc), torch.zeros_like(vc)
        for step in range(n):
            src = (idx - step) % n
            s = torch.matmul(qf, kc.transpose(-1, -2)) * scale
            if causal:
                s = torch.where(_mask(idx, src, Sl, q.device), _NEG, s)
            p = torch.where(s <= _NEG / 2, 0.0,
                            torch.exp(s - lse[..., None]))
            dp = torch.matmul(gf, vc.transpose(-1, -2))
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.matmul(ds, kc)
            dkc = dkc + torch.matmul(ds.transpose(-1, -2), qf)
            dvc = dvc + torch.matmul(p.transpose(-1, -2), gf)
            if step < n - 1:
                kc, vc, dkc, dvc = _shift([kc, vc, dkc, dvc], group)
            else:
                dkc, dvc = _shift([dkc, dvc], group)
        return (dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype), None,
                None, None)


class _RingFlash(torch.autograd.Function):
    """``_ring_pallas_raw``: at each step the partial ``(out, lse)`` of the
    shard held (``flash_attention_partial``: B1; the diagonal with the
    causal kernel, an earlier rank's shard without a mask, a later rank's
    skipped), merged as ``out = sum_j w_j o_j / sum_j w_j``, ``w_j =
    exp(lse_j - M)``, a partial of lse <= -1e30/2 weighing 0. Saves the
    partials; the backward takes the merge's cotangents of each partial
    (``g_o_j = g w_j / W``, ``g_lse_j = w_j rowsum(g (o_j - out)) / W``),
    runs the partial's formula (B3/B4 with the lse cotangent folded into
    delta) on the shard it came from, and sends dK and dV home with K and
    V."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, block_q, block_k):
        n, idx = group.nranks, group.rank
        B, H, Sl, D = q.shape
        bq, bk = min(block_q, Sl), min(block_k, Sl)
        f32 = dict(dtype=torch.float32, device=q.device)
        acc = torch.zeros(B, H, Sl, D, **f32)
        wsum = torch.zeros(B, H, Sl, **f32)
        mmax = torch.full((B, H, Sl), _NEG, **f32)
        parts = []
        kc, vc = k, v
        for step in range(n):
            src = (idx - step) % n
            if step == 0 or not causal or src < idx:
                o_p, lse_p = flash_attention_partial(
                    q, kc, vc, causal and step == 0, bq, bk, scale, 0, 0)
                m_new = torch.maximum(mmax, lse_p)
                alive = m_new > _NEG / 2
                corr = torch.where(alive, torch.exp(mmax - m_new), 1.0)
                w = torch.where(alive, torch.exp(lse_p - m_new), 0.0)
                acc = acc * corr[..., None] + o_p.float() * w[..., None]
                wsum = wsum * corr + w
                mmax = m_new
                parts.append((step, o_p, lse_p))
            if step < n - 1:
                kc, vc = _shift([kc, vc], group)
        wc = wsum.clamp(min=1e-30)
        out = acc / wc[..., None]
        ctx.steps = [st for st, _, _ in parts]
        ctx.save_for_backward(q, k, v, out, wc, mmax,
                              *[t for _, o, l in parts for t in (o, l)])
        ctx.args = (group, causal, scale)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, wc, mmax, *saved = ctx.saved_tensors
        group, causal, scale = ctx.args
        n = group.nranks
        parts = dict(zip(ctx.steps, zip(saved[0::2], saved[1::2])))
        alive = mmax > _NEG / 2
        gacc = g.float() / wc[..., None]
        dq = torch.zeros_like(q)
        kc, vc = k, v
        dkc, dvc = torch.zeros_like(k), torch.zeros_like(v)
        for step in range(n):
            if step in parts:
                o_p, lse_p = parts[step]
                w = torch.where(alive, torch.exp(lse_p - mmax), 0.0)
                g_o = (gacc * w[..., None]).to(o_p.dtype)
                g_lse = w * (gacc * (o_p.float() - out)).sum(dim=-1)
                dq_j, dk_j, dv_j = partial_backward(
                    q, kc, vc, o_p, lse_p, g_o, g_lse,
                    causal=causal and step == 0, scale=scale)
                dq = dq + dq_j
                dkc, dvc = dkc + dk_j, dvc + dv_j
            if step < n - 1:
                kc, vc, dkc, dvc = _shift([kc, vc, dkc, dvc], group)
            else:
                dkc, dvc = _shift([dkc, dvc], group)
        return dq, dkc, dvc, None, None, None, None, None


def ring_attention_raw(q, k, v, *, axis_name="sp", sp_size=None,
                       causal=False, scale=None, use_pallas=False,
                       interpret=False, block_q=256, block_k=256,
                       group=None):
    """The per-rank form: q, k, v are this rank's ``[B, H, S/sp, D]``
    shards of the ``axis_name`` group (``group=`` names another), the
    output this rank's rows. ``use_pallas`` runs each step's local
    attention as the flash kernels (``_ring_pallas_raw``); ``interpret``
    is the JAX package's (on the CPU the kernels' plain versions run)."""
    g = _sp_group(axis_name, group)
    if sp_size is not None and int(sp_size) != g.nranks:
        raise ValueError(f"ring_attention_raw: sp_size={sp_size}, but the "
                         f"'{axis_name}' group has {g.nranks} ranks")
    scale = scale if scale is not None else q.shape[3] ** -0.5
    q, k, v = (t.contiguous() for t in (q, k, v))
    if use_pallas:
        return _RingFlash.apply(q, k, v, g, bool(causal), scale, block_q,
                                block_k)
    return _Ring.apply(q, k, v, g, bool(causal), scale)


class _SeqShard(torch.autograd.Function):
    """This rank's rows of axis 2 (the sequence); the backward gathers the
    gradient's rows from every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = group.nranks, group.rank
        Sl = x.shape[2] // n
        return x[:, :, r * Sl:(r + 1) * Sl].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g.contiguous(), ctx.group), None


class _SeqGather(torch.autograd.Function):
    """Every rank's rows of axis 2, joined in rank order; the backward
    takes this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.group.nranks, ctx.group.rank
        Sl = g.shape[2] // n
        return g[:, :, r * Sl:(r + 1) * Sl].contiguous(), None


def _gather_seq(x, group):
    from ...distributed import collective

    parts = collective.all_gather_(x, group)
    return torch.cat(parts.unbind(0), dim=2)


@tensor_boundary
def ring_attention(q, k, v, mesh=None, sp_axis="sp", causal=False,
                   scale=None, use_pallas=False, interpret=None):
    """The global form: q, k, v are GLOBAL ``[B, H, S, D]`` (the same on
    every rank of the ``sp_axis`` group); each rank takes its shard of S,
    runs the ring, and the output is all-gathered back to ``[B, H, S, D]``
    (its gradient reaches every rank's inputs whole)."""
    g = _sp_group(sp_axis, mesh=mesh)
    sp = g.nranks
    S = q.shape[2]
    if S % sp != 0:
        raise ValueError(
            f"ring_attention: sequence length {S} must be divisible by "
            f"the '{sp_axis}' axis size {sp}")
    shards = [_SeqShard.apply(t, g) for t in (q, k, v)]
    out = ring_attention_raw(*shards, causal=causal, scale=scale,
                             use_pallas=use_pallas, group=g)
    return _SeqGather.apply(out, g)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_tiled_`` of ``split_axis`` into ``concat_axis``; its
    backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        from ...distributed import collective

        ctx.args = (split_axis, concat_axis, group)
        return collective.all_to_all_tiled_(x, split_axis, concat_axis,
                                            group)

    @staticmethod
    def backward(ctx, g):
        from ...distributed import collective

        split_axis, concat_axis, group = ctx.args
        return collective.all_to_all_tiled_(
            g.contiguous(), concat_axis, split_axis, group), None, None, None


def _ulysses_raw(q, k, v, *, axis_name="sp", causal=False, scale=None,
                 block_size=512, use_pallas=False, interpret=False,
                 group=None):
    """The per-rank body: q, k, v (this rank's ``[B, H, S/sp, D]``) go
    through one tiled all-to-all (heads scattered, the sequence gathered:
    ``[B, H/sp, S, D]``), exact attention over the whole sequence (a plain
    causal mask), and the inverse all-to-all."""
    g = _sp_group(axis_name, group)
    qkv = _AllToAll.apply(torch.stack([q, k, v]), 2, 3, g)
    q, k, v = qkv.unbind(0)
    S = q.shape[2]
    b = min(block_size, S)
    if use_pallas and S % b == 0:
        q, k, v = amp.cast_if_amp("flash_attention", (q, k, v))
        out = FlashAttentionFunction.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, b, b,
            scale, 0, 0)
    else:
        out = blockwise_attention(q, k, v, causal=causal,
                                  block_size=block_size, scale=scale)
    return _AllToAll.apply(out, 2, 1, g)


@tensor_boundary
def ulysses_attention(q, k, v, mesh=None, sp_axis="sp", causal=False,
                      scale=None, block_size=512, use_pallas=False,
                      interpret=None):
    """The global form of ``_ulysses_raw``: q, k, v GLOBAL ``[B, H, S,
    D]``, S cut over ``sp_axis``; the heads must divide by its size."""
    g = _sp_group(sp_axis, mesh=mesh)
    sp = g.nranks
    H, S = q.shape[1], q.shape[2]
    if H % sp != 0:
        raise ValueError(
            f"ulysses_attention: num_heads {H} must be divisible by the "
            f"'{sp_axis}' axis size {sp} (use ring attention otherwise)")
    if S % sp != 0:
        raise ValueError(
            f"ulysses_attention: sequence length {S} must be divisible "
            f"by the '{sp_axis}' axis size {sp}")
    shards = [_SeqShard.apply(t, g) for t in (q, k, v)]
    out = _ulysses_raw(*shards, causal=causal, scale=scale,
                       block_size=block_size, use_pallas=use_pallas,
                       group=g)
    return _SeqGather.apply(out, g)
