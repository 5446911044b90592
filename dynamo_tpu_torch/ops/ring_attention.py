"""Ring attention: causal self-attention with the sequence split over the
ranks of a sequence-parallel group, the long-context prefill primitive.

Counterpart of ``dynamo_tpu/ops/ring_attention.py``. There one
``shard_map`` program runs over an ``("sp",)`` device mesh and the K/V
chunks rotate with ``ppermute``. A PyTorch process drives one card, so
here each sp rank is a process of its own (:class:`SPMesh`, joined as the
ranks of ``parallel/multihost.py``) holding one chunk of Q, K and V. The
chunks go round the ring through ``parallel/comm.ring_exchange``: rank
``r`` sends the chunk in hand to ``(r + 1) mod sp`` and receives the next
one from ``(r - 1) mod sp``, the send started before the visiting chunk's
block is computed, so the exchange travels while the card works. Every
rank folds each visiting chunk into an online softmax (``m``, ``l`` and
``acc`` in f32), so full causal attention materialises only
``[T_loc * group, T_loc]`` scores of one KV head at a time.

The block attention is plain tensor arithmetic in f32 (matmul, ``exp``,
``max``), as the JAX code is XLA, not Pallas: no kernel of its own. It
cannot be ``scaled_dot_product_attention``, which returns no
log-sum-exp to carry the online softmax across chunks. K and V travel in
their own dtype (a bf16 chunk as its bytes) and are cast to f32 on
receipt; the JAX code casts before it rotates, which loses nothing but
moves twice the bytes.

GQA-aware: q ``[T, n_q, d]``, k/v ``[T, n_kv, d]``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch

from dynamo_tpu_torch.parallel import comm

_NEG = -0.7 * torch.finfo(torch.float32).max


@dataclass(frozen=True)
class SPMesh:
    """This process's place in a sequence-parallel group: the rank count,
    its rank (a world of sp ranks, rank ``r`` holding the ``r``-th chunk of
    a ring prefill), every rank's device (rank order), the process group
    (None at sp = 1) and the collective backend (``comm.choose_backend``).
    Every rank holds a whole replica of the weights and of the paged
    cache."""

    sp: int
    rank: int
    devices: tuple[torch.device, ...]
    backend: str
    group: Any = None

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def groups(self) -> list[tuple[Any, int]]:
        return [(self.group, self.sp)] if self.sp > 1 else []


def sequence_parallel_mesh(sp: int, devices=None, rank: int | None = None) -> SPMesh:
    """This process's rank of an ``sp``-rank group (the counterpart of the
    JAX function of this name). ``devices`` (one per rank) defaults to
    one card per rank; ``rank`` to this process's rank in the default
    process group, which must be up above one rank
    (``parallel/multihost.init_multihost``) with a world of sp ranks and
    the backend the devices call for. The backend is printed."""
    from dynamo_tpu_torch.parallel.sharding import default_devices, join_group

    if sp < 1:
        raise ValueError(f"sp={sp} must be positive")
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices(sp))]
    if sp > len(devices):
        raise ValueError(f"sp={sp} needs {sp} devices, have {len(devices)}")
    devices = devices[:sp]
    backend = comm.choose_backend(devices)
    group = None
    if sp > 1:
        import torch.distributed as dist

        rank = join_group(sp, rank, backend, devices)
        group = dist.group.WORLD
    mesh = SPMesh(sp, 0 if rank is None else rank, tuple(devices), backend, group)
    if sp > 1:
        if backend != comm.GLOO:
            torch.cuda.set_device(mesh.device)
        comm.warm_up(mesh)
        print(f"sp mesh: rank {mesh.rank}/{sp} on {mesh.device}, ring over {backend}",
              flush=True)
    return mesh


def causal_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Single-device full causal attention (the ground truth)."""
    T, n_q, d = q.shape
    n_kv = k.shape[1]
    group = n_q // n_kv
    qg = q.reshape(T, n_kv, group, d).float() * d ** -0.5
    s = torch.einsum("thgd,shd->thgs", qg, k.float())
    mask = torch.arange(T)[:, None] >= torch.arange(T)[None, :]
    s = torch.where(mask.to(s.device)[:, None, None, :], s, _NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("thgs,shd->thgd", w, v.float())
    return out.reshape(T, n_q, d).to(q.dtype)


def _ring_attention_local(
    q: torch.Tensor,   # [T_loc, n_q, d]: this rank's query chunk
    k: torch.Tensor,   # [T_loc, n_kv, d]
    v: torch.Tensor,
    mesh: SPMesh | None,
    on_chunk: Callable[[int, torch.Tensor, torch.Tensor], None] | None = None,
) -> torch.Tensor:
    """This rank's rows of causal attention over the whole sequence: the
    chunk in hand after ``p`` exchanges came from rank ``rank - p``, its
    block folded into the online softmax with the causal mask of the
    global positions. ``on_chunk(src, k, v)`` sees every chunk (this
    rank's first) in its own dtype, as it arrived. The score block is one
    KV head's ``[T_loc * group, T_loc]`` at a time (the JAX code holds
    every head's at once), and a chunk the causal mask hides whole is not
    folded (JAX folds it to no effect): the result is the same."""
    T_loc, n_q, d = q.shape
    n_kv = k.shape[1]
    group = n_q // n_kv
    sp, my = (mesh.sp, mesh.rank) if mesh is not None else (1, 0)
    dev = q.device
    R = T_loc * group  # a head's query rows: token-major, the group minor

    # One KV head's queries as one [R, d] matrix, so that each block is two
    # plain matrix products ([R, d] x [d, T_loc], [R, T_loc] x [T_loc, d]).
    qh = ((q.float() * d ** -0.5).reshape(T_loc, n_kv, group, d).permute(1, 0, 2, 3)
          .reshape(n_kv, R, d))
    q_pos = my * T_loc + torch.arange(T_loc, device=dev).repeat_interleave(group)  # [R]
    m = torch.full((n_kv, R, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((n_kv, R, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((n_kv, R, d), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v

    def fold(src: int, k_in: torch.Tensor, v_in: torch.Tensor) -> None:
        # A chunk from a later rank is masked whole: folding it changes
        # nothing (exp(_NEG - m) is 0, alpha 1), so it is skipped. One from
        # an earlier rank is visible whole and needs no mask.
        if src > my:
            return
        hidden = None
        if src == my:
            kv_pos = src * T_loc + torch.arange(T_loc, device=dev)
            hidden = q_pos[:, None] < kv_pos[None, :]                # [R, T_loc]
        for h in range(n_kv):
            kh, vh = k_in[:, h].float(), v_in[:, h].float()      # [T_loc, d]
            s = qh[h] @ kh.t()                                    # [R, T_loc]
            if hidden is not None:
                s.masked_fill_(hidden, _NEG)
            m_new = torch.maximum(m[h], s.amax(dim=-1, keepdim=True))
            pexp = s.sub_(m_new).exp_()
            alpha = torch.exp(m[h] - m_new)
            l[h] = alpha * l[h] + pexp.sum(dim=-1, keepdim=True)
            acc[h] = acc[h] * alpha + pexp @ vh
            m[h] = m_new

    for p in range(sp):
        src = (my - p) % sp
        if on_chunk is not None:
            on_chunk(src, k_cur, v_cur)
        if p + 1 < sp:
            # The chunk in hand goes to the next rank while its block is
            # folded in here.
            k_cur, v_cur = comm.ring_exchange(
                [k_cur, v_cur], mesh, between=functools.partial(fold, src, k_cur, v_cur))
        else:
            fold(src, k_cur, v_cur)

    out = (acc / torch.clamp_min(l, 1e-30)).reshape(n_kv, T_loc, group, d).permute(1, 0, 2, 3)
    return out.reshape(T_loc, n_q, d).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: SPMesh | None) -> torch.Tensor:
    """Causal self-attention over a sequence split over the sp ranks of
    ``mesh``: q/k/v are the whole ``[T, heads, d]`` on every rank, T
    divisible by sp; each rank computes its chunk's rows round the ring
    and the rows are gathered, so every rank returns the whole output."""
    sp = mesh.sp if mesh is not None else 1
    if q.shape[0] % sp:
        raise ValueError(f"sequence {q.shape[0]} not divisible by {sp}-way sp")
    n = q.shape[0] // sp
    r = mesh.rank if mesh is not None else 0
    rows = slice(r * n, (r + 1) * n)
    out = _ring_attention_local(q[rows], k[rows], v[rows], mesh)
    return comm.sp_gather(out, mesh) if sp > 1 else out
