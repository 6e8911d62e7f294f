"""Gradient-exchange collectives on ``torch.distributed`` (port of
``repro/core/collectives.py``; paper §3.2, §4.4).

The reference runs inside ``shard_map`` over named mesh axes; here each
device is a rank and each axis a process group (``launch/mesh.py``
``DPMesh``).  Four strategies, selected by ``TrainConfig.collective_strategy``:

  * ``psum``          -- one all-reduce of each buffer (NCCL's own
                         algorithm on the card, gloo's on the host).
  * ``ring``          -- NCCL's ring all-reduce [31] built from
                         point-to-point sends, as the reference builds it
                         from ``ppermute``: n-1 reduce-scatter hops, then
                         n-1 all-gather hops, to rank+1 and from rank-1,
                         the chunks added in the reference's order (so the
                         same float32 inputs give the reference's bits).
  * ``hierarchical``  -- the paper's slow-link schedule: reduce-scatter in
                         the pod, all-reduce the 1/n_fast shard across pods,
                         all-gather in the pod.  Without pods it is psum, as
                         in the reference's ``make_train_step_dp``.
  * ``bucketed``      -- one all-reduce a bucket of ~``bucket_bytes``
                         (``bucket_leaves``), the bucket concatenated into
                         one flat buffer (an all-reduce is elementwise, so
                         the layout changes no sum).

A "tree" here is a list of tensors (the step's flat gradient buffers, in
``LeafGroups.paths`` order, or the loss), reduced in place and returned.
Every function returns the SUM over the ranks; the caller divides by the
world size, as the reference's ``reduce_fn`` does.

Staging.  Gloo cannot exchange a card's tensors in every collective.  When
the process group's backend is gloo and a buffer lies on a card (several
ranks sharing one card, ``launch/dp_check.py --share-device``), each
buffer is copied to host memory, exchanged there (the ring's additions
run on the host, in float32 as on the card) and copied back; the mesh logs
that it does (``DPMesh.staged``).  Under NCCL nothing is staged.

Compressed exchange (``TrainConfig.grad_compression``,
``compressed_reduce_gradients``): the reference's fp16 wire (each buffer
cast to fp16 and reduced in fp16 with the step's strategy) and int8 wire
(each ``bucket_leaves`` bucket quantised with one fp32 scale, absmax/127,
and summed by ``int8_two_stage_all_reduce``, a compressed reduce-scatter +
all-gather whatever the strategy), with error feedback: this rank's
quantisation residual ``(g + e) - dequant(quant(g + e))`` is returned to
be added to its next step's gradients, held on a step whose gradients are
not finite on some rank.

Overlapped drain (``OverlappedReduce``, ``overlapped_reduce_tree``): the
uncompressed exchange a bucket at a time, each bucket started as soon as
its buffers are complete (``core/grad_accum.py``) and waited on after the
backward.  The reference concatenates every bucket into one buffer, which
under XLA's elementwise all-reduce changes no bit.  Gloo's and NCCL's
all-reduce sum an element in an order that depends on the buffer's length
(at 4 gloo ranks about 4 % of the elements of a concatenation differ in
the last bit from the per-buffer sums), so here each bucket is exchanged
in the serial path's own layout: concatenated under ``bucketed``, a buffer
at a time under the other three.  The overlapped result then has the
serial path's bits under every strategy, by construction.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.utils import all_finite

STRATEGIES = ("psum", "ring", "hierarchical", "bucketed")
GRAD_COMPRESSIONS = ("none", "fp16", "int8")


def _host(x: torch.Tensor, group) -> torch.Tensor:
    """The buffer the backend exchanges: ``x``, or its host copy when gloo
    would have to take a card's tensor."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


def _back(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    if h is not x:
        x.copy_(h)
    return x


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) ``x`` over ``group``, in place."""
    h = _host(x, group)
    dist.all_reduce(h, group=group)
    return _back(x, h)


# ---------------------------------------------------------------------------
# Ring all-reduce from point-to-point sends (NCCL's algorithm, paper ref [31]).
# ---------------------------------------------------------------------------

def _ring_hop(send: torch.Tensor, recv: torch.Tensor, nxt: int, prv: int,
              group) -> None:
    ops = [dist.P2POp(dist.isend, send, nxt, group),
           dist.P2POp(dist.irecv, recv, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def ring_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` as a reduce-scatter + all-gather
    ring, in place.  The flat buffer is padded to a multiple of n and cut
    into n chunks.  At reduce-scatter hop k rank d sends its running
    partial sum (first its own chunk d) to d+1 and adds the partial it
    receives from d-1 to its chunk (d-k-1) mod n, ``chunk + recv`` as the
    reference adds; after n-1 hops rank d holds the full sum of chunk
    (d+1) mod n.  The all-gather hops pass the summed chunks on: at hop k
    rank d receives the sum of chunk (d-k) mod n.  At n = 1, ``x`` is
    returned as it is."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    h = _host(x, group)
    flat = h.reshape(-1)
    chunks = F.pad(flat, (0, (-flat.numel()) % n)).view(n, -1)

    send = chunks[idx].clone()
    recv = torch.empty_like(send)
    for k in range(n - 1):
        _ring_hop(send, recv, nxt, prv, group)
        send = chunks[(idx - k - 1) % n] + recv

    out = torch.empty_like(chunks)
    out[(idx + 1) % n] = send
    for k in range(n - 1):
        _ring_hop(send, recv, nxt, prv, group)
        out[(idx - k) % n] = recv
        send, recv = recv, send
    h.view(-1).copy_(out.view(-1)[:flat.numel()])
    return _back(x, h)


def ring_all_reduce_tree(tree: Sequence[torch.Tensor], group
                         ) -> List[torch.Tensor]:
    return [ring_all_reduce(x, group) for x in tree]


# ---------------------------------------------------------------------------
# Hierarchical all-reduce (the paper's PCIe-vs-network schedule).
# ---------------------------------------------------------------------------

def hierarchical_psum(x: torch.Tensor, fast_group, pod_group,
                      group) -> torch.Tensor:
    """reduce-scatter(fast) -> all-reduce(pod) -> all-gather(fast), in
    place.  The slow (cross-pod) link carries only 1/n_fast of the bytes.
    When the buffer cannot be evenly scattered (a scalar loss, too) it is
    one all-reduce over ``group``, the whole world: the nested form would
    sum in another order and drift from psum in the last bit (the
    reference's reason too)."""
    nf = dist.get_world_size(fast_group)
    if x.numel() % nf:
        return psum(x, group)
    h = _host(x, fast_group)
    flat = h.view(-1)
    shard = torch.empty(flat.numel() // nf, dtype=h.dtype, device=h.device)
    dist.reduce_scatter_tensor(shard, flat, group=fast_group)
    dist.all_reduce(shard, group=pod_group)
    # torch 2.13 renames it all_gather_single (keeping this name as an
    # alias of it); 2.11 has only this name
    dist.all_gather_into_tensor(flat, shard, group=fast_group)
    return _back(x, h)


def hierarchical_psum_tree(tree: Sequence[torch.Tensor], fast_group,
                           pod_group, group) -> List[torch.Tensor]:
    return [hierarchical_psum(x, fast_group, pod_group, group) for x in tree]


# ---------------------------------------------------------------------------
# Bucketed all-reduce (paper §4.4, Fig. 2).
# ---------------------------------------------------------------------------

def bucket_leaves(tree: Sequence[torch.Tensor],
                  bucket_bytes: int = 25 * 2 ** 20) -> List[List[int]]:
    """Group the buffers, in order, into buckets of ~``bucket_bytes``
    (DDP-style): a bucket closes before the buffer that would take it past
    ``bucket_bytes``; a buffer larger than that is a bucket alone."""
    buckets, cur, cur_bytes = [], [], 0
    for i, x in enumerate(tree):
        nbytes = x.numel() * x.element_size()
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def bucketed_psum_tree(tree: Sequence[torch.Tensor], group, *,
                       bucket_bytes: int = 25 * 2 ** 20
                       ) -> List[torch.Tensor]:
    """One all-reduce a bucket instead of one a buffer, in place."""
    tree = list(tree)
    for bucket in bucket_leaves(tree, bucket_bytes):
        if len(bucket) == 1:
            psum(tree[bucket[0]], group)
            continue
        flat = psum(torch.cat([tree[i].reshape(-1) for i in bucket]), group)
        for i, part in zip(bucket, flat.split([tree[i].numel()
                                               for i in bucket])):
            tree[i].copy_(part.view_as(tree[i]))
    return tree


# ---------------------------------------------------------------------------
# Strategy dispatch used by the train step.
# ---------------------------------------------------------------------------

def reduce_gradients(tree: Sequence[torch.Tensor], *, strategy: str, mesh,
                     bucket_bytes: int = 25 * 2 ** 20) -> List[torch.Tensor]:
    """All-reduce (sum) every buffer of ``tree`` over the ranks of ``mesh``
    (a ``launch.mesh.DPMesh``) in place, with ``strategy``.  A mesh
    without a process group (world 1) exchanges nothing."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown collective strategy {strategy!r}")
    tree = list(tree)
    if mesh.group is None:
        return tree
    if strategy == "hierarchical" and mesh.pods > 1:
        return hierarchical_psum_tree(tree, mesh.fast_group, mesh.pod_group,
                                      mesh.group)
    if strategy == "ring":
        return ring_all_reduce_tree(tree, mesh.group)
    if strategy == "bucketed":
        return bucketed_psum_tree(tree, mesh.group,
                                  bucket_bytes=bucket_bytes)
    return [psum(x, mesh.group) for x in tree]


# ---------------------------------------------------------------------------
# The overlapped drain's exchange, a bucket at a time.
# ---------------------------------------------------------------------------

def _start_psum(x: torch.Tensor, group) -> Callable[[], None]:
    """Start an all-reduce (sum) of ``x`` in place; returns the function
    that waits for it (and copies a staged buffer back)."""
    h = _host(x, group)
    work = dist.all_reduce(h, group=group, async_op=True)

    def wait():
        work.wait()
        _back(x, h)
    return wait


class OverlappedReduce:
    """The uncompressed exchange of the overlapped drain schedule (the
    reference's ``overlapped_reduce_tree``, split into starts and a wait;
    see the module docstring for the layout of a bucket).

    ``buckets(tree)`` are the ``bucket_leaves`` buckets of the buffers.
    ``start(bucket, tree, pre_scale)`` scales the bucket's buffers by
    ``pre_scale`` (the 1/A mean; None for none) in place and starts their
    exchange: one ``async_op`` all-reduce of the concatenated bucket
    (``bucketed``) or of each buffer (``psum``, ``hierarchical`` without
    pods).  The ring's hops and hierarchical's three collectives each need
    the one before, so those run at once, in order (under NCCL a wait only
    orders the card's streams, and the host goes on; under gloo it waits).
    ``finish(tree, pre_scale)`` starts every bucket not started yet, in
    order, then waits for each bucket in the order it started, splits a
    concatenated bucket back and divides by ``world``, in place; returns
    the buffers as a list.  Every rank must start the same buckets in the
    same order."""

    def __init__(self, *, strategy: str, mesh,
                 bucket_bytes: int = 25 * 2 ** 20, world: int = 1):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown collective strategy {strategy!r}")
        self.strategy, self.mesh = strategy, mesh
        self.bucket_bytes, self.world = bucket_bytes, world
        self._pending: List[Tuple[List[int], Callable[[], None]]] = []

    def buckets(self, tree: Sequence[torch.Tensor]) -> List[List[int]]:
        return bucket_leaves(tree, self.bucket_bytes)

    def start(self, bucket: List[int], tree: Sequence[torch.Tensor],
              pre_scale: Optional[float] = None) -> None:
        bufs = [tree[i] for i in bucket]
        if pre_scale is not None:
            for x in bufs:
                x.mul_(pre_scale)
        group = self.mesh.group
        if group is None:
            wait = _nothing
        elif self.strategy == "bucketed" and len(bufs) > 1:
            flat = torch.cat([x.reshape(-1) for x in bufs])
            reduced = _start_psum(flat, group)

            def wait():
                reduced()
                for x, part in zip(bufs, flat.split([x.numel()
                                                     for x in bufs])):
                    x.copy_(part.view_as(x))
        elif self.strategy == "ring" or (self.strategy == "hierarchical"
                                         and self.mesh.pods > 1):
            reduce_gradients(bufs, strategy=self.strategy, mesh=self.mesh)
            wait = _nothing
        else:
            waits = [_start_psum(x, group) for x in bufs]

            def wait():
                for w in waits:
                    w()
        self._pending.append((list(bucket), wait))

    def finish(self, tree: Sequence[torch.Tensor],
               pre_scale: Optional[float] = None) -> List[torch.Tensor]:
        tree = list(tree)
        started = [b for b, _ in self._pending]
        for bucket in self.buckets(tree):
            if bucket not in started:
                self.start(bucket, tree, pre_scale)
        pending, self._pending = self._pending, []
        for bucket, wait in pending:
            wait()
            for i in bucket:
                tree[i].div_(self.world)
        return tree


def _nothing() -> None:
    pass


def overlapped_reduce_tree(tree: Sequence[torch.Tensor], *, strategy: str,
                           mesh, bucket_bytes: int = 25 * 2 ** 20,
                           world: int = 1,
                           pre_scale: Optional[float] = None
                           ) -> List[torch.Tensor]:
    """Every bucket of ``tree`` scaled by ``pre_scale``, summed over the
    ranks of ``mesh`` and divided by ``world``, in place (the MEAN, as the
    reference's; ``OverlappedReduce`` with every bucket started at once)."""
    return OverlappedReduce(strategy=strategy, mesh=mesh,
                            bucket_bytes=bucket_bytes,
                            world=world).finish(tree, pre_scale)


# ---------------------------------------------------------------------------
# Compressed gradient exchange (fp16 / int8 wire) with error feedback.
# ---------------------------------------------------------------------------

def _no_span(name: str):
    return contextlib.nullcontext()


def quantize_int8(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one fp32 scale, absmax/127 (floored at 1e-12 /
    127), rounded half to even and clipped to +-127, as the reference's."""
    scale = torch.clamp(flat.abs().max(), min=1e-12) / 127.0
    q = torch.round(flat / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


_FMA_CHUNK = 1 << 24


def _fma(acc: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
         sign: float = 1.0) -> torch.Tensor:
    """``acc + sign * q * scale`` rounded to fp32 once, as one fused
    multiply-add rounds it: the reference's jitted XLA contracts its
    dequantise into the following add or subtract.  The product of an int8
    and a fp32 is exact in fp64, and so is its sum with a fp32 of a near
    exponent.  In chunks of ``_FMA_CHUNK`` elements, so the fp64
    temporaries stay small beside a 400 MB bucket."""
    out = torch.empty_like(acc)
    s = scale.double()
    for a, b, o in zip(acc.split(_FMA_CHUNK), q.split(_FMA_CHUNK),
                       out.split(_FMA_CHUNK)):
        o.copy_(a.double() + sign * (b.double() * s))
    return out


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(n, m) ``x`` on each of the n ranks -> (n, m) whose row j is rank
    j's row ``rank``."""
    h = _host(x, group)
    out = torch.empty_like(h)
    dist.all_to_all_single(out, h, group=group)
    return out.to(x.device)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    h = _host(x, group)
    out = torch.empty((dist.get_world_size(group) * h.shape[0],)
                      + tuple(h.shape[1:]), dtype=h.dtype, device=h.device)
    dist.all_gather_into_tensor(out, h, group=group)
    return out.to(x.device)


def int8_two_stage_all_reduce(q: torch.Tensor, scale: torch.Tensor, group,
                              span: Callable = _no_span,
                              order: Optional[Sequence[int]] = None
                              ) -> torch.Tensor:
    """Sum an int8-quantised flat bucket over ``group``; the wire carries
    int8 (the reference's compressed reduce-scatter + all-gather):

      1. pad to a multiple of n; ``all_to_all`` gives rank d every rank's
         d-th chunk, and an all-gather every rank's scale;
      2. dequantise the n chunks and add them in rank order, a fp32 shard
         (each add one fused multiply-add, as the reference's XLA fuses);
      3. requantise the shard with a fresh scale and all-gather the int8
         shards and their scales.

    ``order[p]`` is the rank at position p of the reference's device order
    (``DPMesh.exchange_order``; the group's rank order when None): the
    rank at position p sums chunk p, adding the chunks in position order.
    Returns the fp32 SUM, the same on every rank; at n = 1 (or no group),
    ``dequant(q)``.  ``span(name)`` brackets the local work ("quantise",
    "dequantise")."""
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        with span("dequantise"):
            return dequantize_int8(q, scale)
    order = list(range(n)) if order is None else list(order)
    pos = [order.index(r) for r in range(n)]     # rank -> position
    size = q.numel()
    chunks = F.pad(q, (0, (-size) % n)).view(n, -1)
    # row r of the all-to-all goes to rank r: the chunk of its position
    shards = _all_to_all(chunks[pos], group)
    scales = _all_gather(scale.reshape(1), group)
    with span("dequantise"):
        partial = shards[order[0]].float() * scales[order[0]]
        for r in order[1:]:
            partial = _fma(partial, shards[r], scales[r])
    with span("quantise"):
        q2, s2 = quantize_int8(partial)
    # chunk p is the shard of the rank at position p
    qg = _all_gather(q2, group).view(n, -1)[order]
    s2g = _all_gather(s2.reshape(1), group)[order]
    with span("dequantise"):
        return (qg.float() * s2g[:, None]).reshape(-1)[:size]


def compressed_reduce_gradients(
        grads: Sequence[torch.Tensor], err: Sequence[torch.Tensor], *,
        strategy: str, mode: str, mesh, bucket_bytes: int = 25 * 2 ** 20,
        span: Callable = _no_span
        ) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Error-feedback compressed all-reduce of ``grads`` (flat fp32
    buffers in true, unscaled gradient units) over the ranks of ``mesh``,
    with this rank's residual ``err`` (buffers of the same shapes).

    Returns ``(summed, new_err, finite)``: the SUM over the ranks (the
    caller divides by the world size), the residual to carry into the next
    step, and the 0-d bool "every rank's gradients are finite" (an int32
    all-reduce of each rank's flag).  A rank whose gradients are not
    finite contributes zeros, and the residual is then held, not advanced.
    fp16 reduces the fp16 buffers with ``strategy`` (``reduce_gradients``;
    hierarchical without pods is psum); int8 goes a ``bucket_leaves``
    bucket at a time through ``int8_two_stage_all_reduce`` whatever the
    strategy, over the ranks in the reference's order of its devices
    (``DPMesh.exchange_order``).  ``span(name)`` brackets the local quantise and dequantise
    work."""
    if mode not in ("fp16", "int8"):
        raise ValueError(f"unknown gradient compression {mode!r}")
    flag = all_finite(list(grads)).to(torch.int32).reshape(1)
    if mesh.group is not None:
        psum(flag, mesh.group)
    fin = flag[0] == mesh.world
    zero = torch.zeros((), dtype=torch.float32, device=flag.device)
    x = [torch.where(fin, g.float(), zero) + e for g, e in zip(grads, err)]
    if mode == "fp16":
        with span("quantise"):
            xc = [v.half() for v in x]
            new_err = [v.sub_(c.float()) for v, c in zip(x, xc)]
        red = reduce_gradients(xc, strategy=strategy, mesh=mesh,
                               bucket_bytes=bucket_bytes)
        with span("dequantise"):
            red = [v.float() for v in red]
    else:
        red, new_err = [None] * len(x), [None] * len(x)
        for bucket in bucket_leaves(x, bucket_bytes):
            flat = x[bucket[0]] if len(bucket) == 1 else torch.cat(
                [x[i].reshape(-1) for i in bucket])
            with span("quantise"):
                q, scale = quantize_int8(flat)
                err_flat = _fma(flat, q, scale, -1.0)
            red_flat = int8_two_stage_all_reduce(
                q, scale, mesh.group, span, order=mesh.exchange_order)
            sizes = [x[i].numel() for i in bucket]
            for i, r, e in zip(bucket, red_flat.split(sizes),
                               err_flat.split(sizes)):
                # a buffer of its own: the optimizer's kernel takes
                # 16-byte-aligned buffers, and a split's views are not
                red[i] = r.view_as(x[i]) if len(bucket) == 1 else r.clone()
                new_err[i] = e.view_as(x[i])
    # a skipped (non-finite) step must not advance the feedback buffer
    new_err = [torch.where(fin, ne, e) for ne, e in zip(new_err, err)]
    return red, new_err, fin


def exchange_bytes_per_step(n_params: int, *, strategy: str,
                            compression: str = "none", world: int = 1,
                            pod: int = 1,
                            bucket_bytes: int = 25 * 2 ** 20) -> float:
    """Analytic per-worker gradient-exchange wire bytes for one step (copy
    of the reference's formula).

    A ring (or the equivalent reduce-scatter + all-gather pair) moves
    2(n-1)/n words per worker; hierarchical moves full-rate words on the
    fast link but only the 1/n_fast shard across pods; int8 adds two fp32
    scales per bucket per hop-direction.  ``world`` is the total number of
    workers (including the ``pod`` factor for hierarchical).  The volume is
    schedule-independent: an overlapped drain moves the same bytes.
    """
    if world <= 1:
        return 0.0
    itemsize = {"none": 4, "fp16": 2, "int8": 1}[compression]
    n_buckets = max(1, -(-n_params * 4 // bucket_bytes))
    scale_overhead = 2 * 4 * n_buckets if compression == "int8" else 0
    if strategy == "hierarchical" and pod > 1 and compression != "int8":
        # int8's wire schedule is strategy-independent (flat two-stage
        # exchange over all axes) -- it falls through to the flat formula
        fast = world // pod
        fast_bytes = 2 * (fast - 1) / fast * n_params * itemsize
        slow_bytes = 2 * (pod - 1) / pod * (n_params / max(fast, 1)) * itemsize
        return fast_bytes + slow_bytes
    return 2 * (world - 1) / world * n_params * itemsize + scale_overhead
