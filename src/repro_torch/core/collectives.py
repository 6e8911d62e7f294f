"""Gradient-exchange collectives on ``torch.distributed`` (port of the
uncompressed half of ``repro/core/collectives.py``; paper §3.2, §4.4).

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

The fp16/int8 compressed exchange with its error-feedback residual and
the overlapped drain (``overlapped_reduce_tree``) come with later slices;
``TrainConfig.check_supported`` refuses their settings.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

STRATEGIES = ("psum", "ring", "hierarchical", "bucketed")


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
