"""Process groups, the row mesh and its collectives (``miden_tpu/dist/mesh.py``).

``miden_tpu`` shards the trace-row axis over a mesh of devices in one
process. Here each rank is a process of a
``torch.distributed`` group holding one device, and a :class:`Mesh` names
that group, this rank's place in it and its device. A row-sharded matrix is
a :class:`RowShard`: this rank's contiguous block of rows ``[k·S, (k+1)·S)``
and the matrix's whole height.

The collectives the sharded stages need (each counts its bytes in
``Mesh.traffic``): :func:`exchange` (a cross butterfly stage),
:func:`gather_rows` (a whole matrix on every rank), :func:`halo_rows` (the
first rows of the next rank's block: the constraints' next rows),
:func:`all_to_all_rows` (a FRI round's transposition), :func:`sum_partials`
(a field sum of every rank's partial sums: the DEEP claims) and
:func:`gather_at` (rows at the query indices, each from its owner). A
message from a rank to itself is a local copy: at world size 1 the
point-to-point collectives move nothing, the gathers run on the group.

Two backends, chosen by the group's backend name and nothing else:

- ``nccl``: CUDA tensors move card to card;
- ``gloo``: the tensors move through host memory (gloo's point-to-point
  takes CPU tensors), whether the mesh's device is the CPU or a card that
  several ranks share.

Groups start from a ``FileStore`` in a temporary directory
(:func:`init_group`, :func:`run_ranks`): no port and no network.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from ..field import goldilocks as F

ROWS = "rows"  # the one mesh axis, named as miden_tpu names it

#: seconds a collective may wait for the other ranks before it fails
TIMEOUT_S = 900

#: the keys of ``Mesh.traffic``, one a collective
TRAFFIC = ("exchange", "gather", "halo", "all_to_all", "partials", "gather_at")


@dataclass
class Mesh:
    """A 1-D mesh over the ranks of ``group``: rank ``rank`` of ``size``
    holds rows ``[rank·S, (rank+1)·S)`` of every sharded matrix, on
    ``device``. ``traffic`` counts the bytes this rank sent (exchange,
    halo, all_to_all) and received (gather, partials, gather_at)."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = ROWS
    traffic: dict = field(default_factory=lambda: dict.fromkeys(TRAFFIC, 0))

    def global_rank(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank)


@dataclass(frozen=True)
class RowShard:
    """Rows ``[k·S, (k+1)·S)`` of a ``(rows, ...)`` matrix on mesh rank k;
    the other blocks lie on the other ranks."""

    local: torch.Tensor
    rows: int

    @property
    def shape(self) -> tuple:
        return (self.rows, *self.local.shape[1:])


def init_group(backend: str, rank: int, world: int, store_dir: str) -> None:
    """Join the default process group over a ``FileStore`` in ``store_dir``.
    An NCCL rank takes card ``rank mod count``."""
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    opts = {}
    if backend == "nccl":
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        opts["device_id"] = card
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world, timeout=timedelta(seconds=TIMEOUT_S), **opts
    )


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh over ``group`` (default: the default group) on ``device``.

    A CUDA mesh puts each rank on its local card (``rank mod count``); over
    gloo several ranks may share one card. Without an initialized default
    group this starts one of a single rank: NCCL for ``cuda``, gloo for
    ``cpu``. Without a card, ``make_mesh("cuda")`` raises: the CPU is
    taken only when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' for a mesh of CPU ranks)")
    if not dist.is_initialized():
        init_group("nccl" if device.type == "cuda" else "gloo", 0, 1, tempfile.mkdtemp(prefix="mesh"))
    group = group if group is not None else dist.group.WORLD
    backend = dist.get_backend(group)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"make_mesh: backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: an NCCL group needs device='cuda'")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), device, backend)


def shard_rows(x: torch.Tensor, mesh: Mesh) -> RowShard:
    """This rank's contiguous block of the rows of ``x`` (which every rank
    holds whole), on the mesh's device."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"shard_rows: {n} rows over {mesh.size} ranks")
    s = n // mesh.size
    return RowShard(x[mesh.rank * s : (mesh.rank + 1) * s].to(mesh.device).contiguous(), n)


def lift_rows(m: torch.Tensor, rows: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole matrix of height ``h`` lifted
    cyclically to ``rows``: its rows ``(k·S + j) mod h`` for ``j < S``,
    ``S = rows/D`` (a slice where ``h ≥ S``, else ``m`` tiled)."""
    h, s = m.shape[0], rows // mesh.size
    if h >= s:
        start = (mesh.rank * s) % h
        return m[start : start + s]
    return m.repeat(s // h, *([1] * (m.ndim - 1)))


def block_rows(m, rows: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``m`` lifted to ``rows``: a :class:`RowShard`'s
    own rows, or :func:`lift_rows` of a whole matrix."""
    return m.local if isinstance(m, RowShard) else lift_rows(m, rows, mesh)


def next_rows(m, rows: int, count: int, mesh: Mesh) -> torch.Tensor:
    """The ``count`` rows that follow this rank's block of ``m`` lifted to
    ``rows``, cyclically: :func:`halo_rows` of a :class:`RowShard`, a slice
    of a whole matrix (which every rank holds)."""
    if isinstance(m, RowShard):
        return halo_rows(m, count, mesh)
    h, s = m.shape[0], rows // mesh.size
    start = ((mesh.rank + 1) * s) % h
    if start + count <= h:
        return m[start : start + count]
    return m.index_select(0, torch.remainder(torch.arange(start, start + count, device=m.device), h))


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (a broadcast; ``x`` has the same shape
    and dtype on every rank and is left as it is)."""
    buf = x.detach().to("cpu" if mesh.backend == "gloo" else mesh.device).clone()
    dist.broadcast(buf, src=mesh.global_rank(0), group=mesh.group)
    return buf.to(mesh.device)


def exchange(x: torch.Tensor, peer: int, mesh: Mesh) -> torch.Tensor:
    """Send ``x`` to mesh rank ``peer`` and receive its tensor of the same
    shape: one send and one receive, into a fresh buffer."""
    return _p2p({peer: x}, {peer: (tuple(x.shape), x.dtype)}, mesh, "exchange")[peer]


def gather_rows(x, mesh: Mesh) -> torch.Tensor:
    """The whole matrix of a :class:`RowShard` (every rank's block, in
    rank order) on every rank; a tensor is already whole."""
    if not isinstance(x, RowShard):
        return x
    return _all_gather(x.local, mesh, "gather").reshape(x.rows, *x.local.shape[1:])


def _p2p(sends: dict, recvs: dict, mesh: Mesh, key: str) -> dict:
    """Point-to-point: ``sends`` {peer: tensor}, ``recvs`` {peer: (shape,
    dtype)}; returns {peer: received tensor} on the mesh's device. A message
    to this rank itself is a copy; the others go in one batch."""
    out, ops, bufs = {}, [], {}
    for peer, x in sends.items():
        if peer == mesh.rank:
            continue
        send = x.contiguous()
        if mesh.backend == "gloo":
            send = send.cpu()
        ops.append(dist.P2POp(dist.isend, send, mesh.global_rank(peer), mesh.group))
        mesh.traffic[key] += send.numel() * send.element_size()
    for peer, (shape, dtype) in recvs.items():
        if peer == mesh.rank:
            out[peer] = sends[peer].clone()
            continue
        dev = "cpu" if mesh.backend == "gloo" else mesh.device
        bufs[peer] = torch.empty(shape, dtype=dtype, device=dev)
        ops.append(dist.P2POp(dist.irecv, bufs[peer], mesh.global_rank(peer), mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for peer, buf in bufs.items():
        out[peer] = buf.to(mesh.device)
    return out


def halo_rows(x: RowShard, rows: int, mesh: Mesh) -> torch.Tensor:
    """The first ``rows`` rows of the next rank's block (rank ``k+1``; the
    last rank gets rank 0's): the rows that follow this block, cyclically."""
    local = x.local
    if rows > local.shape[0]:
        raise ValueError(f"halo_rows: {rows} rows from blocks of {local.shape[0]}")
    head = local[:rows]
    prev, nxt = (mesh.rank - 1) % mesh.size, (mesh.rank + 1) % mesh.size
    got = _p2p({prev: head}, {nxt: ((rows, *local.shape[1:]), local.dtype)}, mesh, "halo")
    return got[nxt]


def all_to_all_rows(x: RowShard, arity: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the ``(rows/arity, arity, ...)`` transposition of
    ``x`` (a FRI round's view): row ``r`` of the result holds
    ``[x[r + j·rows/arity] for j < arity]``. Block k of ``x`` splits into
    ``arity`` pieces of ``S/arity`` rows; piece p goes to rank
    ``(k·arity + p) mod D`` as its column ``(k·arity + p) div D``."""
    local = x.local
    s, d = local.shape[0], mesh.size
    if s % arity:
        raise ValueError(f"all_to_all_rows: blocks of {s} rows in {arity} pieces")
    piece = s // arity
    k = mesh.rank
    sends: dict = {}
    for p in range(arity):  # the pieces for one rank, in column order
        sends.setdefault((k * arity + p) % d, []).append(local[p * piece : (p + 1) * piece])
    sources: dict = {}  # source rank -> the columns it sends here, in order
    for j in range(arity):
        sources.setdefault((k + j * d) // arity, []).append(j)
    tail = tuple(local.shape[1:])
    got = _p2p(
        {peer: torch.cat(parts) for peer, parts in sends.items()},
        {src: ((len(cols) * piece, *tail), local.dtype) for src, cols in sources.items()},
        mesh, "all_to_all",
    )
    cols = [None] * arity
    for src, js in sources.items():
        for i, j in enumerate(js):
            cols[j] = got[src][i * piece : (i + 1) * piece]
    return torch.stack(cols, dim=1)


def _all_gather(x: torch.Tensor, mesh: Mesh, key: str) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), stacked in rank order:
    (D, *x.shape)."""
    x = x.contiguous()
    if mesh.backend == "gloo":
        src = x.cpu()
        parts = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(parts, src, group=mesh.group)
        out = torch.stack(parts).to(mesh.device)
    else:
        out = torch.empty((mesh.size, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=mesh.group)
    mesh.traffic[key] += (mesh.size - 1) * x.numel() * x.element_size()
    return out


def sum_partials(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The Goldilocks sum of every rank's ``x`` (partial sums of the same
    shape): a gather of the ``(D, ...)`` partials, then field additions.
    An int64 ``all_reduce`` would not do: its SUM is not addition mod p."""
    return F.sum_axis0(_all_gather(x, mesh, "partials"))


def gather_at(x: RowShard, idx: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows ``idx`` (an int64 tensor, the same on every rank) of a
    :class:`RowShard`, each from the rank whose block holds it, on every
    rank."""
    return gather_at_many([(x, idx)], mesh)[0]


def gather_at_many(pairs: list, mesh: Mesh) -> list:
    """:func:`gather_at` of every ``(RowShard, idx)`` pair in one collective:
    each rank gathers the rows its blocks hold (zeros elsewhere), every
    rank's selections are gathered, and each element is taken from its
    owner."""
    sel, owner = [], []
    for x, idx in pairs:
        local = x.local
        s = local.shape[0]
        own = torch.div(idx, s, rounding_mode="floor")
        rows = local.index_select(0, (idx - mesh.rank * s).clamp(0, s - 1))
        mask = (own == mesh.rank).reshape(-1, *([1] * (local.ndim - 1)))
        sel.append(torch.where(mask, rows, torch.zeros_like(rows)).reshape(-1))
        owner.append(own.repeat_interleave(rows[0].numel() if rows.shape[0] else 0))
    flat = _all_gather(torch.cat(sel), mesh, "gather_at")
    picked = flat.gather(0, torch.cat(owner)[None]).reshape(-1)
    out, off = [], 0
    for (x, idx), part in zip(pairs, sel):
        n = part.numel()
        out.append(picked[off : off + n].reshape(idx.shape[0], *x.local.shape[1:]))
        off += n
    return out


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, world, backend, store_dir, threads):
    torch.set_num_threads(threads)
    with open(os.path.join(store_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    init_group(backend, rank, world, store_dir)
    try:
        out = fn(rank, *args)
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn, args=(), backend: str = "gloo", threads: int = 1) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes that form one
    default group of ``backend``; return their results in rank order. A
    rank that raises makes this raise (the other ranks are stopped).
    ``fn`` must be importable by name, and its arguments and results
    picklable. The call goes through a file: arguments larger than a pipe's
    buffer in the spawn arguments would start the processes one by one."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks") as store_dir:
        with open(os.path.join(store_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        mp.start_processes(
            _rank_main, args=(world, backend, store_dir, threads), nprocs=world, start_method="spawn"
        )
        out = []
        for rank in range(world):
            with open(os.path.join(store_dir, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
