"""DistributedContext — rank bookkeeping + host-level object collectives;
the port's copy of ``determined_clone_tpu/core/_distributed.py``.

Collectives of small *Python objects* (metric dicts, checkpoint
manifests, storage ids, preemption decisions), NOT tensors: tensor
collectives are ``torch.distributed``'s (NCCL on the card, gloo on the
CPU, ``parallel/spmd.py``). The three transports are the JAX package's:
an in-process group over queues (``make_local_group``, for tests) and the
chief/worker TCP sockets (``from_tcp``).

``from_torch()`` takes the place of the JAX package's ``from_jax()``: it
adopts rank, size and local rank from an initialised ``torch.distributed``
world (``exec/launch.py`` starts one), and, unless a chief address is
given for the TCP transport, exchanges objects through
``torch.distributed.all_gather_object`` over a gloo group of that world.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
from typing import Any, List, Optional


class DistributedError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Wire framing (chief <-> worker TCP sockets)
# ---------------------------------------------------------------------------

def _send_msg(sock: socket.socket, obj: Any) -> None:
    # pickle: internal control plane between mutually-trusted gang members,
    # same trust model as the reference's ZMQ pickle transport.
    data = pickle.dumps(obj)
    sock.sendall(struct.pack("!I", len(data)) + data)


def _recv_msg(sock: socket.socket) -> Any:
    hdr = _recv_exact(sock, 4)
    (length,) = struct.unpack("!I", hdr)
    return pickle.loads(_recv_exact(sock, length))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise DistributedError("peer closed connection mid-message")
        buf += chunk
    return buf


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class _Transport:
    """One collective primitive is enough: leader_exchange(rank, obj) — every
    rank contributes obj, every rank receives the full list (allgather).
    Other collectives derive from it."""

    def leader_exchange(self, obj: Any) -> List[Any]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class _LocalTransport(_Transport):
    """In-process transport for an n-thread rank group (tests)."""

    class _Shared:
        def __init__(self, size: int) -> None:
            self.size = size
            self.lock = threading.Lock()
            self.slots: dict = {}
            self.round = 0
            self.cond = threading.Condition(self.lock)

    def __init__(self, shared: "_LocalTransport._Shared", rank: int) -> None:
        self.shared = shared
        self.rank = rank
        self._round = 0

    def leader_exchange(self, obj: Any) -> List[Any]:
        sh = self.shared
        my_round = self._round
        self._round += 1
        with sh.cond:
            sh.slots.setdefault(my_round, {})[self.rank] = obj
            if len(sh.slots[my_round]) == sh.size:
                sh.cond.notify_all()
            else:
                sh.cond.wait_for(
                    lambda: len(sh.slots.get(my_round, {})) == sh.size,
                    timeout=60,
                )
                if len(sh.slots.get(my_round, {})) != sh.size:
                    raise DistributedError(
                        f"rank {self.rank}: exchange round {my_round} timed out"
                    )
            result = [sh.slots[my_round][r] for r in range(sh.size)]
            # last rank to read cleans up
            sh.slots.setdefault(f"read{my_round}", 0)
            sh.slots[f"read{my_round}"] += 1
            if sh.slots[f"read{my_round}"] == sh.size:
                del sh.slots[my_round]
                del sh.slots[f"read{my_round}"]
        return result


class _ChiefTransport(_Transport):
    """Chief side: accepts one socket per worker, orchestrates rounds.

    Binds eagerly (``port`` may be 0 → ephemeral, see ``.port``) but accepts
    lazily on the first collective — so the chief can bind, advertise its
    port through the master rendezvous, and only then expect workers.
    """

    def __init__(self, port: int, size: int, timeout: float = 300.0) -> None:
        self.size = size
        self.timeout = timeout
        self.server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind(("0.0.0.0", port))
        self.server.listen(size)
        self.server.settimeout(timeout)
        self.port = self.server.getsockname()[1]
        self.workers: dict = {}

    def _accept_all(self) -> None:
        while len(self.workers) < self.size - 1:
            conn, _ = self.server.accept()
            conn.settimeout(self.timeout)
            hello = _recv_msg(conn)
            self.workers[hello["rank"]] = conn

    def leader_exchange(self, obj: Any) -> List[Any]:
        self._accept_all()
        contributions = {0: obj}
        for rank, conn in self.workers.items():
            contributions[rank] = _recv_msg(conn)
        result = [contributions[r] for r in range(self.size)]
        for conn in self.workers.values():
            _send_msg(conn, result)
        return result

    def close(self) -> None:
        for conn in self.workers.values():
            conn.close()
        self.server.close()


class _WorkerTransport(_Transport):
    def __init__(self, chief_addr: str, chief_port: int, rank: int,
                 timeout: float = 300.0) -> None:
        self.sock = socket.create_connection((chief_addr, chief_port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)
        _send_msg(self.sock, {"rank": rank})

    def leader_exchange(self, obj: Any) -> List[Any]:
        _send_msg(self.sock, obj)
        return _recv_msg(self.sock)

    def close(self) -> None:
        self.sock.close()


class _TorchTransport(_Transport):
    """Objects over ``all_gather_object`` on a gloo group of the
    initialised torch world: the card's NCCL group would move them
    through device memory."""

    def __init__(self) -> None:
        import torch.distributed as dist

        self._dist = dist
        self._group = (dist.group.WORLD if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))

    def leader_exchange(self, obj: Any) -> List[Any]:
        out: List[Any] = [None] * self._dist.get_world_size()
        self._dist.all_gather_object(out, obj, group=self._group)
        return out


# ---------------------------------------------------------------------------
# DistributedContext
# ---------------------------------------------------------------------------

class DistributedContext:
    """Rank info + object collectives for one trial's gang."""

    def __init__(self, *, rank: int, size: int, local_rank: int = 0,
                 local_size: int = 1, cross_rank: int = 0, cross_size: int = 1,
                 transport: Optional[_Transport] = None) -> None:
        if not (0 <= rank < size):
            raise DistributedError(f"rank {rank} out of range for size {size}")
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        self._transport = transport

    # -- constructors -------------------------------------------------------

    @staticmethod
    def single() -> "DistributedContext":
        return DistributedContext(rank=0, size=1)

    @staticmethod
    def from_torch(chief_addr: Optional[str] = None,
                   chief_port: int = 0) -> "DistributedContext":
        """Adopt rank, size and local rank from an initialised
        ``torch.distributed`` world (one process per card). The local
        rank is ``LOCAL_RANK`` from the environment the launcher sets,
        the rank itself when unset."""
        import torch.distributed as dist

        if not dist.is_initialized():
            raise DistributedError(
                "torch.distributed is not initialised (start the ranks "
                "with determined_clone_tpu_torch.exec.launch)")
        size = dist.get_world_size()
        rank = dist.get_rank()
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        transport: Optional[_Transport] = None
        if size > 1:
            transport = (
                DistributedContext._tcp_transport(chief_addr, chief_port,
                                                  rank, size)
                if chief_addr is not None else _TorchTransport())
        return DistributedContext(
            rank=rank, size=size, local_rank=local_rank,
            local_size=local_size, cross_rank=rank // max(1, local_size),
            cross_size=max(1, size // max(1, local_size)),
            transport=transport)

    @staticmethod
    def from_tcp(chief_addr: str, chief_port: int, rank: int, size: int,
                 local_rank: int = 0, local_size: int = 1) -> "DistributedContext":
        transport = DistributedContext._tcp_transport(chief_addr, chief_port,
                                                      rank, size)
        cross_size = max(1, size // max(1, local_size))
        return DistributedContext(
            rank=rank, size=size, local_rank=local_rank, local_size=local_size,
            cross_rank=rank // max(1, local_size), cross_size=cross_size,
            transport=transport,
        )

    @staticmethod
    def _tcp_transport(chief_addr: str, chief_port: int, rank: int,
                       size: int) -> _Transport:
        if rank == 0:
            return _ChiefTransport(chief_port, size)
        return _WorkerTransport(chief_addr, chief_port, rank)

    @staticmethod
    def make_local_group(size: int) -> List["DistributedContext"]:
        """n in-process contexts over a shared-memory transport (tests)."""
        shared = _LocalTransport._Shared(size)
        return [
            DistributedContext(
                rank=r, size=size, local_rank=r, local_size=size,
                transport=_LocalTransport(shared, r),
            )
            for r in range(size)
        ]

    # -- collectives --------------------------------------------------------

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    def allgather(self, obj: Any) -> List[Any]:
        if self.size == 1:
            return [obj]
        self._require_transport()
        return self._transport.leader_exchange(obj)

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Chief receives [obj_0..obj_n-1]; others get None."""
        result = self.allgather(obj)
        return result if self.is_chief else None

    def broadcast(self, obj: Any) -> Any:
        """Chief's object wins; other ranks' inputs are ignored."""
        if self.size == 1:
            return obj
        return self.allgather(obj if self.is_chief else None)[0]

    def barrier(self) -> None:
        self.allgather(None)

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()

    def _require_transport(self) -> None:
        if self._transport is None:
            raise DistributedError(
                f"rank {self.rank}/{self.size}: no control-plane transport "
                f"configured (multi-process collectives need chief_addr)"
            )
