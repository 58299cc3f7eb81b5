"""Sharded serving's request flow: rank 0 owns the prompt, the HTTP
request or the chat line, and every rank of the mesh runs the model on it
together (a sharded forward is a collective: each rank must make the same
calls in the same order).

`broadcast(obj)` hands rank 0's object to every rank.  `Lockstep(target)`
on rank 0 wraps an object whose method calls run the model: each call is
first broadcast -- method name and arguments -- then run, one at a time
(a lock orders concurrent callers, the worker's HTTP threads);
`follow(target)` on the other ranks replays the calls until rank 0's
`Lockstep.close()`.
"""

from __future__ import annotations

import threading


def is_distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_distributed() else 0


def broadcast(obj=None):
    """Rank 0's `obj` on every rank (identity without a group)."""
    if not is_distributed():
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class Lockstep:
    """Rank 0's handle on `target`: a call of one of `methods` is
    broadcast, then made; any other attribute is the target's."""

    def __init__(self, target, methods):
        self._target = target
        self._methods = frozenset(methods)
        self._lock = threading.Lock()

    def __getattr__(self, name):
        attr = getattr(self._target, name)
        if name not in self._methods:
            return attr

        def call(*args, **kwargs):
            with self._lock:
                broadcast((name, args, kwargs))
                return attr(*args, **kwargs)

        return call

    def close(self) -> None:
        with self._lock:
            broadcast(None)


def follow(target) -> int:
    """The other ranks' loop: replay rank 0's calls on `target` until it
    closes; returns the number of calls."""
    n = 0
    while True:
        msg = broadcast()
        if msg is None:
            return n
        name, args, kwargs = msg
        getattr(target, name)(*args, **kwargs)
        n += 1
