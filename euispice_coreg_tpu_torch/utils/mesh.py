"""Single-process sharding over a list of devices.

Counterpart of the JAX package's ``lag_search.mesh_put`` and
``default_mesh`` (``engine/lag_search.py``).  A mesh here is a sequence of
devices, one entry per shard; a device may appear more than once (several
shards on one card, or on the CPU).  One Python process drives every shard:
the operands are replicated to each distinct device, the lag, tile, plane
or frame axis is split into contiguous ranges, every shard is launched
before any result is read back, and the host gathers.  CUDA launches are
asynchronous per device, so no thread per card is needed.

Shards are ragged (``np.array_split`` ranges, no padding lags) and a shard
whose launch fails raises: its work is never rerun on another device.
"""
from __future__ import annotations

import itertools

import torch

from .torchcfg import resolve_device


def resolve_mesh(mesh):
    """``None``, or a sequence of devices (strings or ``torch.device``) as a
    tuple of ``torch.device``; ``"cuda"`` becomes the current card's index.
    Raises for an empty mesh, for devices of different types and (through
    :func:`resolve_device`) for CUDA without a card."""
    if mesh is None:
        return None
    if isinstance(mesh, (str, torch.device)):
        raise TypeError("mesh: a sequence of devices, one per shard, not a "
                        f"single device ({mesh!r})")
    devs = []
    for d in mesh:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs:
        raise ValueError("mesh: at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"mesh: devices of one type, got {devs}")
    return tuple(devs)


def default_mesh(device):
    """Every card of the machine (``cuda:0 .. n-1``) when ``device`` is a
    CUDA device and there is more than one card; else None (one device:
    nothing to shard).  Never the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    n = torch.cuda.device_count()
    if n <= 1:
        return None
    return tuple(torch.device("cuda", i) for i in range(n))


def split(n, mesh):
    """Contiguous ``(start, stop)`` ranges of ``range(n)``, one per shard of
    ``mesh`` and in order, sized as ``np.array_split`` sizes them (the
    first ``n % k`` one longer); shards beyond ``n`` get empty ranges."""
    k = len(mesh)
    q, r = divmod(int(n), k)
    out, start = [], 0
    for i in range(k):
        stop = start + q + (1 if i < r else 0)
        out.append((start, stop))
        start = stop
    return out


def replicate(x, mesh):
    """Tensor ``x`` on every shard's device, as a list aligned with
    ``mesh``: one copy per distinct device, shared by the shards that repeat
    it (a contiguous ``x`` is used as it is on its own device)."""
    copies = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = x.to(dev).contiguous()
    return [copies[dev] for dev in mesh]


def round_robin(ranges, step):
    """``(shard, start, stop)`` over every shard's range in chunks of
    ``step``, the shards taken in turn: one chunk of each shard before the
    next chunk of any, so that every device has work queued early."""
    chunks = [[(k, s, min(s + step, b)) for s in range(a, b, step)]
              for k, (a, b) in enumerate(ranges)]
    for row in itertools.zip_longest(*chunks):
        for item in row:
            if item is not None:
                yield item


def gather(parts):
    """``{start: tensor}`` of per-chunk results on any devices -> one CPU
    tensor in start order (call it once every shard is launched: each
    device-to-host copy waits for its device)."""
    return torch.cat([parts[s].cpu() for s in sorted(parts)])
