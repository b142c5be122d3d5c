"""Meshes of devices for multi-device execution (counterpart of the JAX
package's ``parallel/mesh.py``).

The port shards what the JAX package shards: the leading axis of a batch
(frames in hashing, row tiles in the search) over every member of a mesh,
with the column side replicated. There is no ``shard_map``: the hasher and
the engine loop over the members, launch each member's slab under its
device and stream, and gather the results on the host. A mesh is a flat
list of members. JAX's 2-D ("dcn", "ici") mesh shards the leading axis
over both axes jointly, which partitions its devices in row-major order
just as the flat list of them is partitioned; and one process has no
slice index to lay out a second axis by.

A mesh may name one device more than once. Each member of a shared CUDA
device then has a ``torch.cuda.Stream`` of its own, so its slabs run
beside the other members' on that card (the counterpart of the JAX suite's
virtual CPU devices); a member alone on its device uses the device's
current stream. Members are all CPU or all CUDA: nothing moves to the CPU
on its own.
"""

from __future__ import annotations

import contextlib

import torch

from .._device import resolve_device

__all__ = ["Mesh", "build_mesh", "replicate", "resolve_mesh", "row_slabs"]


class Mesh:
    """An ordered tuple of device members; ``size`` is their number."""

    def __init__(self, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one member")
        types = {d.type for d in devs}
        if not types <= {"cpu", "cuda"}:
            raise ValueError(f"unsupported mesh devices {sorted(types)}")
        if len(types) > 1:
            raise ValueError("a mesh may not mix CPU and CUDA members")
        if any(d.type == "cuda" and d.index is None for d in devs):
            raise ValueError("name each CUDA member with its index, as cuda:0")
        self.devices = devs
        self.distinct_devices = tuple(dict.fromkeys(devs))
        self._streams: list | None = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def sharing(self, device: torch.device) -> int:
        """Members on ``device``."""
        return self.devices.count(device)

    def __repr__(self) -> str:
        return f"Mesh({', '.join(map(str, self.devices))})"

    def streams(self) -> list:
        """Each member's stream: its own on a shared CUDA device, else None
        (the device's current stream). Made at first use, so a mesh of CUDA
        devices can be described without touching one."""
        if self._streams is None:
            self._streams = [
                torch.cuda.Stream(device=d) if d.type == "cuda" and self.sharing(d) > 1 else None
                for d in self.devices
            ]
        return self._streams

    @contextlib.contextmanager
    def member(self, k: int):
        """Run the body on member k: its CUDA device current and, on a
        shared device, its own stream current, after that stream has waited
        for the device's current stream (where columns and flags were
        staged)."""
        dev = self.devices[k]
        if dev.type != "cuda":
            yield
            return
        stream = self.streams()[k]
        with torch.cuda.device(dev):
            if stream is None:
                yield
                return
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                yield


def resolve_mesh(device=None, mesh: Mesh | None = None) -> Mesh:
    """The mesh a hasher or an engine runs on: ``mesh``, or a mesh of the
    one device ``resolve_device(device)``; naming both is refused. Every
    device must be there: a CUDA member raises without CUDA."""
    if mesh is None:
        return Mesh([resolve_device(device)])
    if device is not None:
        raise ValueError("pass a device or a mesh, not both")
    for dev in mesh.distinct_devices:
        resolve_device(dev)
    return mesh


def build_mesh() -> Mesh:
    """Mesh over every visible CUDA device, one member each."""
    return Mesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())])


def row_slabs(n_rows: int, mesh: Mesh) -> list[tuple[int, int]]:
    """Each member's [start, stop) of a leading axis of n_rows: contiguous
    slabs of ceil(n_rows / size) rows in member order, the last ones
    shorter or empty. This is JAX's partition of the rows, padded to a
    multiple of the mesh size, over all of a mesh's axes jointly."""
    per = -(-n_rows // mesh.size)
    return [(min(k * per, n_rows), min((k + 1) * per, n_rows)) for k in range(mesh.size)]


def replicate(tensor: torch.Tensor, mesh: Mesh) -> dict[torch.device, torch.Tensor]:
    """One copy of ``tensor`` per distinct device of the mesh (the tensor
    itself on its own device); members that share a device share the copy.
    Each copy is recorded on the streams of the members that read it, so
    its memory is not reused before their work is done."""
    out = {d: tensor if tensor.device == d else tensor.to(d) for d in mesh.distinct_devices}
    if mesh.devices[0].type == "cuda":
        for dev, stream in zip(mesh.devices, mesh.streams()):
            if stream is not None:
                out[dev].record_stream(stream)
    return out
