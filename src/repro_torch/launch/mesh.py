"""Production meshes — the port of ``repro/launch/mesh.py``.

A mesh is first a *layout*, a pure value: its axis names and sizes
(:class:`MeshLayout`).  The sharding rules (``launch/sharding.py``) read
only that.  :func:`build_mesh` turns a layout into a
``torch.distributed.device_mesh.DeviceMesh`` over the current process group
(ranks laid out row-major, as ``jax.make_mesh`` lays out devices), and
raises when the layout's size is not the world size.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Axis names and sizes, major to minor.  ``shape`` is the reference's
    ``mesh.shape`` ({axis name: size}), so a layout stands in for a JAX
    mesh wherever only ``shape`` and ``axis_names`` are read."""
    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} against {self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def as_layout(mesh) -> MeshLayout:
    """The layout of a :class:`MeshLayout` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshLayout):
        return mesh
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no layout")
    return MeshLayout(tuple(names), tuple(mesh.mesh.shape))


def production_layout(*, multi_pod: bool = False) -> MeshLayout:
    """Single pod: 16 x 16 = 256 ("data", "model").  Multi-pod: 2 x 16 x 16
    = 512 ("pod", "data", "model"); "pod" carries the cross-pod gradient
    reduction."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def pipeline_layout(*, multi_pod: bool = False,
                    num_stages: int = 4) -> MeshLayout:
    """The layout of the paper's pipelined train step: the model axis
    factored into ("stage", "model"), 16 = num_stages * tp."""
    if 16 % num_stages:
        raise ValueError(f"{num_stages} stages do not divide 16")
    tp = 16 // num_stages
    if multi_pod:
        return MeshLayout(("pod", "data", "stage", "model"),
                          (2, 16, num_stages, tp))
    return MeshLayout(("data", "stage", "model"), (16, num_stages, tp))


def build_mesh(layout: MeshLayout, device="cuda"):
    """A ``DeviceMesh`` of ``layout`` over the current (initialized) process
    group, on ``device``'s type (``"cuda"`` unless the caller passes
    ``"cpu"``); ranks fill the layout row-major."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialized process group")
    world = dist.get_world_size()
    if layout.size != world:
        raise ValueError(f"a {'x'.join(map(str, layout.sizes))} mesh needs "
                         f"{layout.size} ranks; the process group has "
                         f"{world}")
    ranks = torch.arange(world).reshape(layout.sizes)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=layout.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    return build_mesh(production_layout(multi_pod=multi_pod), device)


def make_pipeline_mesh(*, multi_pod: bool = False, num_stages: int = 4,
                       device="cuda"):
    return build_mesh(pipeline_layout(multi_pod=multi_pod,
                                      num_stages=num_stages), device)


def data_axes(mesh) -> tuple:
    """The batch-sharding axes of this mesh ("pod" folds into data)."""
    names = as_layout(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def mesh_tag(mesh) -> str:
    lay = as_layout(mesh)
    return "x".join(str(n) for n in lay.sizes)
