"""Device-mesh construction (counterpart of
deeplearning4j_tpu/parallel/mesh.py).

Axis convention (the JAX package's standard mesh axes; every parallel
component names these):

- ``dp``: data parallel — batch dim sharded, params replicated. Consumed
  by ParallelWrapper, TrainingMaster and sharding.shard_batch.
- ``tp``: tensor parallel — weight matrices sharded by the shape rule of
  sharding.param_shardings, gathered on use (parallel/tensor_parallel.py).
- ``sp``: sequence/context parallel — time dim sharded; consumed by
  parallel.ring_attention.ring_self_attention (K/V blocks rotate around
  the sp ring, one `collectives.ppermute` hop per step).
- ``pp``, ``ep``: reserved axis names (pipeline / expert parallel) so
  components agree on naming; nothing consumes them, and their ranks
  replicate the work of their coordinate set.

One process per rank drives one device, so a mesh spans the live process
group: the axes' sizes multiply to the world size, ``tp`` varies fastest
and ``dp`` slowest (rank = ((((dp*pp + pp_i)*sp + sp_i)*ep + ep_i)*tp +
tp_i), the JAX package's device order). `make_mesh` creates the axis
groups (collectives.axis_groups) and returns a `Mesh` whose `shape` maps
every axis to its size, as `jax.sharding.Mesh.shape` does, with this
rank's `coords` and `group(axis)`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from deeplearning4j_tpu_torch.parallel import collectives

AXES = collectives.AXES


@dataclass
class MeshSpec:
    """Declarative mesh shape. Unspecified axes default to 1.

    tp is the minor (fastest-varying) axis; dp is major."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    def total(self) -> int:
        return self.dp * self.pp * self.sp * self.ep * self.tp

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXES}


@dataclass(frozen=True)
class Mesh:
    """The live mesh: `shape` {axis: size}, the process group's `world`,
    this process's `rank` and its `coords` {axis: coordinate}, and the
    `devices` this process drives (one)."""

    shape: Dict[str, int]
    world: int
    rank: int
    devices: tuple = ()
    coords: Dict[str, int] = field(default_factory=dict)
    groups: Dict[str, collectives.AxisGroup] = field(
        default_factory=dict, compare=False, repr=False)

    def group(self, axis: str = "dp") -> collectives.AxisGroup:
        """The AxisGroup of `axis` (this rank's coordinate set). A mesh
        built without groups (by hand, in one process) has the world's dp
        axis and axes of size 1."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis '{axis}' "
                             f"(axes: {dict(self.shape)})")
        g = self.groups.get(axis)
        if g is not None:
            return g
        if axis == "dp":
            return collectives.dp_group()
        return collectives.AxisGroup(1, 0, collectives.backend(),
                                     (collectives.rank(),), None, axis)

    @property
    def dp_coord(self) -> int:
        """This rank's coordinate along dp: which share of the global
        batch it feeds and which slice of ZeRO-1 state it keeps (a mesh
        built without coords spans the world's dp axis: the rank)."""
        return int(self.coords.get("dp", self.rank))


def mesh_sizes(sizes: Dict[str, int], n: int) -> Dict[str, int]:
    """The JAX package's axis arithmetic over `n` processes: at most one
    axis of -1, which absorbs what the fixed axes leave (ValueError when
    they do not divide n); ValueError when the mesh needs more than n.
    Returns the sizes of every axis."""
    sizes = dict(sizes)
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if wild:
        fixed = 1
        for s in sizes.values():
            if s != -1:
                fixed *= s
        if n % fixed:
            raise ValueError(
                f"{n} processes not divisible by fixed axes {fixed}")
        sizes[wild[0]] = n // fixed
    total = 1
    for s in sizes.values():
        total *= s
    if total > n:
        raise ValueError(
            f"mesh needs {total} processes, only {n} available (the live "
            f"process group has {n}; one device per process: call "
            "TrainingMaster.initialize_distributed first)")
    return sizes


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence] = None,
              **axis_sizes) -> Mesh:
    """The mesh over the live process group: make_mesh(dp=2, tp=2) over
    four ranks -> a Mesh with shape {"dp": 2, "pp": 1, "sp": 1, "ep": 1,
    "tp": 2}. An axis of -1 absorbs the world. The axes' product must be
    the world size: too many is JAX's ValueError, too few is one too (a
    rank outside the mesh would have no place in it). `devices`
    (optional) names the one device this process drives."""
    if spec is None:
        spec = MeshSpec(**{a: axis_sizes.get(a, 1) for a in AXES})
    world = collectives.world_size()
    sizes = mesh_sizes(spec.axis_sizes(), world)
    total = 1
    for s in sizes.values():
        total *= s
    if total != world:
        raise ValueError(
            f"mesh covers {total} processes, the live process group has "
            f"{world} (one device per process: the axes' sizes multiply "
            "to the world size)")
    devs = tuple(devices) if devices is not None else ()
    if len(devs) > 1:
        raise ValueError("the port drives one device per process; got "
                         f"{len(devs)} devices")
    groups = collectives.axis_groups([sizes[a] for a in AXES])
    coords = {a: groups[a].rank for a in AXES}
    return Mesh(sizes, world, collectives.rank(), devs, coords, groups)


__all__ = ["AXES", "Mesh", "MeshSpec", "make_mesh", "mesh_sizes"]
