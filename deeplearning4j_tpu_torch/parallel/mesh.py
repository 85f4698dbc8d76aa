"""Device-mesh construction (counterpart of
deeplearning4j_tpu/parallel/mesh.py).

Axis convention (the JAX package's standard mesh axes; every parallel
component names these):

- ``dp``: data parallel — batch dim sharded, params replicated. In the
  port one process per rank drives one device, so ``dp`` is the size of
  the live process group (parallel/collectives.py).
- ``tp``, ``sp``: tensor and sequence parallelism; ``pp``, ``ep``: the
  reserved pipeline/expert names. None is ported yet: a size above 1
  raises NotImplementedError naming ROADMAP queue 9c.

`make_mesh(dp=4)` returns a `Mesh` whose `shape` maps every axis to its
size, as the JAX package's `jax.sharding.Mesh.shape` does; an axis of
-1 absorbs the world.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

from deeplearning4j_tpu_torch.parallel import collectives

AXES = ("dp", "pp", "sp", "ep", "tp")


@dataclass
class MeshSpec:
    """Declarative mesh shape. Unspecified axes default to 1."""

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
    """The live dp mesh: `shape` {axis: size}, the process group's
    `world` and this process's `rank`, and the `devices` this process
    drives (one)."""

    shape: Dict[str, int]
    world: int
    rank: int
    devices: tuple = ()

    @property
    def group(self) -> collectives.DPGroup:
        return collectives.dp_group()


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence] = None,
              **axis_sizes) -> Mesh:
    """The mesh over the live process group: make_mesh(dp=2) -> a Mesh
    with shape {"dp": 2, "pp": 1, "sp": 1, "ep": 1, "tp": 1}. `dp` must
    be the world size (or -1, which absorbs it). `devices` (optional)
    names the one device this process drives."""
    if spec is None:
        spec = MeshSpec(**{a: axis_sizes.get(a, 1) for a in AXES})
    sizes = spec.axis_sizes()
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one mesh axis may be -1")
    world = collectives.world_size()
    for a in AXES[1:]:
        if sizes[a] > 1 or (a in wild):
            raise NotImplementedError(
                f"mesh axis {a}={sizes[a]} is not ported yet (ROADMAP queue "
                "9c: tensor and sequence parallelism); the port's mesh has "
                "one dp axis over the process group")
    if wild:
        sizes["dp"] = world
    if sizes["dp"] != world:
        raise ValueError(
            f"mesh needs dp={sizes['dp']} processes, the live process "
            f"group has {world} (one device per process: dp is the world "
            "size; call TrainingMaster.initialize_distributed first)")
    devs = tuple(devices) if devices is not None else ()
    if len(devs) > 1:
        raise ValueError("the port drives one device per process; got "
                         f"{len(devs)} devices")
    return Mesh(sizes, world, collectives.rank(), devs)


__all__ = ["AXES", "Mesh", "MeshSpec", "make_mesh"]
