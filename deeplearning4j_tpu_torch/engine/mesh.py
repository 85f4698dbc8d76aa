"""MeshManager: the live dp mesh the ZeRO-1 step runs over (counterpart of
deeplearning4j_tpu/engine/mesh.py).

The engine's view of "where am I running": a MeshManager derives the one
``dp`` axis from the LIVE process group (parallel/collectives.py: one
process per rank, one device per process, so dp is the world size) and
owns every placement decision the ZeRO-1 subsystem (engine/sharding.py)
makes against it:

  - policy: optimizer-state leaves shard their leading dim over ``dp``
    when divisible (`zero1_leaf_sharded`), everything else replicates;
  - staging: `shard_tree` keeps this rank's contiguous rows of each
    sharded leaf (`slice_bounds`, the convention the checkpoint slices
    use) and records the tree's layout; `replicate_tree` keeps every leaf
    whole. A rank holds only its slices, which carry no global shape, so
    `gather_tree` / `reshard_tree` / `memory_facts` read the layout the
    last `shard_tree` recorded (or one passed in);
  - elasticity: `refresh()` re-derives when the live world changed, and
    `reshard_tree` gathers and re-slices state for the current world;
  - telemetry: `dl4j_mesh_world_size` (gauge, set at every derive),
    `dl4j_mesh_reshard_total` (counter, one per state reshard) and
    `dl4j_mesh_allgather_seconds` (observed around every gather of
    sharded state to the host — the checkpoint save's gather).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.engine.sharding import (
    ZERO1_AXIS,
    slice_bounds,
    zero1_leaf_sharded,
)
from deeplearning4j_tpu_torch.observability import metrics as _obs
from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.sharding import Sharding
from deeplearning4j_tpu_torch.util.tree import leaves, tree_map, unflatten


class MeshManager:
    """The live 1-axis dp mesh and the ZeRO-1 placement policy over it.

    `mesh` (a parallel.mesh.Mesh or MeshSpec) pins the mesh; None derives
    it from the live process group and re-derives on `refresh()`."""

    def __init__(self, devices=None, mesh=None):
        from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh

        if isinstance(mesh, MeshSpec):
            mesh = make_mesh(mesh)
        self._explicit_mesh = mesh
        self._devices = None if devices is None else list(devices)
        self.mesh = None
        self.reshards = 0
        self.layout: Optional[List[bool]] = None
        self._world: dict = {}
        self.derive()

    # ------------------------------------------------------- derivation
    def derive(self) -> "MeshManager":
        """(Re)build the mesh from the live process group; the world
        signature (processes, devices, dp) is what `refresh()` compares
        and what checkpoints record."""
        from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

        self.mesh = (self._explicit_mesh if self._explicit_mesh is not None
                     else make_mesh(dp=-1, devices=self._devices))
        if self.mesh.shape.get("tp", 1) != 1:
            raise NotImplementedError(
                "sharding='zero1' requires tp == 1 (the ZeRO update shards "
                "the dp axis of replicated params)")
        extra = {a: n for a, n in self.mesh.shape.items()
                 if a != ZERO1_AXIS and n != 1}
        if extra:
            raise NotImplementedError(
                f"the ZeRO-1 step shards over a dp-only mesh (axes {extra}): "
                "its collectives span the whole world")
        w = collectives.world_size()
        self._world = {"processes": w, "devices": w,
                       "dp": int(self.mesh.shape.get(ZERO1_AXIS, 1))}
        _obs.set_gauge("dl4j_mesh_world_size", self._world["processes"])
        return self

    @property
    def dp(self) -> int:
        return self._world["dp"]

    @property
    def rank(self) -> int:
        """This rank's dp coordinate (the slice of the state it keeps)."""
        return self.mesh.coords.get(ZERO1_AXIS, collectives.rank())

    @property
    def group(self) -> collectives.AxisGroup:
        return self.mesh.group(ZERO1_AXIS)

    def world_signature(self) -> dict:
        return dict(self._world)

    def cache_token(self) -> tuple:
        """Hashable identity of the derived mesh for program cache keys:
        a different world must build a fresh program."""
        return (self._world["processes"], self._world["devices"],
                self._world["dp"])

    def refresh(self) -> bool:
        """Re-derive if the live world changed. True when the mesh was
        rebuilt — callers then `reshard_tree` the state placed on it."""
        if self._explicit_mesh is not None:
            return False
        if collectives.world_size() == self._world["processes"]:
            return False
        before = self.cache_token()
        self.derive()
        return self.cache_token() != before

    # ---------------------------------------------------------- policy
    def replicated(self) -> Sharding:
        return Sharding(self.mesh, ())

    def leaf_spec(self, leaf) -> tuple:
        """The ZeRO-1 rule for one leaf: leading dim over dp when
        divisible, else replicated (a PartitionSpec's tuple)."""
        if zero1_leaf_sharded(tuple(getattr(leaf, "shape", ())), self.dp):
            return (ZERO1_AXIS,)
        return ()

    def leaf_sharding(self, leaf) -> Sharding:
        return Sharding(self.mesh, self.leaf_spec(leaf))

    def batch_sharding(self) -> Sharding:
        return Sharding(self.mesh, (ZERO1_AXIS,))

    def shard_layout(self, tree) -> List[bool]:
        """[bool] per leaf (util.tree order) of a FULL tree: sharded under
        the current dp? The checkpoint writer records exactly this."""
        return [zero1_leaf_sharded(tuple(np.shape(a)), self.dp)
                for a in leaves(tree)]

    # --------------------------------------------------------- staging
    def shard_tree(self, tree, device=None) -> Any:
        """This rank's placement of a FULL tree (numpy or tensors): each
        sharded leaf cut to this rank's rows, the rest whole, as tensors
        on `device` (default: where each tensor lies; numpy goes to the
        CPU). Records the layout for `gather_tree`."""
        self.layout = self.shard_layout(tree)
        it = iter(self.layout)

        def put(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.array(a))
            if device is not None:
                t = t.to(device)
            if next(it):
                lo, hi = slice_bounds(t.shape[0], self.rank, self.dp)
                t = t[lo:hi]
            return t.clone()

        return tree_map(put, tree)

    def replicate_tree(self, tree, device=None) -> Any:
        """Every leaf whole, as tensors on `device` (replicated params are
        the same tensors on every rank)."""
        def put(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.array(a))
            return (t if device is None else t.to(device)).clone()

        return tree_map(put, tree)

    def gather_tree(self, tree, layout: Optional[List[bool]] = None) -> Any:
        """Host tree of FULL numpy arrays: each sharded leaf's slices
        all-gathered over the group (one collective for all of them),
        the rest copied. Timed into `dl4j_mesh_allgather_seconds`."""
        layout = self.layout if layout is None else layout
        ls = leaves(tree)
        if layout is None or len(layout) != len(ls):
            raise ValueError("gather_tree needs the layout of the tree it "
                             "gathers (shard_tree records it)")
        t0 = time.perf_counter()
        out = [None if t is None else t.detach() for t in ls]
        idx = [i for i, s in enumerate(layout) if s]
        if idx:
            w = self.dp
            full = collectives.all_gather(torch.cat(
                [ls[i].detach().reshape(-1) for i in idx])).view(w, -1)
            for i, p in zip(idx, torch.split(
                    full, [ls[i].numel() for i in idx], dim=1)):
                out[i] = p.reshape((ls[i].shape[0] * w,)
                                   + tuple(ls[i].shape[1:]))
        host = [t.cpu().numpy().copy() for t in out]
        _obs.observe("dl4j_mesh_allgather_seconds", time.perf_counter() - t0)
        return unflatten(tree, host)[0]

    def reshard_tree(self, tree, layout: Optional[List[bool]] = None,
                     device=None) -> Any:
        """Gather `tree` (placed under `layout`) and re-slice it for the
        CURRENT world — the in-memory half of an elastic reshard. Counts
        `dl4j_mesh_reshard_total`."""
        self.reshards += 1
        _obs.count("dl4j_mesh_reshard_total")
        return self.shard_tree(self.gather_tree(tree, layout), device=device)

    # ------------------------------------------------------------ facts
    def memory_facts(self, tree, layout: Optional[List[bool]] = None) -> dict:
        """This rank's optimizer-state memory under the placement: full
        bytes, this-rank bytes and their ratio — the measurable 1/n
        claim. `tree` holds this rank's leaves (slices where sharded)."""
        layout = self.layout if layout is None else layout
        ls = leaves(tree)
        layout = layout if layout is not None else [False] * len(ls)
        full = local = 0
        for t, sharded in zip(ls, layout):
            size = int(t.numel()) * t.element_size()
            local += size
            full += size * (self.dp if sharded else 1)
        return {"full_bytes": full, "replica_bytes": local,
                "replica_fraction": (local / full) if full else 1.0,
                "dp": self.dp}


__all__ = ["MeshManager"]
