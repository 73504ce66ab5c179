"""The one-process part of ``paddle_tpu/distributed/comm.py``: the
job-wide hybrid mesh that bench.py's ``_gpt_medium`` declares.

``init_hybrid_mesh(dp=1, mp=1, pp=1, sp=1)`` records a mesh of one
device and ``hybrid_mesh()`` returns it (None before). A degree above 1
on any axis raises ``NotImplementedError``: meshes over several cards,
and the collectives over them, are a later slice of the port.
``get_world_size()`` and ``get_rank()`` give the one-process world (1 and
0); a launch of several trainers (``PADDLE_TRAINERS_NUM`` > 1) raises.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

__all__ = ["HybridMesh", "init_hybrid_mesh", "hybrid_mesh",
           "get_world_size", "get_rank"]


class HybridMesh:
    """The axes of the job's mesh and their degrees (all 1 here)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = 1

    def __repr__(self):
        return f"HybridMesh({self.shape})"


_mesh: Optional[HybridMesh] = None


def init_hybrid_mesh(dp: int = 1, mp: int = 1, pp: int = 1, sp: int = 1,
                     dp_inner: int = 1) -> HybridMesh:
    """Declare the job's mesh (the JAX package's axis order: dp, pp, sp,
    mp). Only the one-device mesh is ported."""
    global _mesh
    degrees = dict(dp=dp, pp=pp, sp=sp, mp=mp)
    if any(int(v) != 1 for v in degrees.values()) or int(dp_inner) != 1:
        raise NotImplementedError(
            f"init_hybrid_mesh({degrees}, dp_inner={dp_inner}): the port "
            "runs one device so far; meshes over several cards are a later "
            "slice")
    _mesh = HybridMesh(degrees)
    return _mesh


def hybrid_mesh() -> Optional[HybridMesh]:
    return _mesh


def get_world_size() -> int:
    """The number of trainer processes: 1. ``PADDLE_TRAINERS_NUM`` above 1
    raises: several trainers are a later slice of the port."""
    n = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if n > 1:
        raise NotImplementedError(
            f"PADDLE_TRAINERS_NUM={n}: the port runs one trainer so far; "
            "several ranks are ROADMAP queue A item 7 (distributed)")
    return 1


def get_rank() -> int:
    """This trainer's rank: 0 (see ``get_world_size``)."""
    get_world_size()
    return 0
