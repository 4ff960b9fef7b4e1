"""Parallelism helpers (port of ``d3d_tpu.parallel``).

Ported so far: the Switch-MoE MLP (:mod:`.moe`). The mesh, multi-host and
pipeline helpers (``mesh.py``, ``distributed.py``, ``pipeline.py``) and
the MoE's expert sharding are still to port; the hooks that need them
raise ``NotImplementedError``.
"""

from .moe import init_moe_params, moe_mlp

__all__ = ["init_moe_params", "moe_mlp"]
