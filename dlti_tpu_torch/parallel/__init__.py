"""Data-parallel strategies on ``torch.distributed``: the mesh
(:mod:`.mesh`) and the ZeRO placement rules and collectives
(:mod:`.sharding`)."""

from dlti_tpu_torch.parallel.mesh import Mesh, build_mesh, fit_parallel_to_devices

__all__ = ["Mesh", "build_mesh", "fit_parallel_to_devices"]
