"""Data-, tensor- and expert-parallel strategies on ``torch.distributed``:
the mesh (:mod:`.mesh`), the ZeRO and expert placement rules and
collectives (:mod:`.sharding`) and tensor parallelism's rule and
collectives (:mod:`.tensor`)."""

from dlti_tpu_torch.parallel.mesh import Mesh, build_mesh, fit_parallel_to_devices

__all__ = ["Mesh", "build_mesh", "fit_parallel_to_devices"]
