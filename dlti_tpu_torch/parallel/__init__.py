"""The six mesh axes on ``torch.distributed``: the mesh (:mod:`.mesh`), the
ZeRO and expert placement rules and collectives (:mod:`.sharding`), tensor
parallelism's rule and collectives and the neighbour permute
(:mod:`.tensor`), ring attention (:mod:`.ring_attention`) and the GPipe
schedule (:mod:`.pipeline`)."""

from dlti_tpu_torch.parallel.mesh import Mesh, build_mesh, fit_parallel_to_devices

__all__ = ["Mesh", "build_mesh", "fit_parallel_to_devices"]
