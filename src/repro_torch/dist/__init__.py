"""Distribution substrate of the port (mirrors ``repro.dist``).

* :mod:`~repro_torch.dist.sharding` — the JAX package's partition-spec
  rules for params, batches and caches, over the port's ``Mesh`` of
  logical chips on one device, ``PartitionSpec`` and ``NamedSharding``;
* :mod:`~repro_torch.dist.compress` — error-feedback int8 gradient
  compression, run inside the train step;
* :mod:`~repro_torch.dist.stragglers` — straggler detection, mesh
  replanning arithmetic and SIGTERM preemption handling (copied: the JAX
  package's module imports no JAX);
* :mod:`~repro_torch.dist.pipeline` — GPipe-style pipeline parallelism
  over the layers, every stage on the mesh's one device;
* :mod:`~repro_torch.dist.elastic` — deterministic seeded training fault
  injection, consumed by :class:`repro_torch.train.elastic.ElasticTrainer`
  at step boundaries (copied; it imports neither JAX nor torch).
"""
from . import compress, elastic, pipeline, sharding, stragglers

__all__ = ["compress", "elastic", "pipeline", "sharding", "stragglers"]
