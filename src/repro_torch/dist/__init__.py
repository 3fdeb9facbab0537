"""Distribution substrate of the port (mirrors ``repro.dist``).

* :mod:`~repro_torch.dist.compress` — error-feedback int8 gradient
  compression, run inside the train step;
* :mod:`~repro_torch.dist.stragglers` — straggler detection, mesh
  replanning arithmetic and SIGTERM preemption handling (copied: the JAX
  package's module imports no JAX).

``sharding``, ``pipeline`` and ``elastic`` are ROADMAP queue A item 10.
"""
from . import compress, stragglers

__all__ = ["compress", "stragglers"]
