"""Model architecture: configs (copied from the JAX package), the dense
decoder's paged decode step, the conversion of JAX-initialised weights,
and on-device sampling."""
