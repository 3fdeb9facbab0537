"""Model architecture: configs (copied from the JAX package), the dense
decoder's training forward and its decode steps, the conversion of
JAX-initialised weights both ways, and on-device sampling."""
