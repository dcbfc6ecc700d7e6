"""Multi-card plumbing of the port.  One card for now: the JAX package's
meshes (``vidgraph_tpu/parallel/``) are ROADMAP slice 9."""
