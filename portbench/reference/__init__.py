"""The benchmark's plain reference: a frozen copy of the s2v_torch port's
plain path (models, pipeline, GAN trainer), with K1-K3 replaced by their
plain PyTorch versions (``ops/kernels``). It imports neither the port nor
JAX; ``PROVENANCE.md`` lists each file's origin and every edit."""
