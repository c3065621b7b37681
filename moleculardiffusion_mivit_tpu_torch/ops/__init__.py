"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions;
plain batched image filters, convex hulls and curve fits."""
