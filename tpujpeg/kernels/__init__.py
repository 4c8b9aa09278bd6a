"""The device compute path (SURVEY.md §1 L2/L3 successors): the
wavefront entropy kernels (Pallas on the Triton route, compiled on the
GPU, interpret mode on the CPU so config 1 stays CPU-runnable,
BASELINE.json:7), the plain XLA wavefront, and the batched jnp transform
the fused chains end in. The jnp reference in tpujpeg/transform.py
remains the test oracle."""
