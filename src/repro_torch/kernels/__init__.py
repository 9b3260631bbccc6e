"""Hand-written CUDA kernels of the serving path, their plain PyTorch
versions (`ref`) and the explicit `impl` dispatch (`ops`). Importing this
package builds nothing: a kernel is compiled at its first launch."""

SMEM_PER_BLOCK = 232448   # bytes of shared memory a Hopper block can opt in to
