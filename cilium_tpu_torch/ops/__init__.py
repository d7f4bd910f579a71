"""Device-side functions, each on a hand-written CUDA kernel
(csrc/*.cu) with a plain PyTorch version for CPU tensors."""
