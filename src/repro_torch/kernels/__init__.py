# Hand-written Hopper kernels, one package per TPU kernel of the
# reference: ref.py (plain PyTorch version, run for CPU tensors) and
# ops.py (the wrapper: CPU tensor -> plain version, CUDA tensor -> the
# kernel from ../csrc, built by _build.py, or raise).
